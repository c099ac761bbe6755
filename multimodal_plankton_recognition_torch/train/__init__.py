"""Contrastive training (``train/`` of the JAX package): the optimizer, the
train state with f32 master weights, and the train / eval steps."""

from .loop import make_multi_steps
from .optim import make_optimizer
from .state import TrainState, create_train_state

__all__ = ["make_multi_steps", "make_optimizer", "TrainState",
           "create_train_state"]
