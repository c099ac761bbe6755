"""Contrastive training (``train/`` of the JAX package): the optimizer, the
train state with f32 master weights, the train / eval steps, the epoch
loop (``Fitter``), early stopping and the metrics writer."""

from .early_stopping import EarlyStopping
from .logging import MetricsWriter
from .loop import Fitter, make_multi_steps
from .optim import make_optimizer
from .state import TrainState, create_train_state

__all__ = ["make_multi_steps", "make_optimizer", "TrainState",
           "create_train_state", "Fitter", "EarlyStopping", "MetricsWriter"]
