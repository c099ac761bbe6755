"""Training (``train/`` of the JAX package): the optimizer, the train
state with f32 master weights, the contrastive and classifier train /
eval steps, the epoch loop (``Fitter``), checkpoints, early stopping,
the metrics writer and the evaluation metrics, the per-rank step
(``shard_step``); ``drivers.train_multi``,
``train_image`` and ``train_profile`` wire them to a card and a
dataset."""

from .checkpoint import CheckpointManager, load_from_checkpoint
from .early_stopping import EarlyStopping
from .logging import MetricsWriter
from .loop import Fitter, make_classifier_steps, make_multi_steps
from .optim import make_optimizer
from .shard_step import make_multi_steps_shard_map
from .state import TrainState, create_train_state

__all__ = ["make_multi_steps", "make_classifier_steps",
           "make_multi_steps_shard_map", "make_optimizer", "TrainState",
           "create_train_state", "Fitter", "CheckpointManager",
           "load_from_checkpoint", "EarlyStopping", "MetricsWriter"]
