"""The per-rank train step for BatchNorm-free models
(``train/shard_step.py`` of the JAX package).

JAX's default multi-chip step lets GSPMD partition the program, and a
``pallas_call`` has no partitioning rule, so that path gives up its
kernels; its ``shard_map`` step instead runs on each chip the same
per-chip program the one-chip path compiles and places the collectives
by hand. In the port every rank already runs its own program on its own
rows, so both modes keep the kernels (attention 1-2 and the bucketed
loss kernels 5-8) on every rank; what this step changes is the loss:

* ``negatives: global``: ``parallel.contrastive``'s losses, this rank's
  rows against every rank's gathered rows of the other modality
  (``reduce=False``), in f32, plus ``beta`` · MSE for the ``plus``
  methods;
* bucketed negatives: this rank's ``buckets / n_data`` whole buckets,
  which needs ``buckets % n_data == 0`` (raises otherwise: the driver
  then prints JAX's line and takes the GSPMD step).

The gradients are averaged over the ranks (``train.loop``), which gives
the global loss's gradient, and the draws fold in the data rank, as JAX's
``fold_in(axis_index)``. A model with BatchNorm raises JAX's error: its
per-rank statistics would not be the GSPMD path's synchronised ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.batchnorm import BatchNorm
from ..ops import losses
from ..parallel.contrastive import global_clip_loss, global_siglip_loss
from ..parallel.mesh import Mesh
from .loop import multi_steps
from .optim import Optimizer

_GLOBAL_METHODS = ("clip", "clipplus", "siglip", "siglipplus")
BATCHNORM_REFUSAL = (
    "parallel: shard_map requires a BatchNorm-free model (per-chip BN "
    "statistics would diverge from GSPMD's sync-BN); use the default "
    "parallel: gspmd")


def has_batchnorm(model: nn.Module) -> bool:
    return any(isinstance(m, BatchNorm) for m in model.modules())


def make_multi_steps_shard_map(model: nn.Module, tx: Optimizer, mesh: Mesh,
                               buckets: int = 1,
                               negatives: str = "bucketed",
                               augment_fn: Optional[Callable] = None
                               ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) of the per-rank program, signature as
    ``train.loop.make_multi_steps`` plus the mesh and ``negatives``."""
    if has_batchnorm(model):
        raise ValueError(BATCHNORM_REFUSAL)
    n_data = mesh.n_data
    head = model.coordination
    method = head.method
    if negatives == "global":
        if method not in _GLOBAL_METHODS:
            raise ValueError(
                f"negatives: global supports methods {_GLOBAL_METHODS}, "
                f"got {method!r}")
    elif buckets % n_data != 0:
        raise ValueError(
            f"parallel: shard_map with bucketed negatives needs buckets "
            f"({buckets}) divisible by the data-axis size ({n_data}) so "
            f"bucket groups stay chip-local; use the GSPMD path or "
            f"negatives: global otherwise")

    def loss_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if negatives != "global":
            return model.loss(buckets=buckets // n_data, **batch)
        batch = {k: v for k, v in batch.items() if k != "label"}
        emb = model.encode(**batch)
        i = emb["image_emb"].float()
        p = emb["profile_emb"].float()
        if method in ("clip", "clipplus"):
            loss = global_clip_loss(i, p, head.logit_scale, mesh,
                                    reduce=False)
        else:
            loss = global_siglip_loss(i, p, head.logit_scale,
                                      head.logit_bias, mesh, reduce=False)
        if method.endswith("plus"):
            loss = loss + head.beta * losses.mse_loss(i, p)
        return loss

    return multi_steps(model, tx, loss_of, augment_fn, mesh)
