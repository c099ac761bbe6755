"""Optimizer construction (``train/optim.py`` of the JAX package).

The JAX package reproduces ``torch.optim.SGD(lr, momentum, weight_decay,
nesterov)`` with the optax chain ``add_decayed_weights(wd)`` then
``sgd(momentum, nesterov)``:

  g <- g + wd * p;  b <- mu * b + g;  step = g + mu * b (nesterov)

so the port uses ``torch.optim.SGD`` itself. Gradient accumulation
(``accumulate_grad_batches`` > 1) has ``optax.MultiSteps`` semantics: the
running mean of k micro-step gradients makes one update, applied by the
train step (``train/loop.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from ..config import OptimConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` returns: ``init`` builds the torch optimizer
    over the f32 master weights (optax's ``tx.init``); ``every_k``
    micro-steps make one update."""

    cfg: OptimConfig
    every_k: int = 1

    def init(self, params: Iterable[torch.Tensor]) -> torch.optim.SGD:
        cfg = self.cfg
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay,
                               nesterov=cfg.nesterov and cfg.momentum > 0)


def make_optimizer(cfg: OptimConfig,
                   accumulate_grad_batches: int = 1) -> Optimizer:
    if accumulate_grad_batches < 1:
        raise ValueError(f"accumulate_grad_batches must be >= 1, got "
                         f"{accumulate_grad_batches}")
    return Optimizer(cfg, accumulate_grad_batches)
