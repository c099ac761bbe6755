"""Configuration dataclasses the port needs (``config.py`` of the JAX
package, which needs yaml for the model cards; the card's machine has
none). Same fields and defaults; the card loader comes with the drivers
(ROADMAP.md)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OptimConfig:
    """SGD hyperparameters (the reference trains with ``torch.optim.SGD``)."""

    lr: float = 5e-3
    momentum: float = 0.9
    weight_decay: float = 1e-3
    nesterov: bool = True
