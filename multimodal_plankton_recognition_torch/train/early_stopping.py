"""Early stopping on a monitored metric (``train/early_stopping.py`` of
the JAX package, which is framework-free: copied as it is).

Matches the reference's Lightning configuration
(reference: scripts/train_multi.py:95-97): ``min_delta=0.0``, configurable
patience, ``check_finite=False`` (NaN/inf metric values do NOT abort
training — they simply never improve the best value).
"""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, monitor: str = "valid_loss", mode: str = "min",
                 patience: int = 20, min_delta: float = 0.0) -> None:
        assert mode in ("min", "max")
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0

    def update(self, value: float) -> bool:
        """Record an epoch value; returns True when training should stop."""
        if not math.isfinite(value):
            improved = False  # check_finite=False: tolerate, never improve
        elif self.mode == "min":
            improved = value < self.best - self.min_delta
        else:
            improved = value > self.best + self.min_delta
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        # Lightning stops when wait_count >= patience
        return self.bad_epochs >= self.patience
