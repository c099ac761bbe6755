"""TensorBoard metric writer (``train/logging.py`` of the JAX package,
which is framework-free: copied as it is).

Reproduces the reference's logging contract (tag names ``train_loss``,
``valid_loss``, ``valid_acc``, ``test_cm``; one point per epoch with
``step=current_epoch``; reference: src/model.py:104-133, 265-286) using
tensorboardX, plus a JSONL mirror for machine-readable history.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    def __init__(self, logdir: Path | str, name: str = "",
                 version: Optional[int] = None) -> None:
        base = Path(logdir) / name if name else Path(logdir)
        if version is None:
            version = 0
            while (base / f"version_{version}").exists():
                version += 1
        self.logdir = base / f"version_{version}"
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(str(self.logdir))
        except Exception:
            pass
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step}
        for k, v in metrics.items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                record[k] = float(v)
                if self._tb is not None:
                    self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_image(self, tag: str, image_chw: np.ndarray, step: int = 0) -> None:
        """Log an image tensor (C, H, W) uint8 — used for the test-set
        confusion matrix (reference: src/model.py:283)."""
        if self._tb is not None:
            self._tb.add_image(tag, image_chw, global_step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
