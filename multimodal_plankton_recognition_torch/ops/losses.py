"""Losses and their helpers (``ops/losses.py`` of the JAX package).

Only ``l2_normalize`` is ported so far: the serving path needs it. The
coordination losses come with training (ROADMAP.md).
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``torch.nn.functional.normalize`` semantics (norm clamped below at
    eps), in ``x``'s dtype."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
