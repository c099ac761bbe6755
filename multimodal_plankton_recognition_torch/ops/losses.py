"""Coordination losses and their helpers (``ops/losses.py`` of the JAX
package): the CLIP family. The learnable scalars live in the model's
``CoordinationHead`` and are passed in.

These are the unfused path (``coordination_args: {fused: false}``) and the
oracle of ``ops.contrastive``. Dtypes follow JAX's promotion: the
similarities are computed in the embedding dtype and promoted with the f32
``logit_scale``, so a bf16 model takes its softmax in f32. The other
coordination methods are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``torch.nn.functional.normalize`` semantics (norm clamped below at
    eps), in ``x``'s dtype."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def _softmax_xent(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (..., N, N) logits against diagonal targets,
    per leading index."""
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.diagonal(logprobs, dim1=-2, dim2=-1).mean(-1)


def clip_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
              logit_scale: torch.Tensor, buckets: int = 1) -> torch.Tensor:
    """Bucketed symmetric InfoNCE: per bucket, normalise both embeddings,
    logits = (I @ Pᵀ) * exp(scale), symmetric cross-entropy against the
    diagonal, averaged over buckets."""
    b, d = image_emb.shape
    if b % buckets:
        raise ValueError(f"batch {b} is not divisible by buckets={buckets}")
    i = l2_normalize(image_emb).reshape(buckets, b // buckets, d)
    p = l2_normalize(profile_emb).reshape(buckets, b // buckets, d)
    sim = i @ p.transpose(1, 2)
    sim = sim.to(torch.promote_types(sim.dtype, logit_scale.dtype))
    logits = sim * torch.exp(logit_scale)
    loss_rows = _softmax_xent(logits).mean()
    loss_cols = _softmax_xent(logits.transpose(1, 2)).mean()
    return (loss_rows + loss_cols) / 2


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def clipplus_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                  logit_scale: torch.Tensor, buckets: int = 1,
                  beta: float = 0.25) -> torch.Tensor:
    """CLIP + beta * MSE embedding coupling."""
    return clip_loss(image_emb, profile_emb, logit_scale, buckets) \
        + beta * mse_loss(image_emb, profile_emb)
