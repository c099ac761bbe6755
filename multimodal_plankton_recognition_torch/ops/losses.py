"""Coordination losses and their helpers (``ops/losses.py`` of the JAX
package): every coordination method of the model cards, plus the
classifiers' cross-entropy. The learnable scalars (``logit_scale``,
``logit_bias``, the ArcFace class weights) live in the model's
``CoordinationHead`` and are passed in.

These are the unfused path (``coordination_args: {fused: false}``) and the
oracle of ``ops.contrastive``. Dtypes follow JAX's promotion: the
similarities are computed in the embedding dtype and promoted with the f32
scalars, so a bf16 model takes its softmax and sigmoid in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def _similarities(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                  buckets: int, like: torch.Tensor) -> torch.Tensor:
    """(buckets, N, N) cosine similarities of the normalised embeddings,
    promoted with ``like``'s dtype."""
    b, d = image_emb.shape
    if b % buckets:
        raise ValueError(f"batch {b} is not divisible by buckets={buckets}")
    i = l2_normalize(image_emb).reshape(buckets, b // buckets, d)
    p = l2_normalize(profile_emb).reshape(buckets, b // buckets, d)
    sim = i @ p.transpose(1, 2)
    return sim.to(torch.promote_types(sim.dtype, like.dtype))


def clip_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
              logit_scale: torch.Tensor, buckets: int = 1) -> torch.Tensor:
    """Bucketed symmetric InfoNCE: per bucket, normalise both embeddings,
    logits = (I @ Pᵀ) * exp(scale), symmetric cross-entropy against the
    diagonal, averaged over buckets."""
    sim = _similarities(image_emb, profile_emb, buckets, logit_scale)
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


def siglip_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                buckets: int = 1) -> torch.Tensor:
    """Bucketed pairwise sigmoid loss: logits = sim * exp(scale) + bias,
    labels +1 on the diagonal and -1 off it, loss = -Σ log σ(labels *
    logits) / N per bucket, mean over buckets. ``-log σ(x)`` is
    ``logaddexp(0, -x)``, as ``jax.nn.log_sigmoid`` computes it."""
    sim = _similarities(image_emb, profile_emb, buckets, logit_scale)
    logits = sim * torch.exp(logit_scale) + logit_bias
    n = logits.shape[-1]
    labels = 2.0 * torch.eye(n, dtype=logits.dtype,
                             device=logits.device) - 1.0
    x = labels * logits
    loss = torch.logaddexp(torch.zeros_like(x), -x).sum(dim=(1, 2)) / n
    return loss.mean()


def siglipplus_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                    logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                    buckets: int = 1, beta: float = 0.25) -> torch.Tensor:
    return siglip_loss(image_emb, profile_emb, logit_scale, logit_bias,
                       buckets) + beta * mse_loss(image_emb, profile_emb)


def rank_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
              margin: float = 0.25, buckets: int = 1) -> torch.Tensor:
    """Margin hinge on the similarity row and column sums, per bucket
    (diagonal counted negative, off-diagonal positive)."""
    sim = _similarities(image_emb, profile_emb, buckets, image_emb)
    n = sim.shape[-1]
    sign = 1.0 - 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device)
    sim = sim * sign
    loss_1 = F.relu(margin + sim.sum(dim=1)).mean()
    loss_2 = F.relu(margin + sim.sum(dim=2)).mean()
    return (loss_1 + loss_2) / 2


def distance_loss(image_emb: torch.Tensor,
                  profile_emb: torch.Tensor) -> torch.Tensor:
    """Plain MSE between the modality embeddings."""
    return mse_loss(image_emb, profile_emb)


def zero_loss(*args, **kwargs) -> torch.Tensor:
    """Constant-zero loss: an f32 scalar on the first argument's device,
    a leaf that requires grad, so ``backward`` runs and leaves every
    parameter's gradient None (zero, as JAX differentiates a constant)."""
    device = args[0].device if args else None
    return torch.zeros((), device=device, requires_grad=True)


def arcface_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                 label: torch.Tensor, weight: torch.Tensor, s: float = 30.0,
                 m: float = 0.50, easy_margin: bool = False) -> torch.Tensor:
    """Additive-angular-margin classifier over both modalities' embeddings
    (stacked, labels tiled); ``weight``: (n_classes, dim)."""
    emb = torch.cat([image_emb, profile_emb], dim=0)
    label = label.reshape(-1).repeat(2)
    dtype = torch.promote_types(emb.dtype, weight.dtype)  # JAX promotion
    cosine = l2_normalize(emb).to(dtype) \
        @ l2_normalize(weight, dim=-1).to(dtype).T
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        phi = torch.where(cosine > th, phi, cosine - mm)
    one_hot = F.one_hot(label.long(), weight.shape[0]).to(cosine.dtype)
    output = (one_hot * phi + (1.0 - one_hot) * cosine) * s
    logprobs = torch.log_softmax(output, dim=-1)
    return -torch.mean(torch.sum(one_hot * logprobs, dim=-1))


def cross_entropy_loss(logits: torch.Tensor,
                       label: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (supervised heads)."""
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logprobs, label.long()[:, None],
                                            dim=-1))
