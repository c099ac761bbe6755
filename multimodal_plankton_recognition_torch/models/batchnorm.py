"""BatchNorm and GroupNorm as ``flax.linen`` has them, over dim 1 of a
(B, C, ...) tensor (the port's conv layout; the Flax modules normalize the
last axis of its channel-last tensors).

Not ``nn.BatchNorm2d``, which differs from Flax in three ways:

* the running statistics update as ``ra = 0.99·ra + 0.01·batch``
  (Flax's momentum 0.99; torch's 0.1 weighs the other way);
* the running variance takes the biased batch variance (torch keeps the
  unbiased one);
* statistics, scale and bias stay f32 whatever the module's dtype: a Flax
  BatchNorm reduces in f32 and keeps its variables f32, and only its output
  takes the compute dtype. ``_apply`` keeps them f32 through
  ``module.to(dtype)``.

The batch variance is E[x²] − E[x]², floored at 0 (``use_fast_variance``),
from x in f32; the output, (x − mean) · (rsqrt(var + eps) · scale) + bias
in f32, takes the input's dtype. Train mode normalizes with the batch
statistics and updates the running ones (one update per forward); eval mode
uses the running ones and leaves them alone. Inside ``recomputing()`` (the
recompute of a checkpointed block, ``models/image/efficientnet.py``'s
``remat``) a train-mode forward leaves them alone too, so they move once a
step, as Flax's ``nn.remat`` moves ``batch_stats``.

Inside ``synchronised(mesh)`` (the train steps on more than one data rank,
``train/loop.py``) a train-mode forward takes the statistics of the
global batch, as Flax's BatchNorm does over a batch that GSPMD shards:
each rank's f32 sums of x and x² and its count are summed over the data
ranks (``parallel.mesh.sum_over_ranks``, whose backward sums the
cotangents alike) before E[x²] − E[x]², floored at 0. On one data rank
the context does nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Tuple

import torch
from torch import nn

MOMENTUM = 0.99  # flax.linen.BatchNorm's default
BN_EPS = 1e-5    # flax.linen.BatchNorm's default
GN_EPS = 1e-6    # flax.linen.GroupNorm's default

_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "plankton_bn_recomputing", default=False)
_SYNC_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "plankton_bn_sync_mesh", default=None)


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """Hold every ``update_stats`` inside the block: the forward it wraps
    is a recompute of one whose statistics already moved."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


@contextlib.contextmanager
def synchronised(mesh) -> Iterator[None]:
    """Train-mode BatchNorm statistics over ``mesh``'s data ranks inside
    the block (nothing on one data rank)."""
    token = _SYNC_MESH.set(mesh if mesh is not None and mesh.distributed
                           and mesh.n_data > 1 else None)
    try:
        yield
    finally:
        _SYNC_MESH.reset(token)


def sync_mesh():
    """The mesh of ``synchronised`` in force here, else None."""
    return _SYNC_MESH.get()


def is_synchronised() -> bool:
    """Whether train-mode statistics are taken over several ranks here (a
    route that computes them itself, the fused MBConv kernels, must not
    be taken)."""
    return _SYNC_MESH.get() is not None


def batch_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, max(0, E[x²] − mean²)) over ``dims``, in f32."""
    xf = x.float()
    m = xf.mean(dims)
    return m, torch.clamp((xf * xf).mean(dims) - m * m, min=0.0)


def synced_batch_stats(x: torch.Tensor, dims, mesh
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batch_stats`` over every data rank's rows: the f32 sums of x and
    x² and the count, summed over the ranks."""
    from ..parallel.mesh import sum_over_ranks

    xf = x.float()
    c = xf.shape[1]
    count = torch.full((1,), float(xf.numel() // c), device=xf.device)
    sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
    sums = sum_over_ranks(sums, mesh)
    n = sums[-1]
    m = sums[:c] / n
    return m, torch.clamp(sums[c:2 * c] / n - m * m, min=0.0)


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Flax's ``_normalize``: (x − mean) · (rsqrt(var + eps) · scale) + bias
    in f32, in x's dtype. ``mean`` and ``var`` are (C,) or per sample
    (B, C)."""
    tail = (1,) * (x.dim() - 2)
    chan = (1, -1) + tail
    stat = chan if mean.dim() == 1 else tuple(mean.shape) + tail
    mul = torch.rsqrt(var + eps).reshape(stat) * weight.reshape(chan)
    y = (x.float() - mean.reshape(stat)) * mul + bias.reshape(chan)
    return y.to(x.dtype)


class _F32Norm(nn.Module):
    """A norm whose floating parameters and buffers stay f32: a cast to
    another float dtype moves them to its device only, so they are never
    rounded through it."""

    def _apply(self, fn, recurse=True):
        def keep_f32(t: torch.Tensor) -> torch.Tensor:
            out = fn(t)
            if out.is_floating_point() and out.dtype != torch.float32:
                return t.to(out.device)
            return out
        return super()._apply(keep_f32, recurse)


class BatchNorm(_F32Norm):
    """``flax.linen.BatchNorm`` over dim 1 (``scale`` → ``weight``; the
    ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` /
    ``running_var``)."""

    def __init__(self, num_features: int, momentum: float = MOMENTUM,
                 eps: float = BN_EPS) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = momentum·ra + (1 − momentum)·batch, for mean and var;
        nothing inside ``recomputing()``."""
        if _RECOMPUTING.get():
            return
        for ra, batch in ((self.running_mean, mean), (self.running_var, var)):
            ra.copy_(self.momentum * ra + (1 - self.momentum)
                     * batch.detach().float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0, *range(2, x.dim()))
            mesh = _SYNC_MESH.get()
            mean, var = batch_stats(x, dims) if mesh is None \
                else synced_batch_stats(x, dims, mesh)
            self.update_stats(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return normalize(x, mean, var, self.weight, self.bias, self.eps)


class GroupNorm(_F32Norm):
    """``flax.linen.GroupNorm(num_groups=None, group_size=...)`` over dim 1:
    per sample and group of ``group_size`` channels, statistics over the
    group's channels and every position; no running statistics."""

    def __init__(self, num_features: int, group_size: int = 8,
                 eps: float = GN_EPS) -> None:
        super().__init__()
        if num_features % group_size:
            raise ValueError(f"{num_features} channels do not split into "
                             f"groups of {group_size}")
        self.group_size = group_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        groups = x.reshape(b, c // self.group_size, self.group_size, -1)
        mean, var = batch_stats(groups, (2, 3))
        mean = mean.repeat_interleave(self.group_size, dim=1)
        var = var.repeat_interleave(self.group_size, dim=1)
        return normalize(x, mean, var, self.weight, self.bias, self.eps)
