"""Global-negatives contrastive losses over the ranks
(``parallel/contrastive.py`` of the JAX package).

Each rank holds its (B_local, D) rows of both embeddings, gathers the
other modality's rows of every data rank (``mesh.all_gather_rows``: an
all-gather whose backward sums the cotangents over the ranks and keeps
this rank's rows) and computes its local (B_local, B_global) block of
the similarities against its own diagonal, so the whole batch's InfoNCE
or SigLIP loss is computed without any rank holding the (B, B) matrix.
The column-softmax loss of I @ Pᵀ is the row-softmax loss of P @ Iᵀ, so
each rank takes row blocks of both directed matrices.

``reduce=False`` gives this rank's unreduced loss ``l_r``, whose mean
over the ranks is the global loss; the train step differentiates ``l_r``
and averages the gradients over the ranks, which is the gradient of the
global loss because the all-gather's backward carries the other ranks'
cotangents to this rank's rows (JAX's ``shard_step.py`` recipe: the
gradient of the pmean'd loss under ``check_vma=False``, pmean'd).
``reduce=True`` gives the global value on every rank, its gradient that
of ``l_r``, as JAX's pmean transposes there. The similarity products are
``torch.matmul`` (JAX computes them outside any kernel too).
"""

from __future__ import annotations

import torch

from ..ops.losses import l2_normalize
from .mesh import Mesh, all_gather_rows


class _MeanOverRanks(torch.autograd.Function):
    """The mean over the data axis; the cotangent passes through as it
    is (each rank's gradient stays its own loss's)."""

    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def mean_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if not mesh.distributed or mesh.n_data == 1:
        return x
    return _MeanOverRanks.apply(x, mesh.data_group, mesh.n_data)


def _row_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logprobs, labels[:, None], dim=-1).mean()


def _local_labels(mesh: Mesh, b_local: int, device) -> torch.Tensor:
    return mesh.data_index * b_local + torch.arange(b_local, device=device)


def global_clip_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                     logit_scale: torch.Tensor, mesh: Mesh,
                     reduce: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE over the global batch, from this rank's rows."""
    i = l2_normalize(image_emb)
    p = l2_normalize(profile_emb)
    b_local = i.shape[0]
    p_all = all_gather_rows(p, mesh)
    i_all = all_gather_rows(i, mesh)
    scale = torch.exp(logit_scale)
    labels = _local_labels(mesh, b_local, i.device)
    loss_i2p = _row_xent(i @ p_all.T * scale, labels)
    loss_p2i = _row_xent(p @ i_all.T * scale, labels)
    local = (loss_i2p + loss_p2i) / 2
    return mean_over_ranks(local, mesh) if reduce else local


def global_siglip_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                       logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                       mesh: Mesh, reduce: bool = True) -> torch.Tensor:
    """Pairwise sigmoid loss over the global batch (the sum over the whole
    matrix over the global batch size), from this rank's rows."""
    i = l2_normalize(image_emb)
    p = l2_normalize(profile_emb)
    b_local = i.shape[0]
    p_all = all_gather_rows(p, mesh)
    b_global = p_all.shape[0]
    logits = i @ p_all.T * torch.exp(logit_scale) + logit_bias
    cols = torch.arange(b_global, device=i.device)[None, :]
    rows = _local_labels(mesh, b_local, i.device)[:, None]
    labels = torch.where(cols == rows, 1.0, -1.0).to(logits.dtype)
    x = labels * logits
    local = torch.logaddexp(torch.zeros_like(x), -x).sum() / b_global
    # the mean of (local × the data ranks) over the ranks is their sum
    local = local * (b_global // b_local)
    return mean_over_ranks(local, mesh) if reduce else local
