"""Exact retrieval over a row-sharded gallery (``parallel/knn.py`` of the
JAX package).

Each data rank holds rows / n_data of the gallery (padded with
``_PAD_VALUE`` rows, which sit astronomically far from any real query)
and scores the replicated queries against them alone: its top-kl
candidates, kl = min(k, its rows), carry global row indices. One
all-gather of the (queries, kl) candidates in rank order feeds a merge
top-k that every rank computes alike. The global top-k is a subset of
the union of the ranks' top-k sets, so the merge loses nothing; ties in
distance may order differently than the unsharded ``topk_euclidean``
(both orders are valid k-NN sets). Neither the gallery nor the distance
matrix is ever whole on one rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, create_mesh

_PAD_VALUE = 1e15  # as ops.knn's padded rows in the JAX package


def _local_scores(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Negated squared euclidean distances of q rows to the local rows."""
    q = q.float()
    g = g.float()
    qn = (q * q).sum(dim=1, keepdim=True)
    gn = (g * g).sum(dim=1)
    return -(qn - 2.0 * (q @ g.T) + gn[None, :])


class ShardedGallery(NamedTuple):
    """This rank's rows of a padded, row-sharded gallery, the rows a rank
    holds, and the real (unpadded) row count, against which ``k`` is
    checked so that no pad row is ever a neighbour."""

    rows: torch.Tensor  #: (shard, dim), f32, on the mesh's device
    shard: int
    n_real: int


def shard_gallery(gallery: np.ndarray, mesh: Mesh,
                  n_real: Optional[int] = None) -> ShardedGallery:
    """Pad the gallery's rows to a multiple of the data ranks and keep
    this rank's contiguous slice on its device. ``n_real`` names the real
    rows of a gallery that already carries pad rows."""
    gallery = np.asarray(gallery, np.float32)
    if n_real is None:
        n_real = gallery.shape[0]
    pad = (-gallery.shape[0]) % mesh.n_data
    if pad:
        gallery = np.concatenate([
            gallery, np.full((pad, gallery.shape[1]), _PAD_VALUE,
                             np.float32)])
    shard = gallery.shape[0] // mesh.n_data
    start = mesh.data_index * shard
    rows = torch.as_tensor(gallery[start:start + shard]).to(mesh.device)
    return ShardedGallery(rows, shard, n_real)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's (nq, kl) block side by side, in rank order."""
    if not mesh.distributed or mesh.n_data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=1)


@torch.no_grad()
def sharded_topk(queries: torch.Tensor, gallery: ShardedGallery, k: int,
                 mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, euclidean distances) of the k nearest gallery rows of
    each query, nearest first, as tensors on the mesh's device; every
    data rank must call it with the same queries."""
    if k > gallery.n_real:
        raise ValueError(f"k={k} exceeds gallery size {gallery.n_real}")
    kl = min(k, gallery.shard)  # n_data * kl >= k, since k <= rows
    scores, lidx = torch.topk(_local_scores(queries, gallery.rows), kl,
                              dim=1)
    gidx = lidx + mesh.data_index * gallery.shard
    scores, gidx = _gather(scores, mesh), _gather(gidx, mesh)
    best, pos = torch.topk(scores, k, dim=1)
    idx = torch.take_along_dim(gidx, pos, dim=1)
    return idx, torch.sqrt(torch.clamp(-best, min=0.0))


def sharded_topk_euclidean(queries,
                           gallery: Union[np.ndarray, ShardedGallery],
                           k: int, mesh: Optional[Mesh] = None,
                           n_real: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's entry point: ``gallery`` as host rows (sharded
    here) or the ``ShardedGallery`` of ``shard_gallery`` (preferred for
    repeated queries); returns numpy (indices, distances)."""
    if mesh is None:
        mesh = create_mesh()
    if not isinstance(gallery, ShardedGallery):
        gallery = shard_gallery(np.asarray(gallery), mesh, n_real)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(mesh.device)
    idx, dist_ = sharded_topk(q, gallery, k, mesh)
    return idx.cpu().numpy(), dist_.cpu().numpy()
