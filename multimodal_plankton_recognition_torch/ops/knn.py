"""Exact top-k gallery retrieval (``ops/knn.py`` of the JAX package).

Weighted exact kNN: ``||q - g||^2 = ||q||^2 - 2 q.g + ||g||^2`` in f32,
one ``queries @ gallery.T`` plus ``torch.topk``, then an inverse-distance
weighted vote with the reference's exact-hit rule. The public
``ANNClassifier`` API matches the JAX package's (and the reference's
pynndescent one): ``kneighbors(*X)`` queries once per query modality and
h-stacks the results, which is how the modalities are fused.

The index lives on the card unless the caller passes ``device="cpu"``;
without a card the default raises (``require_device``). ``sharded=True``
row-shards the gallery over the data ranks of a mesh (``parallel.knn``;
by default the mesh of the process group on ``device``, one rank without
one): every rank must then build it and query it alike. Not ported (TPU
machinery): ``approx=True`` (``jax.lax.approx_max_k``) and the 256-row
shape buckets that spared XLA a recompile per query size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; "
            f"pass device='cpu' to run on the CPU")
    return device


def topk_euclidean(queries: torch.Tensor, gallery: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices and euclidean distances of the k nearest gallery rows,
    nearest first. The product runs in full f32 on the card as long as
    ``torch.backends.cuda.matmul.allow_tf32`` is False (torch's default)."""
    q = queries.float()
    g = gallery.float()
    qn = (q * q).sum(dim=1, keepdim=True)
    gn = (g * g).sum(dim=1)
    sq = qn - 2.0 * (q @ g.T) + gn[None, :]
    scores, idx = torch.topk(-sq, k, dim=1)
    return idx, torch.sqrt(torch.clamp(-scores, min=0.0))


def inverse_distance_weights(dist: torch.Tensor,
                             exact_eps: float = 0.0) -> torch.Tensor:
    """Inverse-distance weights with the reference's exact-hit rule: when
    any neighbour of a row is at distance 0, those neighbours get weight 1
    and the rest 0. ``exact_eps`` widens the rule to ``dist <= exact_eps``
    (the serving artifact, ``retrieval/export.py``: a query that is a
    gallery member lands a little above 0 when the program that embeds it
    rounds differently from the one that built the gallery); the default
    0.0 is the reference's rule."""
    w = torch.where(dist > exact_eps, 1.0 / dist.clamp_min(1e-38),
                    torch.full_like(dist, torch.inf))
    inf_mask = torch.isinf(w)
    inf_row = inf_mask.any(dim=1, keepdim=True)
    return torch.where(inf_row, inf_mask.to(w.dtype), w)


def weighted_mode_device(classes: torch.Tensor, weights: torch.Tensor,
                         n_classes: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise weighted mode on the tensors' device: ``(argmax class id,
    votes (B, n_classes) f32)``, ties toward the smaller id (``argmax``
    gives the first maximum). The votes are a one-hot (B, K, C) product
    summed over the K neighbours, a fixed order on any device: an atomic
    scatter-add would make the f32 sums, and so a near tie, depend on the
    order the adds land in."""
    onehot = torch.nn.functional.one_hot(classes.long(), n_classes)
    votes = (onehot.float() * weights.float()[..., None]).sum(dim=1)
    return votes.argmax(dim=1), votes


def weighted_mode(classes: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Row-wise weighted mode; ties break toward the smaller class id
    (sklearn's ``weighted_mode``)."""
    classes = np.asarray(classes, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float64)
    n = int(classes.max()) + 1
    rows = np.repeat(np.arange(classes.shape[0]), classes.shape[1])
    votes = np.zeros((classes.shape[0], n), dtype=np.float64)
    np.add.at(votes, (rows, classes.ravel()), weights.ravel())
    return votes.argmax(axis=1)


class ANNClassifier:
    """Weighted-kNN classifier over an exact index held on ``device``.

    pynndescent build kwargs (``n_neighbors``, ``metric``, ...) and query
    kwargs (``epsilon``) are accepted and ignored, as in the JAX package:
    there is no graph to build.
    """

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 device: torch.device | str = "cuda", approx: bool = False,
                 sharded: bool = False, mesh=None,
                 **nndescent_args) -> None:
        if approx:
            raise NotImplementedError(
                "approx retrieval is TPU machinery, not ported (ROADMAP.md)")
        self.y_ = np.asarray(y).copy()
        X = np.asarray(X, np.float32)
        self._n_gallery = X.shape[0]
        self._mesh = None
        if sharded:
            from ..parallel import knn as pknn
            from ..parallel.mesh import create_mesh

            self._mesh = mesh if mesh is not None \
                else create_mesh(device=require_device(device))
            self._gallery = pknn.shard_gallery(X, self._mesh)
            self._device = self._mesh.device
        else:
            self._gallery = torch.as_tensor(X, device=require_device(device))
            self._device = self._gallery.device

    def kneighbors(self, *X: np.ndarray, k: int = 1, **query_args):
        k = min(k, self._n_gallery)
        out = []
        for x in X:
            q = torch.as_tensor(np.asarray(x, np.float32),
                                device=self._device)
            if self._mesh is not None:
                from ..parallel.knn import sharded_topk

                idx, dist = sharded_topk(q, self._gallery, k, self._mesh)
            else:
                idx, dist = topk_euclidean(q, self._gallery, k)
            out.append((idx.cpu().numpy(), dist.cpu().numpy()))
        return tuple(out)

    def predict(self, *X: np.ndarray, k: int = 1, **query_args) -> np.ndarray:
        return self.predict_many(*X, ks=(k,), **query_args)[k]

    def predict_many(self, *X: np.ndarray, ks: Tuple[int, ...],
                     **query_args) -> dict:
        """Predictions for several neighbour counts from ONE top-max(ks)
        query per modality (the k-NN set is a prefix of the max-k set)."""
        kmax = min(max(ks), self._n_gallery)
        neighbors = self.kneighbors(*X, k=kmax, **query_args)
        out = {}
        for k in ks:
            kk = min(k, kmax)
            idx = np.hstack([n[0][:, :kk] for n in neighbors])
            dist = np.hstack([n[1][:, :kk] for n in neighbors])
            weights = inverse_distance_weights(torch.from_numpy(dist)).numpy()
            out[k] = weighted_mode(self.y_[idx], weights).astype(int).ravel()
        return out
