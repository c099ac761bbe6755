"""Exact top-k gallery retrieval (``ops/knn.py`` of the JAX package).

Weighted exact kNN: ``||q - g||^2 = ||q||^2 - 2 q.g + ||g||^2`` in f32,
one ``queries @ gallery.T`` plus ``torch.topk``, then an inverse-distance
weighted vote with the reference's exact-hit rule. The public
``ANNClassifier`` API matches the JAX package's (and the reference's
pynndescent one): ``kneighbors(*X)`` queries once per query modality and
h-stacks the results, which is how the modalities are fused.

The index lives on the card unless the caller passes ``device="cpu"``;
without a card the default raises (``require_device``). Not ported (TPU
machinery): ``approx=True`` (``jax.lax.approx_max_k``),
``sharded=True`` (mesh-sharded gallery) and the 256-row shape buckets that
spared XLA a recompile per query size.
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


def inverse_distance_weights(dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights with the reference's exact-hit rule: when
    any neighbour of a row is at distance 0, those neighbours get weight 1
    and the rest 0."""
    w = torch.where(dist > 0, 1.0 / dist.clamp_min(1e-38),
                    torch.full_like(dist, torch.inf))
    inf_mask = torch.isinf(w)
    inf_row = inf_mask.any(dim=1, keepdim=True)
    return torch.where(inf_row, inf_mask.to(w.dtype), w)


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
                 sharded: bool = False, **nndescent_args) -> None:
        if approx or sharded:
            raise NotImplementedError(
                "approx / sharded retrieval is TPU machinery, not ported "
                "(ROADMAP.md)")
        self.y_ = np.asarray(y).copy()
        self._gallery = torch.as_tensor(np.asarray(X, np.float32),
                                        device=require_device(device))

    def kneighbors(self, *X: np.ndarray, k: int = 1, **query_args):
        k = min(k, self._gallery.shape[0])
        out = []
        for x in X:
            q = torch.as_tensor(np.asarray(x, np.float32),
                                device=self._gallery.device)
            idx, dist = topk_euclidean(q, self._gallery, k)
            out.append((idx.cpu().numpy(), dist.cpu().numpy()))
        return tuple(out)

    def predict(self, *X: np.ndarray, k: int = 1, **query_args) -> np.ndarray:
        return self.predict_many(*X, ks=(k,), **query_args)[k]

    def predict_many(self, *X: np.ndarray, ks: Tuple[int, ...],
                     **query_args) -> dict:
        """Predictions for several neighbour counts from ONE top-max(ks)
        query per modality (the k-NN set is a prefix of the max-k set)."""
        kmax = min(max(ks), self._gallery.shape[0])
        neighbors = self.kneighbors(*X, k=kmax, **query_args)
        out = {}
        for k in ks:
            kk = min(k, kmax)
            idx = np.hstack([n[0][:, :kk] for n in neighbors])
            dist = np.hstack([n[1][:, :kk] for n in neighbors])
            weights = inverse_distance_weights(torch.from_numpy(dist)).numpy()
            out[k] = weighted_mode(self.y_[idx], weights).astype(int).ravel()
        return out
