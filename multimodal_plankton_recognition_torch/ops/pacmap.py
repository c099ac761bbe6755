"""PaCMAP dimensionality reduction (``ops/pacmap.py`` of the JAX
package), for the embedding-space plots of ``scripts/analysis_torch.py``.

The algorithm of Wang et al. (JMLR 2021), from scratch: pair selection
on scaled distances (numpy on the host, once; JAX's code, copied), then
a three-term attraction/repulsion loss, differentiated by autograd and
optimised with Adam under the published three-phase weight schedule, on
a device (the card by default). The reference pacmap's defaults:
n_neighbors=10, MN_ratio=0.5, FP_ratio=2.0, 450 iterations, Adam(lr=1.0),
PCA*0.01 init.

Determinism: the pair gathers' backward adds into rows of y; on the card
``pacmap`` runs it with PyTorch's deterministic algorithms (a sorted,
fixed-order accumulate in place of atomics), so a seed gives the same
bits on one device, call after call.
"""

from __future__ import annotations

import numpy as np
import torch

from .knn import require_device


def _phase_weights(n_iters: int, t1: int = 100, t2: int = 200) -> np.ndarray:
    """(n_iters, 3) array of (w_neighbors, w_MN, w_FP) per iteration."""
    w = np.zeros((n_iters, 3), np.float32)
    for t in range(n_iters):
        if t < t1:
            w_mn = 1000.0 * (1.0 - t / t1) + 3.0 * (t / t1)
            w[t] = (2.0, w_mn, 1.0)
        elif t < t2:
            w[t] = (3.0, 3.0, 1.0)
        else:
            w[t] = (1.0, 0.0, 1.0)
    return w


def _select_pairs(X: np.ndarray, n_neighbors: int, mn_ratio: float,
                  fp_ratio: float, seed: int):
    """Host-side pair selection (runs once; O(N²) numpy).

    Near pairs use PaCMAP's scaled distance d²/(σ_i σ_j) with σ_i the mean
    distance to the 4th-6th neighbors; mid-near pairs take the 2nd-closest
    of 6 random samples; far pairs are uniform random non-identical points.
    """
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    n_mn = max(1, int(round(n_neighbors * mn_ratio)))
    n_fp = max(1, int(round(n_neighbors * fp_ratio)))
    n_neighbors = min(n_neighbors, n - 1)

    sq = (X ** 2).sum(1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    np.fill_diagonal(d2, np.inf)

    order = np.argsort(d2, axis=1)
    # sigma: mean distance to 4th-6th nearest (indices 3..5), floored
    take = order[:, 3:6] if n > 6 else order[:, :max(1, n - 1)]
    sig = np.sqrt(np.take_along_axis(d2, take, axis=1)).mean(1)
    sig = np.maximum(sig, 1e-10)
    scaled = d2 / (sig[:, None] * sig[None, :])
    near_j = np.argsort(scaled, axis=1)[:, :n_neighbors]
    near = np.stack([np.repeat(np.arange(n), n_neighbors),
                     near_j.ravel()], axis=1)

    # mid-near: 2nd closest of 6 uniform samples (per pair)
    cand = rng.integers(0, n, size=(n, n_mn, 6))
    cd = np.take_along_axis(d2, cand.reshape(n, -1), axis=1)\
        .reshape(n, n_mn, 6)
    second = np.argsort(cd, axis=2)[:, :, 1]
    mn_j = np.take_along_axis(cand, second[:, :, None], axis=2)[:, :, 0]
    mid = np.stack([np.repeat(np.arange(n), n_mn), mn_j.ravel()], axis=1)

    fp_j = rng.integers(0, n, size=(n, n_fp))
    fp_j = np.where(fp_j == np.arange(n)[:, None], (fp_j + 1) % n, fp_j)
    far = np.stack([np.repeat(np.arange(n), n_fp), fp_j.ravel()], axis=1)
    return near.astype(np.int32), mid.astype(np.int32), far.astype(np.int32)


def pacmap(X: np.ndarray, n_components: int = 2, n_neighbors: int = 10,
           mn_ratio: float = 0.5, fp_ratio: float = 2.0,
           n_iters: int = 450, lr: float = 1.0, seed: int = 0,
           device: torch.device | str = "cuda") -> np.ndarray:
    """Project X (N, D) to (N, n_components) on ``device`` (the card unless
    the caller names another; without a card the default raises).
    Deterministic given ``seed`` on one device."""
    device = require_device(device)
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    if n <= n_components:
        return X[:, :n_components].copy()
    near, mid, far = _select_pairs(X, n_neighbors, mn_ratio, fp_ratio, seed)
    weights = torch.from_numpy(_phase_weights(n_iters)).to(device)

    # PCA * 0.01 init (reference pacmap default)
    Xc = X - X.mean(0)
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    y = torch.from_numpy(0.01 * (Xc @ vt[:n_components].T)).to(device)
    pairs = [torch.from_numpy(p).long().to(device) for p in (near, mid, far)]

    def loss_fn(y, w):
        def pair_d(p):
            diff = y[p[:, 0]] - y[p[:, 1]]
            return 1.0 + (diff * diff).sum(dim=1)
        d_nb, d_mn, d_fp = (pair_d(p) for p in pairs)
        l_nb = (d_nb / (10.0 + d_nb)).sum()
        l_mn = (d_mn / (10000.0 + d_mn)).sum()
        l_fp = (1.0 / (1.0 + d_fp)).sum()
        return w[0] * l_nb + w[1] * l_mn + w[2] * l_fp

    b1, b2, eps = 0.9, 0.999, 1e-7
    m, v = torch.zeros_like(y), torch.zeros_like(y)
    t = torch.zeros((), dtype=torch.float32, device=device)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for w in weights:
            y = y.detach().requires_grad_()
            (g,) = torch.autograd.grad(loss_fn(y, w), y)
            with torch.no_grad():
                t = t + 1
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mhat = m / (1 - torch.pow(b1, t))
                vhat = v / (1 - torch.pow(b2, t))
                y = y - lr * mhat / (torch.sqrt(vhat) + eps)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    return y.detach().cpu().numpy()
