"""PaCMAP of the port (``ops/pacmap.py``) against the JAX package's.

Tolerances: the phase weights and the selected pairs exactly JAX's (the
same numpy code on the same generator); 10 iterations of the optimisation
within 1e-4 abs of JAX's from the same pairs and PCA init (f32 Adam on
both sides, the gradients by autograd against ``jax.grad``); JAX's own
cluster-separation and determinism criteria, restated.
"""

import numpy as np
import pytest

from multimodal_plankton_recognition_tpu.ops import pacmap as jax_pacmap
from multimodal_plankton_recognition_torch.ops.pacmap import (
    _phase_weights, _select_pairs, pacmap,
)
from torch_threads import one_thread  # noqa: F401

ITER_TOL = 1e-4


def _blobs(n_per=60, d=32, k=3, sep=8.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * sep
    X = np.concatenate([centers[i] + rng.standard_normal((n_per, d))
                        for i in range(k)])
    y = np.repeat(np.arange(k), n_per)
    return X.astype(np.float32), y


@pytest.mark.parametrize("n_iters", [10, 450])
def test_phase_weights_are_jax(n_iters):
    np.testing.assert_array_equal(_phase_weights(n_iters),
                                  jax_pacmap._phase_weights(n_iters))


@pytest.mark.parametrize("n_per,seed", [(30, 0), (3, 1), (60, 7)])
def test_pairs_are_jax(n_per, seed):
    X, _ = _blobs(n_per=n_per, seed=seed)
    for got, want in zip(_select_pairs(X, 10, 0.5, 2.0, seed),
                         jax_pacmap._select_pairs(X, 10, 0.5, 2.0, seed)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_first_iterations_match_jax(seed):
    X, _ = _blobs(n_per=30, d=16, seed=seed)
    got = pacmap(X, n_iters=10, seed=seed, device="cpu")
    want = jax_pacmap.pacmap(X, n_iters=10, seed=seed)
    assert got.dtype == np.float32 and got.shape == (90, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=ITER_TOL)


def test_pacmap_separates_clusters():
    """JAX's criterion: mean inter-cluster distance above 3x the mean
    intra-cluster distance after 250 iterations."""
    X, y = _blobs()
    proj = pacmap(X, n_components=2, n_iters=250, seed=0, device="cpu")
    assert proj.shape == (len(X), 2)
    assert np.all(np.isfinite(proj))
    intra, inter = [], []
    for i in range(3):
        pi = proj[y == i]
        intra.append(np.linalg.norm(pi - pi.mean(0), axis=1).mean())
        for j in range(i + 1, 3):
            inter.append(np.linalg.norm(pi.mean(0) - proj[y == j].mean(0)))
    assert np.mean(inter) > 3.0 * np.mean(intra), (np.mean(inter),
                                                   np.mean(intra))


def test_pacmap_deterministic():
    X, _ = _blobs(n_per=20)
    p1 = pacmap(X, n_iters=50, seed=3, device="cpu")
    p2 = pacmap(X, n_iters=50, seed=3, device="cpu")
    np.testing.assert_array_equal(p1, p2)


def test_tiny_inputs_and_the_card_default(monkeypatch):
    X = np.arange(4, dtype=np.float32).reshape(2, 2)
    np.testing.assert_array_equal(pacmap(X, device="cpu"),
                                  jax_pacmap.pacmap(X))
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pacmap(X)
