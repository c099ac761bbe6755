"""Exact kNN retrieval: the port's ``ANNClassifier`` against the JAX
package's on the same embeddings. Distances agree to 1e-5 (both f32, the
same ||q||^2 - 2 q.g + ||g||^2 expansion); predictions are equal."""

import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.ops import knn as jax_knn
from multimodal_plankton_recognition_torch.ops.knn import (
    ANNClassifier, inverse_distance_weights, weighted_mode,
)


def _unit(rs, n, d=32):
    x = rs.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_predict_many_matches_jax():
    rs = np.random.RandomState(0)
    gallery, labels = _unit(rs, 300), rs.randint(0, 5, 300)
    queries = [_unit(rs, 40), _unit(rs, 40)]
    queries[0][:3] = gallery[[7, 8, 9]]  # exact hits
    want_clf = jax_knn.ANNClassifier(gallery, labels, n_neighbors=32)
    got_clf = ANNClassifier(gallery, labels, "cpu", n_neighbors=32)
    for n_modalities in (1, 2):
        X = queries[:n_modalities]
        want = want_clf.predict_many(*X, ks=(1, 5, 10), epsilon=0.3)
        got = got_clf.predict_many(*X, ks=(1, 5, 10), epsilon=0.3)
        for k in (1, 5, 10):
            np.testing.assert_array_equal(got[k], want[k])
    neighbours = zip(got_clf.kneighbors(*queries, k=10),
                     want_clf.kneighbors(*queries, k=10))
    for n_hits, ((gi, gd), (wi, wd)) in zip((3, 0), neighbours):
        np.testing.assert_array_equal(gi, wi)
        # at an exact hit d is the square root of f32 rounding noise
        # (~3e-4 or 0 on either side), so there the squares are compared
        hit = (gd < 1e-3) | (wd < 1e-3)
        assert hit.sum() == n_hits
        np.testing.assert_allclose(gd[~hit], wd[~hit], atol=1e-5)
        np.testing.assert_allclose(gd[hit] ** 2, wd[hit] ** 2, atol=1e-6)


def test_exact_hit_takes_all_the_mass():
    """A query that is a gallery row is classified by that row alone,
    however many nearer-voting neighbours disagree."""
    rs = np.random.RandomState(1)
    gallery = _unit(rs, 50)
    labels = np.zeros(50, int)
    labels[17] = 3
    clf = ANNClassifier(gallery, labels, "cpu")
    assert clf.predict(gallery[17:18], k=10)[0] == 3

    dist = torch.tensor([[0.0, 0.5, 0.0], [0.5, 0.25, 1.0]])
    w = inverse_distance_weights(dist)
    np.testing.assert_array_equal(w[0].numpy(), [1.0, 0.0, 1.0])
    np.testing.assert_allclose(w[1].numpy(), [2.0, 4.0, 1.0])
    np.testing.assert_array_equal(
        jax_knn.inverse_distance_weights(dist.numpy()), w.numpy())
    classes = np.array([[1, 2, 2], [0, 1, 1]])
    np.testing.assert_array_equal(
        weighted_mode(classes, w.numpy()),
        jax_knn.weighted_mode(classes, w.numpy()))


def test_tpu_only_options_raise():
    """``approx`` (TPU machinery) raises; ``sharded`` (the parallel layer,
    ported) on one process is a one-rank gallery that predicts as the
    default."""
    gallery = np.eye(4, dtype=np.float32)
    with pytest.raises(NotImplementedError, match="not ported"):
        ANNClassifier(gallery, np.arange(4), approx=True)
    queries = gallery + 0.1
    want = ANNClassifier(gallery, np.arange(4), "cpu").kneighbors(queries,
                                                                 k=2)
    got = ANNClassifier(gallery, np.arange(4), "cpu",
                        sharded=True).kneighbors(queries, k=2)
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
