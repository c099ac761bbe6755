"""The CSV path's random train transforms of the port
(``data/transforms.py``: ``ImageTransformTrain``, ``ProfileTransformTrain``,
``PairAugmentation``; ``data/dataset.py``: ``MultiSet(...,
pair_augmentation=...)``) against the JAX package's, bit for bit: the
same numpy generator gives the same arrays and leaves the generator in
the same state, and two epochs of the port's ``Loader`` over the port's
``MultiSet`` give JAX's batches exactly.
"""

import numpy as np
import pytest
from PIL import Image

from multimodal_plankton_recognition_tpu.data import dataset as jax_dataset
from multimodal_plankton_recognition_tpu.data import pipeline as jax_pipeline
from multimodal_plankton_recognition_tpu.data import tokenize as jax_tokenize
from multimodal_plankton_recognition_tpu.data import (
    transforms as jax_transforms,
)
from multimodal_plankton_recognition_torch.data import dataset, pipeline
from multimodal_plankton_recognition_torch.data import tokenize, transforms

TS = 32  # oversize 34
IMAGE_SIZES = [(60, 90), (130, 70), (80, 80), (200, 41)]
PROFILE_LENGTHS = [1, 5, 33, 34, 35, 400]  # below, at and above the oversize


def _image(h, w, seed):
    rs = np.random.RandomState(seed)
    return Image.fromarray(rs.randint(0, 256, (h, w), np.uint8), mode="L")


def _profile(length, seed):
    return np.random.RandomState(seed).gamma(2.0, 300.0, (length, 6))


def _same_state(a, b):
    """Both generators drew the same number of values."""
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("size", IMAGE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_image_transform_train_matches_jax(size, seed):
    img = _image(*size, seed)
    g_port, g_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    got = transforms.ImageTransformTrain(TS)(img, g_port)
    want = jax_transforms.ImageTransformTrain(TS)(img, g_jax)
    assert got.shape == (TS, TS, 1) and got.dtype == np.float32
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    _same_state(g_port, g_jax)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("length", PROFILE_LENGTHS)
def test_profile_transform_train_matches_jax(length, seed):
    prof = _profile(length, seed)
    g_port, g_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    got = transforms.ProfileTransformTrain(TS)(prof, g_port)
    want = jax_transforms.ProfileTransformTrain(TS)(prof, g_jax)
    assert got.shape == (TS, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    _same_state(g_port, g_jax)


@pytest.mark.parametrize("seed", range(8))
def test_pair_augmentation_matches_jax(seed):
    """The whole train chain on one generator, in the JAX order: image,
    profile, then the pair's coin (which flips about half the seeds)."""
    img, prof = _image(70, 110, seed), _profile(50, seed)
    out = {}
    for name, tf in (("port", transforms), ("jax", jax_transforms)):
        g = np.random.default_rng(seed)
        x = tf.ImageTransformTrain(TS)(img, g)
        p = tf.ProfileTransformTrain(TS)(prof, g)
        out[name] = (*tf.PairAugmentation()(x, p, g), g)
    for got, want in zip(out["port"][:2], out["jax"][:2]):
        np.testing.assert_array_equal(got, want)
        assert got.flags["C_CONTIGUOUS"]
    _same_state(out["port"][2], out["jax"][2])


def test_pair_augmentation_flips_together():
    """On the coin's 0 both flip: the image left-right, the profile in
    time; on 1 neither does."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4, 1)
    p = np.arange(10, dtype=np.float32).reshape(5, 2)
    flips = set()
    for seed in range(20):
        coin = np.random.default_rng(seed).integers(0, 2)
        got_x, got_p = transforms.PairAugmentation()(
            x, p, np.random.default_rng(seed))
        if coin == 0:
            np.testing.assert_array_equal(got_x, x[:, ::-1])
            np.testing.assert_array_equal(got_p, p[::-1])
        else:
            assert got_x is x and got_p is p
        flips.add(int(coin))
    assert flips == {0, 1}


def _train_sets(split_dir):
    return [
        module.MultiSet(split_dir / "train.csv", tf.ImageTransformTrain(TS),
                        tf.ProfileTransformTrain(TS), tf.PairAugmentation())
        for module, tf in ((dataset, transforms),
                           (jax_dataset, jax_transforms))]


@pytest.mark.parametrize("index", [0, 3, 7, 11])
def test_multiset_items_match_jax(synthetic_dataset, index):
    port, jax_set = _train_sets(synthetic_dataset)
    for seed in range(3):
        g_port = np.random.default_rng(seed)
        g_jax = np.random.default_rng(seed)
        got = port.__getitem__(index, g_port)
        want = jax_set.__getitem__(index, g_jax)
        assert got.keys() == want.keys()
        for key in ("image", "profile", "image_shape", "profile_length"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
        assert got["label"] == want["label"]
        _same_state(g_port, g_jax)


@pytest.mark.parametrize("kind", ["transformer", "cnn"])
def test_loader_epochs_match_jax(synthetic_dataset, kind):
    """Two epochs of the port's ``Loader`` (shuffled, last batch dropped,
    threaded) over the port's ``MultiSet`` give JAX's batches, batch for
    batch, bit for bit."""
    port_set, jax_set = _train_sets(synthetic_dataset)
    pad = TS + 1 if kind == "transformer" else TS
    port = pipeline.Loader(
        port_set, 4, pipeline.multi_collate_fn(
            tokenize.get_tokenizer(kind, TS, pad_to=pad)),
        shuffle=True, drop_last=True, num_workers=3, seed=5)
    jax_loader = jax_pipeline.Loader(
        jax_set, 4, jax_pipeline.multi_collate_fn(
            jax_tokenize.get_tokenizer(kind, TS, pad_to=pad)),
        shuffle=True, drop_last=True, num_workers=3, seed=5)
    for epoch in range(2):
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == len(port_set) // 4 > 0, epoch
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key])
