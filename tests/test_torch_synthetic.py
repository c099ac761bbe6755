"""The port's synthetic dataset (``data/synthetic.py``) against the JAX
package's: for the same arguments the same files, byte for byte (JPEGs,
profile CSVs, ``annotations.csv`` and the split's ``train.csv`` and
``test.csv``, whose per-class shuffle reproduces pandas'
``sample(frac=1.0, random_state=seed)``)."""

import filecmp

import numpy as np
import pandas as pd
import pytest

from multimodal_plankton_recognition_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic_dataset,
)
from multimodal_plankton_recognition_torch.data.synthetic import (
    _shuffled, make_synthetic_dataset,
)


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("kwargs", [
    {"n_classes": 3, "n_per_class": 8, "seed": 0},
    {"n_classes": 2, "n_per_class": 5, "seed": 7},
    {"n_classes": 4, "n_per_class": 3, "seed": 123,
     "image_size_range": (40, 60), "profile_len_range": (1, 30)},
    {"n_classes": 3, "n_per_class": 4, "seed": 1, "with_split": False},
], ids=["default", "odd-split", "small", "no-split"])
def test_writes_the_jax_files(tmp_path, kwargs):
    want_root, got_root = tmp_path / "jax", tmp_path / "port"
    want = jax_make_synthetic_dataset(want_root, **kwargs)
    got = make_synthetic_dataset(got_root, **kwargs)
    assert got.relative_to(got_root) == want.relative_to(want_root)
    files = _files(want_root)
    assert files == _files(got_root)
    assert len(files) == 2 * kwargs["n_classes"] * kwargs["n_per_class"] \
        + 1 + 2 * kwargs.get("with_split", True)
    _, mismatch, errors = filecmp.cmpfiles(want_root, got_root, files,
                                           shallow=False)
    assert not mismatch and not errors, mismatch + errors


@pytest.mark.parametrize("n", [1, 2, 5, 8, 33])
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_shuffle_is_pandas_sample(n, seed):
    frame = pd.DataFrame({"row": np.arange(n)})
    want = frame.sample(frac=1.0, random_state=seed)["row"].to_numpy()
    np.testing.assert_array_equal(_shuffled(n, seed), want)
