"""The port's own ``tokenize_transformer`` equals the JAX package's, element
for element, on ragged profile batches."""

import numpy as np
import pytest

from multimodal_plankton_recognition_tpu.data.tokenize import (
    tokenize_transformer as jax_tokenize_transformer,
)
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)


@pytest.mark.parametrize("pad_to", [None, 17, 40])
def test_matches_jax_tokenizer(pad_to):
    rs = np.random.RandomState(0)
    profiles = [rs.randn(n, 6).astype(np.float32) for n in (16, 3, 9, 1)]
    want = jax_tokenize_transformer(profiles, 16, pad_to)
    got = tokenize_transformer(profiles, 16, pad_to)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_single_profile_and_short_pad():
    p = np.ones((5, 6), np.float32)
    np.testing.assert_array_equal(tokenize_transformer(p, 8)["time"],
                                  jax_tokenize_transformer(p, 8)["time"])
    with pytest.raises(ValueError, match="pad_to"):
        tokenize_transformer([p], 8, pad_to=5)
