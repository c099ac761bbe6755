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


@pytest.mark.parametrize("kind,pad_to", [
    ("cnn", None), ("cnn", 24), ("lstm", None), ("lstm", 20),
    ("transformer", 17)])
def test_tokenizer_by_kind_matches_jax(kind, pad_to):
    """``get_tokenizer(kind)``: the CNN stack (zero-padded when ragged or
    given ``pad_to``), the LSTM padding with last indices, the transformer
    tokens, each as the JAX package's."""
    from multimodal_plankton_recognition_tpu.data.tokenize import (
        get_tokenizer as jax_get_tokenizer,
    )
    from multimodal_plankton_recognition_torch.data.tokenize import (
        get_tokenizer,
    )

    rs = np.random.RandomState(1)
    for lengths in ((16, 16, 16), (16, 3, 9, 1)):
        profiles = [rs.randn(n, 6).astype(np.float32) for n in lengths]
        want = jax_get_tokenizer(kind, 16, pad_to)(profiles)
        got = get_tokenizer(kind, 16, pad_to)(profiles)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="rnn"):
        get_tokenizer("rnn")
