"""Attention parity: the PyTorch port's plain version and module against
the JAX package's kernel, oracle and module.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` compares it
with ``mha_qkv_reference`` there); on the CPU the wrapper takes the plain
version. Tolerances: 1e-5 where both sides compute in f32 (same math,
another summation order); 5e-2 in bf16, the JAX suite's own bf16
attention tolerance (tests/test_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.attention import (
    FusedSelfAttention as JaxFusedSelfAttention,
)
from multimodal_plankton_recognition_tpu.ops.pallas.attention import (
    mha_core_qkv, mha_reference,
)
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    mha_qkv, mha_qkv_reference,
)

SHAPES = [(3, 17, 48), (4, 21, 32)]  # (heads, L, E): head dims 16 and 8


def _qkv(b, l, e, seed=0):
    return np.random.RandomState(seed).randn(b, l, 3 * e).astype(np.float32)


def _pad(b, l, seed=1):
    pad = np.random.RandomState(seed).rand(b, l) < 0.3
    pad[:, 0] = False  # CLS is never masked
    return pad


def _bias(pad):
    return np.where(pad, -1e9, 0.0).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads,l,e", SHAPES)
def test_reference_f32_matches_jax_reference(heads, l, e, masked):
    b = 3
    qkv = _qkv(b, l, e)
    bias = _bias(_pad(b, l)) if masked else np.zeros((b, l), np.float32)
    q, k, v = np.split(qkv, 3, axis=-1)
    ref = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(bias), heads)
    out = mha_qkv_reference(torch.from_numpy(qkv),
                            torch.from_numpy(bias) if masked else None, heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads,l,e", SHAPES)
def test_bf16_matches_jax_kernel_interpret(heads, l, e, masked):
    b = 3
    qkv = _qkv(b, l, e, seed=2)
    bias = _bias(_pad(b, l)) if masked else np.zeros((b, l), np.float32)
    want = mha_core_qkv(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
                        jnp.zeros((), jnp.int32), heads, 0.0, False, True,
                        masked)
    got = mha_qkv(torch.from_numpy(qkv).to(torch.bfloat16),
                  torch.from_numpy(bias) if masked else None, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, e)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_module_matches_jax_module(dtype, masked, monkeypatch):
    """Converted weights, same inputs. f32: the JAX module takes its einsum
    path. bf16: PLANKTON_FUSED_INTERPRET=1 sends it through the Pallas
    kernel in interpret mode."""
    b, l, e, heads = 2, 19, 64, 4
    rs = np.random.RandomState(3)
    x = rs.randn(b, l, e).astype(np.float32)
    pad = _pad(b, l, seed=5) if masked else None
    jdtype = getattr(jnp, dtype)
    jmod = JaxFusedSelfAttention(num_heads=heads, dtype=jdtype)
    jx = jnp.asarray(x, jdtype)
    jpad = None if pad is None else jnp.asarray(pad)
    variables = jmod.init(jax.random.key(0), jx, jpad)
    if dtype == "bfloat16":
        monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    want = np.asarray(jmod.apply(variables, jx, jpad), np.float32)

    tdtype = getattr(torch, dtype)
    mod = FusedSelfAttention(e, heads).to(tdtype)
    load_flax(mod, jax.tree.map(np.asarray, variables))
    got = mod(torch.from_numpy(x).to(tdtype),
              None if pad is None else torch.from_numpy(pad))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=tol, atol=tol)


def test_cpu_wrapper_does_not_launch():
    before = mha_qkv.launches
    qkv = torch.from_numpy(_qkv(2, 9, 48)).to(torch.bfloat16)
    mha_qkv(qkv, None, 3)
    assert mha_qkv.launches == before == 0


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent plain path: a tensor that is neither on the CPU nor on a
    CUDA device is refused."""
    qkv = torch.empty((2, 9, 144), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        mha_qkv(qkv, None, 3)
