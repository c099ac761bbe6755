"""Attention backward and dropout: the port's plain versions against the
JAX package's gradients, and the dropout mask's contract.

The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` compare them with these plain versions there).
Tolerances:

* 1e-5 in f32, where both sides compute the same gradient in f32 and sum
  in another order;
* 2e-2 in bf16 against the JAX kernel in interpret mode: the plain version
  rounds at the kernel's points (dS and the dropped P to bf16, dqkv on
  store), so the two differ only where an f32 sum taken in another order
  lands across a bf16 rounding boundary: one bf16 step, at most 1.6e-2 for
  the |dqkv| < 2 of these inputs. Besides the small shapes this holds the
  plain version at the CUDA backward's tile and chunk edges (L 15-577),
  against which ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
  the kernels on the card.

Dropout has no bit contract with the JAX package (the TPU PRNG has no
interpret mode, ``tests/test_attention.py:130-138``), so it is checked by
its own contract: the bits are a fixed function of (seed, sample, head,
row, key), the forward and backward use the same mask, and the keep rate
is 1 - p within a binomial bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.ops.pallas.attention import (
    mha_core_qkv, mha_reference,
)
from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.models.dropout import dropout_rng
from multimodal_plankton_recognition_torch.ops.attention import (
    BWD_CHUNK, bwd_scratch, dropout_bits, dropout_threshold, mha_qkv,
    mha_qkv_bwd, mha_qkv_bwd_reference, mha_qkv_reference,
)

SHAPES = [(3, 17, 48), (4, 21, 32)]  # (heads, L, E): head dims 16 and 8
# the CUDA backward's tile and chunk edges (16-row tiles, 128-row blocks,
# 256-row chunks: 577 takes three) at the flagship's head dims, D 24
# masked and D 64 unmasked: (heads, L, E, masked, B)
EDGE_LENGTHS = [15, 16, 17, 63, 64, 65, 128, 129, 577]
EDGE_CASES = [(2, l, e, masked, 1 if l > 256 else 2)
              for e, masked in ((48, True), (128, False))
              for l in EDGE_LENGTHS]
# the two SHAPES at B 3, masked or not, then EDGE_CASES
BF16_CASES = ([(h, l, e, masked, 3) for h, l, e in SHAPES
               for masked in (False, True)] + EDGE_CASES)
BF16_IDS = ([f"{h}-{l}-{e}-{m}" for h, l, e, m, _ in BF16_CASES[:4]]
            + [f"edge-{h}-{l}-{e}-{m}-B{b}" for h, l, e, m, b in EDGE_CASES])


def _inputs(b, l, e, masked, seed=0):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(b, l, 3 * e).astype(np.float32)
    dout = rs.randn(b, l, e).astype(np.float32)
    pad = rs.rand(b, l) < 0.3
    pad[:, 0] = False  # CLS is never masked
    bias = np.where(pad & masked, -1e9, 0.0).astype(np.float32)
    return qkv, dout, bias


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads,l,e", SHAPES)
def test_bwd_reference_f32_matches_jax_grad(heads, l, e, masked):
    qkv, dout, bias = _inputs(3, l, e, masked)

    def f(x):
        q, k, v = jnp.split(x, 3, axis=-1)
        return jnp.sum(mha_reference(q, k, v, jnp.asarray(bias), heads)
                       * dout)

    want = np.asarray(jax.grad(f)(jnp.asarray(qkv)))
    got = mha_qkv_bwd_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias) if masked else None,
        torch.from_numpy(dout), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads,l,e,masked,b", BF16_CASES, ids=BF16_IDS)
def test_bwd_bf16_matches_jax_kernel_interpret(heads, l, e, masked, b):
    qkv, dout, bias = _inputs(b, l, e, masked, seed=2)

    def f(x):
        o = mha_core_qkv(x, jnp.asarray(bias), jnp.zeros((), jnp.int32),
                         heads, 0.0, False, True, masked)
        return jnp.sum(o.astype(jnp.float32) * dout)

    want = jax.grad(f)(jnp.asarray(qkv, jnp.bfloat16))
    # mha_qkv_bwd on a CPU tensor takes the plain version
    got = mha_qkv_bwd(torch.from_numpy(qkv).to(torch.bfloat16),
                      torch.from_numpy(bias) if masked else None,
                      torch.from_numpy(dout).to(torch.bfloat16), heads)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_autograd_function_uses_the_backward_version():
    """``mha_qkv``'s backward is ``mha_qkv_bwd`` with the forward's bias,
    dropout probability and seed (on the CPU: the plain backward,
    exactly), not autograd of the forward."""
    qkv, dout, bias = _inputs(2, 19, 48, True, seed=4)
    x = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_()
    g = torch.from_numpy(dout).to(torch.bfloat16)
    mha_qkv(x, torch.from_numpy(bias), 3, 0.2, 77).backward(g)
    want = mha_qkv_bwd_reference(x.detach(), torch.from_numpy(bias), g, 3,
                                 0.2, 77)
    assert torch.equal(x.grad, want)


@pytest.mark.parametrize("masked", [False, True])
def test_dropout_gradient_equals_autograd_with_the_explicit_mask(masked):
    """Forward and backward draw the same mask: in f32 the gradient of
    ``mha_qkv`` equals autograd through attention with the mask built
    from ``dropout_bits`` outside."""
    b, l, e, heads, p, seed = 2, 23, 48, 3, 0.3, 4321
    qkv, dout, bias = _inputs(b, l, e, masked, seed=6)
    bias_t = torch.from_numpy(bias) if masked else None
    x = torch.from_numpy(qkv).requires_grad_()
    out = mha_qkv(x, bias_t, heads, p, seed)
    out.backward(torch.from_numpy(dout))

    keep = (dropout_bits(seed, b, heads, l) >= dropout_threshold(p)).float()
    y = torch.from_numpy(qkv).requires_grad_()
    q, k, v = (t.reshape(b, l, heads, e // heads).transpose(1, 2)
               for t in y.split(e, dim=-1))
    z = q @ k.transpose(-1, -2) / (e // heads) ** 0.5
    if masked:
        z = z + bias_t[:, None, None, :]
    probs = torch.softmax(z, dim=-1) * keep / (1 - p)
    ref = (probs @ v).transpose(1, 2).reshape(b, l, e)
    ref.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                               rtol=1e-5, atol=1e-5)


def _fmix32_int(x: int) -> int:
    """MurmurHash3's finaliser on Python ints (no overflow possible)."""
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & m
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def test_dropout_bits_are_the_documented_hash():
    """The int64 tensor arithmetic (16-bit split products) gives exactly
    the 32-bit hash of dropout.cuh, computed here on Python ints."""
    seed, b, h, l = 0x7FFFFFF0, 3, 5, 11
    bits = dropout_bits(seed, b, h, l)
    assert bits.dtype == torch.int64 and bits.shape == (b, h, l, l)
    assert int(bits.min()) >= 0 and int(bits.max()) <= 0xFFFFFFFF
    rs = np.random.RandomState(0)
    for _ in range(50):
        bi, hi, r, j = (int(rs.randint(n)) for n in (b, h, l, l))
        key = _fmix32_int(seed ^ _fmix32_int(bi * h + hi + 1))
        want = _fmix32_int(key ^ _fmix32_int(r * l + j + 1))
        assert int(bits[bi, hi, r, j]) == want


def test_dropout_mask_reproducible_and_seeded():
    a = dropout_bits(123, 2, 3, 16)
    assert torch.equal(a, dropout_bits(123, 2, 3, 16))
    assert not torch.equal(a, dropout_bits(124, 2, 3, 16))
    # every (sample, head) draws its own mask
    flat = a.reshape(6, -1)
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(6) for j in range(i))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_binomial_bound(p):
    bits = dropout_bits(99, 16, 8, 64)
    n = bits.numel()
    rate = (bits >= dropout_threshold(p)).double().mean().item()
    # 5 standard deviations of a binomial proportion
    assert abs(rate - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5


def test_dropout_is_unbiased_against_jax_no_drop_output():
    """The seed average of dropped outputs approaches the JAX package's
    no-dropout output (statistics only: no bit contract with the TPU
    PRNG)."""
    heads, b, l, e, p = 4, 2, 32, 64, 0.5
    qkv, _, _ = _inputs(b, l, e, False, seed=8)
    q, k, v = np.split(qkv, 3, axis=-1)
    base = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    jnp.zeros((b, l), jnp.float32), heads))
    outs = np.stack([mha_qkv_reference(torch.from_numpy(qkv), None, heads,
                                       p, s).numpy() for s in range(200)])
    assert not np.allclose(outs[0], outs[1])
    err = np.abs(outs.mean(0) - base).mean()
    assert err < 0.1 * np.abs(base).mean()


def test_p0_and_eval_are_the_no_dropout_path():
    qkv, _, bias = _inputs(2, 13, 48, True, seed=9)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    bias_t = torch.from_numpy(bias)
    base = mha_qkv_reference(x, bias_t, 3)
    assert torch.equal(mha_qkv(x, bias_t, 3, 0.0, 555), base)
    mod = FusedSelfAttention(48, 3, dropout_rate=0.5).to(torch.bfloat16)
    y = torch.from_numpy(qkv[..., :48]).to(torch.bfloat16)
    mod.eval()
    first = mod(y)
    assert torch.equal(first, mod(y))


def test_module_train_dropout_draws_from_the_step_generator():
    mod = FusedSelfAttention(48, 3, dropout_rate=0.5).train()
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 9, 48)
                         .astype(np.float32))
    with pytest.raises(RuntimeError, match="dropout_rng"):
        mod(x)
    with dropout_rng(torch.Generator().manual_seed(5)):
        a = mod(x)
    with dropout_rng(torch.Generator().manual_seed(5)):
        b = mod(x)
    with dropout_rng(torch.Generator().manual_seed(6)):
        c = mod(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bad_dropout_probability_raises():
    qkv = torch.zeros((1, 3, 24))
    for p in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout probability"):
            mha_qkv(qkv, None, 2, p, 0)


@pytest.mark.parametrize("l,p,tiles", [(197, 0.0, 0), (197, 0.1, 13),
                                       (BWD_CHUNK, 0.1, 16),
                                       (BWD_CHUNK + 1, 0.1, 0),
                                       (577, 0.0, 0)])
def test_bwd_scratch_holds_stats_and_keep_bits(l, p, tiles):
    """The CUDA backward's scratch: a float4 of row statistics per (sample,
    head, row), then, with dropout and one chunk of keys, 8 words of keep
    bits per 16 x 16 tile (``csrc/attention_bwd.cuh`` dispatch)."""
    b, heads = 3, 2
    scratch = bwd_scratch(b, l, heads, p, "cpu")
    assert scratch.dtype == torch.float32 and scratch.is_contiguous()
    assert scratch.numel() == 4 * b * heads * l + 8 * b * heads * tiles ** 2
