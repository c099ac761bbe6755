"""Attention parity: the PyTorch port's plain versions and module against
the JAX package's kernels, oracle and module, on the packed-QKV route
(kernels 1-2) and the separate-q/k/v route (kernels 3-4, the module's route
under ``PLANKTON_ATTN_QKV_PACKED=0`` or ``PLANKTON_ATTN_STACKED=0``).

The CUDA kernel itself runs only on the card (``chip_smoke.py`` compares it
with ``mha_qkv_reference`` there); on the CPU the wrapper takes the plain
version. Tolerances: 1e-5 where both sides compute in f32 (same math,
another summation order); 5e-2 in bf16, the JAX suite's own bf16
attention tolerance (tests/test_attention.py).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.attention import (
    FusedSelfAttention as JaxFusedSelfAttention,
)
from multimodal_plankton_recognition_tpu.ops.pallas.attention import (
    mha_core, mha_core_qkv, mha_reference,
)
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    MAX_HEAD_DIM, MAX_LENGTH, _check_cuda_args, _launch_args,
    kernel_head_dim, mha, mha_bwd, mha_qkv, mha_qkv_reference, pad_heads,
    unpad_heads,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

SHAPES = [(3, 17, 48), (4, 21, 32)]  # (heads, L, E): head dims 16 and 8
# the edges of the Hopper forward's 16-key tiles, 16- and 128-row tiles and
# 256-key shared-memory chunks (577: three chunks), at head dims 24 and 64:
# the chain card kernel = plain version = JAX kernel where a tiled kernel
# breaks
EDGE_LENGTHS = (15, 16, 17, 63, 64, 65, 128, 129, 577)
EDGE_SHAPES = [(heads, l, heads * d) for l in EDGE_LENGTHS
               for heads, d in ((2, 24), (1, 64))]
SEPARATE_EDGE_SHAPES = [s for s in EDGE_SHAPES if s[1] in (17, 65, 129)]


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
@pytest.mark.parametrize("heads,l,e", SHAPES + EDGE_SHAPES)
def test_bf16_matches_jax_kernel_interpret(heads, l, e, masked):
    b = 3
    qkv = _qkv(b, l, e, seed=2)
    bias = _bias(_pad(b, l)) if masked else np.zeros((b, l), np.float32)
    want = jax.jit(lambda x, b: mha_core_qkv(
        x, b, jnp.zeros((), jnp.int32), heads, 0.0, False, True, masked))(
            jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias))
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


def test_cuda_admission_rules():
    """What ``_check_cuda_args`` lets through to the kernels, held on CPU
    tensors: a contiguous 16-byte-aligned base (the kernels copy 16 bytes
    a thread; 4-byte alignment, the old rule, is refused), at most
    ``MAX_LENGTH`` tokens (the 32-bit dropout counter) and head dims up to
    ``MAX_HEAD_DIM``, each refused with the rule in its message; and the
    padding route of a head dim that is not a multiple of 8: the repack's
    layout (each head's columns first, zeros to the next multiple of 8,
    q, k and v alike), its inverse, an operand off the 16-byte line or
    strided let through (the repack copies it), and the launch arguments
    (the kernels' head dim, the scale of the true one)."""
    b, l, heads, d = 2, 9, 3, 16
    n = b * l * 3 * heads * d
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    base = flat.data_ptr() % 16 // 2  # elements to the next 16-byte line
    start = (8 - base) % 8
    good = flat[start:start + n].view(b, l, 3 * heads * d)
    assert good.data_ptr() % 16 == 0
    assert _check_cuda_args(good, None, heads) == d
    for shift in (1, 2, 4):  # 2, 4 and 8 bytes off the line
        bad = flat[start + shift:start + shift + n].view(good.shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            _check_cuda_args(bad, None, heads)
    q = good.reshape(-1)[:b * l * heads * d].view(b, l, heads * d)
    assert _check_cuda_args(q, None, heads, parts=1) == d
    long = torch.zeros((1, MAX_LENGTH + 1, 3 * 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"MAX_LENGTH={MAX_LENGTH}"):
        _check_cuda_args(long, None, 1)
    at_limit = flat.new_zeros((1, MAX_LENGTH, 3 * 8))
    assert at_limit.data_ptr() % 16 == 0  # torch aligns its allocations
    assert _check_cuda_args(at_limit, None, 1) == 8
    # the dropout counter of the longest row stays within 32 bits
    assert MAX_LENGTH ** 2 <= 2 ** 32 - 1

    # head dims: every one up to MAX_HEAD_DIM, none above
    for d in (1, 20, 40, 100, MAX_HEAD_DIM):
        x = torch.zeros((2, 3, 3 * 2 * d), dtype=torch.bfloat16)
        assert _check_cuda_args(x, None, 2) == d
    wide = torch.zeros((2, 3, 3 * (MAX_HEAD_DIM + 8)), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"MAX_HEAD_DIM={MAX_HEAD_DIM}"):
        _check_cuda_args(wide, None, 1)
    assert [kernel_head_dim(d) for d in (8, 20, 24, 33, 250, 256)] == [
        8, 24, 24, 40, 256, 256]
    # past 256 the wide libraries' multiples of 64 up to 512, of 128 up
    # to MAX_HEAD_DIM
    assert MAX_HEAD_DIM == 1024
    assert [kernel_head_dim(d) for d in (257, 264, 300, 320, 321, 512, 513,
                                         600, 769, 1000, 1024)] == [
        320, 320, 320, 320, 384, 512, 640, 640, 896, 1024, 1024]

    # the padding route: d 20 runs as 24
    heads, d = 3, 20
    rs = np.random.RandomState(7)
    qkv = torch.from_numpy(rs.randn(b, l, 3 * heads * d).astype(
        np.float32)).to(torch.bfloat16)
    padded = pad_heads(qkv, 3, heads, d)
    assert padded.shape == (b, l, 3 * heads * 24) and padded.is_contiguous()
    assert padded.data_ptr() % 16 == 0
    blocks = padded.view(b, l, 3, heads, 24)
    assert torch.equal(blocks[..., :d],
                       qkv.view(b, l, 3, heads, d))  # q, k, v; each head
    assert not blocks[..., d:].any()  # the new columns are zero
    assert torch.equal(unpad_heads(padded, 3, heads, d), qkv)
    # the copy is what the kernels read, so the operand itself may be off
    # the 16-byte line or strided (one row of separate q, k and v)
    k = qkv.reshape(-1)[heads * d:2 * heads * d].view(1, 1, heads * d)
    assert k.data_ptr() % 16 and _check_cuda_args(k, None, heads, 1) == d
    assert pad_heads(k, 1, heads, d).data_ptr() % 16 == 0
    assert _check_cuda_args(qkv.transpose(0, 1), None, heads) == d
    same = torch.zeros((b, l, 3 * heads * 24), dtype=torch.bfloat16)
    assert pad_heads(same, 3, heads, 24) is same  # a multiple of 8: as is
    args = _launch_args(qkv, None, heads, 0.1, 5)
    assert args[:4] == (b, l, heads, 24)  # the kernels' head dim
    assert args[4] == pytest.approx(1 / np.sqrt(d), rel=1e-12)  # the true d


def _round_f32(x: Fraction) -> np.float32:
    """The exact rational ``x`` rounded once to float32, to nearest even
    (subnormals included)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if x < Fraction(2) ** e:
        e -= 1
    e = max(e, -126)
    scaled = x * Fraction(2) ** (23 - e)
    n = scaled.numerator // scaled.denominator
    rest = scaled - n
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and n % 2):
        n += 1
    return np.float32(sign * n * 2.0 ** (e - 23))


def _div_rn(a: np.float32, b: np.float32) -> np.float32:
    """``div_rn`` of csrc/mma.cuh: r = 1/b, q = a r, then
    q + (a - q b) r in two fused multiply-adds, each rounded once; a true
    divide below 2**-100."""
    if 0 < a < 2.0 ** -100:
        return a / b
    fa, fb = Fraction(float(a)), Fraction(float(b))
    r = _round_f32(1 / fb)
    q = _round_f32(fa * Fraction(float(r)))
    rem = _round_f32(fa - Fraction(float(q)) * fb)
    return _round_f32(Fraction(float(rem)) * Fraction(float(r))
                      + Fraction(float(q)))


def test_corrected_division_is_ieee_division():
    """The forward kernel divides exp(z - max) in [0, 1] by a row sum in
    [1, 65536) with one reciprocal per row and Markstein's correction;
    it must give IEEE division's bits: random pairs over the whole
    domain, the tiny values near the fallback, whole counts, and a = 1."""
    rs = np.random.RandomState(11)
    ones = np.float32(1.0).view(np.uint32)
    a = np.concatenate([
        rs.randint(0, ones + 1, 3000).astype(np.uint32).view(np.float32),
        np.float32(2.0) ** rs.uniform(-104, -80, 500).astype(np.float32),
        np.ones(500, np.float32), np.zeros(1, np.float32)])
    b = np.concatenate([
        (ones + rs.randint(0, 16 << 23, 3500).astype(np.uint32)
         ).view(np.float32),
        rs.randint(1, 65536, 501).astype(np.float32)])
    for x, y in zip(a, b):
        want = np.float32(x) / np.float32(y)
        assert _div_rn(x, y).view(np.uint32) == want.view(np.uint32), (x, y)


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


# ------------------------- kernels 3-4: separate q, k, v -------------------------

@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads,l,e", SHAPES + SEPARATE_EDGE_SHAPES)
def test_separate_qkv_matches_jax_mha_core(heads, l, e, masked, stacked):
    """``mha`` (plain versions of kernels 3 and 4 on the CPU) against the
    JAX ``mha_core`` in interpret mode, stacked and per-head, narrow (the
    module's mode): the output and jax.grad's dq, dk, dv, in bf16."""
    b = 3
    q, k, v = np.split(_qkv(b, l, e, seed=6), 3, axis=-1)
    bias = _bias(_pad(b, l)) if masked else np.zeros((b, l), np.float32)
    seed = jnp.zeros((), jnp.int32)

    def loss(q, k, v):
        o = mha_core(q, k, v, jnp.asarray(bias), seed, heads, 0.0, False,
                     True, True, masked, stacked)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jq, jk, jv)
    leaves = [torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
              for t in (q, k, v)]
    got = mha(*leaves, torch.from_numpy(bias) if masked else None, heads)
    got.float().square().sum().backward()
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)
    for name, leaf, g in zip("qkv", leaves, grads):
        g = np.asarray(g, np.float32)
        err = np.abs(leaf.grad.float().numpy() - g).max()
        assert err <= 5e-2 * max(1.0, np.abs(g).max()), (name, err)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_separate_qkv_is_the_packed_math(p):
    """``mha`` / ``mha_bwd`` on q, k, v equal ``mha_qkv`` and its backward
    on q|k|v bit for bit on the CPU, dropout bits included."""
    b, l, e, heads = 2, 13, 48, 3
    qkv = torch.from_numpy(_qkv(b, l, e, seed=7)).to(torch.bfloat16)
    bias = torch.from_numpy(_bias(_pad(b, l)))
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    assert torch.equal(mha(q, k, v, bias, heads, p, 9),
                       mha_qkv(qkv, bias, heads, p, 9))
    leaf = qkv.clone().requires_grad_()
    mha_qkv(leaf, bias, heads, p, 9).float().sum().backward()
    dout = torch.ones((b, l, e), dtype=torch.bfloat16)
    got = mha_bwd(q, k, v, bias, dout, heads, p, 9)
    assert torch.equal(torch.cat(got, dim=-1), leaf.grad)


def test_separate_qkv_wrapper_raises_off_cpu_and_cuda():
    q = torch.empty((2, 9, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        mha(q, q, q, None, 3)
    before = mha.launches, mha_bwd.launches
    x = torch.zeros((2, 9, 48), dtype=torch.bfloat16)
    mha(x, x, x, None, 3)
    assert (mha.launches, mha_bwd.launches) == before == (0, 0)


@pytest.mark.parametrize("variable", ["PLANKTON_ATTN_QKV_PACKED",
                                      "PLANKTON_ATTN_STACKED"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_unpacked_route_matches_packed_and_jax(dtype, variable,
                                                      monkeypatch):
    """``FusedSelfAttention`` with the variable at "0" takes the unpacked
    route (``mha`` on three projections of the same ``qkv`` parameters): it
    matches the packed route of the same module, and the JAX module under
    the same variable (tests/test_attention.py:372-389), on converted
    weights. Tolerances as above: 1e-5 in f32, 5e-2 in bf16."""
    import multimodal_plankton_recognition_torch.models.attention as module

    b, l, e, heads = 2, 33, 64, 4
    rs = np.random.RandomState(8)
    x = rs.randn(b, l, e).astype(np.float32)
    pad = _pad(b, l, seed=9)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = JaxFusedSelfAttention(num_heads=heads, dtype=jdtype)
    jx, jpad = jnp.asarray(x, jdtype), jnp.asarray(pad)
    variables = jmod.init(jax.random.key(0), jx, jpad)
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    mod = FusedSelfAttention(e, heads).to(tdtype)
    load_flax(mod, jax.tree.map(np.asarray, variables))
    tx, tpad = torch.from_numpy(x).to(tdtype), torch.from_numpy(pad)
    with torch.inference_mode():
        packed = mod(tx, tpad)
        monkeypatch.setenv(variable, "0")
        calls = []
        for name in ("mha", "mha_reference"):  # count the separate cores
            core = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, core=core, name=name:
                                calls.append(name) or core(*a))
        unpacked = mod(tx, tpad)
    # kernel 3's wrapper in bf16, its plain version in f32
    assert calls == ["mha" if dtype == "bfloat16" else "mha_reference"]
    want = np.asarray(jmod.apply(variables, jx, jpad), np.float32)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for got in (packed, unpacked):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(unpacked.float().numpy(),
                               packed.float().numpy(), rtol=tol, atol=tol)
