"""The fused attention block (kernels 11-12) at widths past the shipped
cards' four (E, heads): the port's plain versions against the JAX
package's ``attn_block`` (its Pallas kernel in interpret mode) and its
``FusedSelfAttention`` on the block route, and the wrapper's padding
route, which the CUDA kernels see, composed with the plain versions.

Shapes: (60, 3) (head dim 20, E not a multiple of 8: x padded to 64 on
the card), (160, 8) (d 20, padded to 24), (96, 1) (d 96) and (512, 4) (d
128, whose dx product has K 1,536: the streamed GEMM on the card), B 2,
L at most 33, the forward with key padding and without, the gradients
with it at two shapes and without at two. Tolerances are
``tests/test_torch_attention_block.py``'s: the bf16 forward within 1e-2
and 1e-3 relative L2 (one bf16 step where two orders of summation land
on either side of a rounding), f32 gradients within 1e-5 of their
tensor's largest |value| (the key bias's, zero in exact arithmetic,
below 1e-4 of the largest bias gradient), the module route 5e-2 in bf16
(the JAX suite's own). The padding route (each head's weight rows and
columns zero-padded to the next multiple of 8, E to a multiple of 8, the
softmax scale the true head dim's) equals the unpadded plain version
within the forward's tolerance, its gradients within 1e-5. A head dim
past 256 is taken (padded to the wide library's next multiple of 64);
one above ``MAX_HEAD_DIM`` is refused before any launch.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_plankton_recognition_tpu.models.attention import (
    FusedSelfAttention as JaxFusedSelfAttention,
)
from multimodal_plankton_recognition_tpu.ops.pallas.experimental.attention_block import (  # noqa: E501
    attn_block as jax_attn_block,
)
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.models import attention as module
from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.ops import attention_block as ab
from multimodal_plankton_recognition_torch.ops import hopper_gemm
from multimodal_plankton_recognition_torch.ops.attention import MAX_HEAD_DIM
from torch_threads import one_thread  # noqa: F401  (autouse)

JAX_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
# (E, heads, L): d 20 with E 60, d 20 with E 160, d 96, d 128
WIDE_BLOCKS = [(60, 3, 17), (160, 8, 17), (96, 1, 33), (512, 4, 17)]
# the gradients' cases: each shape once, with key padding on two of them
# (each interpret-mode jax.grad compiles anew; the file stays near its
# budget of a minute under six workers)
WIDE_GRADS = [(60, 3, 17, True), (160, 8, 17, False), (96, 1, 33, True),
              (512, 4, 17, False)]


def _inputs(b, l, e, masked, seed):
    """x, the JAX kernel's weights (E, E) and biases (E,), and a key bias
    with random padding (CLS kept) or None."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, l, e).astype(np.float32)
    ws = {n: (rs.randn(e, e) / np.sqrt(e)).astype(np.float32)
          for n in ("wq", "wk", "wv", "wo")}
    ws.update({n: (rs.randn(e) * 0.1).astype(np.float32)
               for n in ("bq", "bk", "bv", "bo")})
    pad = rs.rand(b, l) < 0.3
    pad[:, 0] = False
    bias = np.where(pad, -1e9, 0.0).astype(np.float32) if masked else None
    return x, ws, bias


def _port_weights(ws):
    return tuple(map(torch.from_numpy, (
        np.concatenate([ws["wq"].T, ws["wk"].T, ws["wv"].T]),
        np.concatenate([ws["bq"], ws["bk"], ws["bv"]]),
        np.ascontiguousarray(ws["wo"].T), ws["bo"])))


def _jax_block(x, ws, bias, heads):
    b, l, _ = x.shape
    rows = jnp.zeros((b, l), jnp.float32) if bias is None else \
        jnp.asarray(bias)
    return jax_attn_block(x, *(jnp.asarray(ws[n]) for n in JAX_NAMES), rows,
                          jnp.zeros((), jnp.int32), heads, 0.0, False, True,
                          bias is not None)


def _torch_bias(bias):
    return None if bias is None else torch.from_numpy(bias)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("e,heads,l", WIDE_BLOCKS)
def test_plain_forward_matches_jax_kernel(e, heads, l, masked):
    """bf16, B 2: the plain block against the interpret kernel."""
    x, ws, bias = _inputs(2, l, e, masked, seed=e + heads)
    want = np.asarray(_jax_block(jnp.asarray(x, jnp.bfloat16), ws, bias,
                                 heads), np.float32)
    got = ab.attn_block_reference(torch.from_numpy(x).to(torch.bfloat16),
                                  *_port_weights(ws), _torch_bias(bias),
                                  heads)
    assert got.dtype == torch.bfloat16 and got.shape == (2, l, e)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 1e-2
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


@pytest.mark.parametrize("e,heads,l,masked", WIDE_GRADS)
def test_plain_backward_matches_jax_grad(e, heads, l, masked):
    """f32, B 2: dx and the eight weight and bias gradients of sum(y²)
    from the plain backward against ``jax.grad`` of the interpret
    kernel."""
    x, ws, bias = _inputs(2, l, e, masked, seed=2 * e + heads)

    def loss(x, *w):
        out = _jax_block(x, dict(zip(JAX_NAMES, w)), bias, heads)
        return jnp.sum(out ** 2)

    grads = jax.grad(loss, argnums=tuple(range(9)))(
        jnp.asarray(x), *(jnp.asarray(ws[n]) for n in JAX_NAMES))
    want = dict(zip(("x",) + JAX_NAMES, map(np.asarray, grads)))
    tx, weights, tbias = torch.from_numpy(x), _port_weights(ws), \
        _torch_bias(bias)
    dy = 2 * ab.attn_block_reference(tx, *weights, tbias, heads)
    dx, dwqkv, dbqkv, dwo, dbo = ab.attn_block_bwd_reference(
        tx, *weights, tbias, dy, heads)
    q, k, v = (slice(i * e, (i + 1) * e) for i in range(3))
    got = {"x": dx, "wq": dwqkv[q].T, "wk": dwqkv[k].T, "wv": dwqkv[v].T,
           "bq": dbqkv[q], "bk": dbqkv[k], "bv": dbqkv[v], "wo": dwo.T,
           "bo": dbo}
    largest_bias = max(np.abs(want[n]).max() for n in ("bq", "bv", "bo"))
    for name, g in got.items():
        g = g.numpy()
        if name == "bk":  # zero in exact arithmetic
            assert np.abs(g).max() <= 1e-4 * largest_bias
            assert np.abs(want[name]).max() <= 1e-4 * largest_bias
        else:
            err = np.abs(g - want[name]).max()
            assert err <= 1e-5 * np.abs(want[name]).max(), (name, err)


@pytest.mark.parametrize("e,heads", [(160, 8), (512, 4)])
def test_module_route_matches_jax_module(e, heads, monkeypatch):
    """``FusedSelfAttention`` under ``PLANKTON_ATTN_FUSE_PROJ=1`` in bf16
    and eval on weights converted by ``convert.from_flax``, key padding:
    the block (its plain version on the CPU) against the JAX module's
    interpret kernel."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    monkeypatch.setenv("PLANKTON_ATTN_FUSE_PROJ", "1")
    b, l = 2, 17
    rs = np.random.RandomState(e)
    x = rs.randn(b, l, e).astype(np.float32)
    pad = rs.rand(b, l) < 0.25
    pad[:, 0] = False
    jmod = JaxFusedSelfAttention(num_heads=heads, dtype=jnp.bfloat16)
    jx, jpad = jnp.asarray(x, jnp.bfloat16), jnp.asarray(pad)
    variables = jmod.init(jax.random.key(0), jx, jpad)
    want = np.asarray(jmod.apply(variables, jx, jpad), np.float32)
    mod = FusedSelfAttention(e, heads).to(torch.bfloat16)
    load_flax(mod, jax.tree.map(np.asarray, variables))
    calls = []
    monkeypatch.setattr(module, "attn_block",
                        lambda *a: calls.append(1) or ab.attn_block(*a))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(pad))
    assert calls == [1]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("e,heads", [(60, 3), (160, 8), (36, 2), (96, 1)])
def test_padding_route_composed_with_the_plain_versions(e, heads, p):
    """The weights as the kernels take them (``pad_block``: d' the next
    multiple of 8, E₈ where E is not one), through the plain versions at
    d' with the true head dim's scale, then ``unpad_block_grads``: y
    within the forward's tolerance of the unpadded plain version, every
    gradient within 1e-5 of its largest |value|, in f32 with key padding
    and dropout (the mask depends on B, heads and L only). Where nothing
    needs padding the route hands back the same tensors (no copy)."""
    b, l = 2, 19
    x, ws, bias = _inputs(b, l, e, True, seed=e + 7)
    tx, weights, tbias = torch.from_numpy(x), _port_weights(ws), \
        _torch_bias(bias)
    dy = torch.from_numpy(np.random.RandomState(e).randn(b, l, e)
                          .astype(np.float32))
    d, dk, ek = ab.kernel_widths(e, heads)
    assert (dk, ek) == (-(-d // 8) * 8, -(-e // 8) * 8)
    px, *pw = ab.pad_block(tx, *weights, heads)
    assert px.shape == (b, l, ek)
    assert [tuple(t.shape) for t in pw] == [
        (3 * heads * dk, ek), (3 * heads * dk,), (ek, heads * dk), (ek,)]
    scale = 1.0 / math.sqrt(d)
    y, qkv, o = ab.attn_block_reference(px, *pw, tbias, heads, p, 5,
                                        keep=True, scale=scale)
    want = ab.attn_block_reference(tx, *weights, tbias, heads, p, 5)
    assert qkv.shape == (b, l, 3 * heads * dk) and o.shape == (b, l,
                                                               heads * dk)
    if ek > e:  # zero weight rows and bias past E: zero columns of y
        assert float(y[..., e:].abs().max()) == 0.0
    got = y[..., :e]
    assert (got - want).abs().max() <= 1e-2
    assert (got - want).norm() <= 1e-3 * want.norm()
    padded = ab.attn_block_bwd_reference(px, *pw, tbias,
                                         F.pad(dy, (0, ek - e)), heads, p, 5,
                                         qkv=qkv, o=o, scale=scale)
    grads = ab.unpad_block_grads(padded, e, heads)
    for i, (g, w) in enumerate(zip(grads, ab.attn_block_bwd_reference(
            tx, *weights, tbias, dy, heads, p, 5))):
        assert g.shape == w.shape and g.is_contiguous(), i
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), i
    if (dk, ek) == (d, e):
        assert px is tx and all(a.is_set_to(b_)
                                for a, b_ in zip(pw, weights))


def test_head_dim_above_the_limit_is_refused():
    """A head dim of 264, past the old limit of 256, is taken: the kernels
    run it at 320 (``kernel_widths``), the wide library's next head dim.
    One past ``MAX_HEAD_DIM`` (1,032) is refused by the wrappers' checks,
    with the limit in the message, before any launch; the plain versions
    on the CPU still take it."""
    def block(e):
        return (torch.zeros((1, 3, e), dtype=torch.bfloat16),
                (torch.zeros(3 * e, e), torch.zeros(3 * e),
                 torch.zeros(e, e), torch.zeros(e)))

    x, weights = block(264)
    assert ab.kernel_widths(264, 1) == (264, 320, 264)
    *_, (b, l, ek, h, dk, scale), _ = ab._prep(x, *weights, None, 1, 0.0)
    assert (ek, h, dk) == (264, 1, 320) and scale == 1.0 / math.sqrt(264)
    assert MAX_HEAD_DIM == 1024
    x, weights = block(MAX_HEAD_DIM + 8)
    before = ab.attn_block_fwd.launches, ab.attn_block_bwd.launches
    with pytest.raises(ValueError, match=f"MAX_HEAD_DIM={MAX_HEAD_DIM}"):
        ab._prep(x, *weights, None, 1, 0.0)
    assert (ab.attn_block_fwd.launches, ab.attn_block_bwd.launches) == before
    assert ab.attn_block_fwd(x, *weights, None, 1).shape == x.shape
    with pytest.raises(ValueError, match="must divide"):
        ab._prep(x, *weights, None, 5, 0.0)


@pytest.mark.parametrize("n,k,route", [
    (576, 192, 192), (192, 576, 64), (512, 1536, -128), (768, 2304, -128),
    (1024, 3072, -128), (3072, 1024, 64), (64, 1152, 64), (40, 1152, 64),
    (64, 1160, -64), (200, 3072, -64), (20, 64, 0), (64, 20, 0)])
def test_gemm_route_streams_only_past_the_resident_k(n, k, route):
    """``gemm_route`` (the header's rule, mirrored): a resident weight slice
    wherever it leaves 4 ring stages, which holds for every K up to 1,152
    at 64 columns (the shipped shapes' routes), the streamed slice above
    it (128 columns where they divide N), nothing for widths TMA cannot
    read."""
    assert hopper_gemm.gemm_route(n, k) == route
    if 0 < k <= 1152 and k % 8 == 0 and n % 8 == 0:
        assert route > 0


@pytest.mark.parametrize("e,heads", [(60, 3), (160, 8), (512, 4),
                                     (600, 2), (1024, 1)])
def test_block_unit_holds_the_kernels_head_dim(e, heads):
    """The wrapper loads the block library whose range of head dims holds
    d' (``csrc/attention_block.cu`` built once per range and step; past
    256 the wide library's multiples of 64)."""
    from multimodal_plankton_recognition_torch.ops import build

    _, dk, _ = ab.kernel_widths(e, heads)
    unit = build.attention_unit("block", dk)
    source, flags = build.UNITS.get(unit, (unit, ()))
    assert source == "attention_block"
    lo, hi, step = ((8, 64, 8) if not flags else
                    tuple(int(f.split("=")[1]) for f in flags))
    assert lo <= dk <= hi and (dk - lo) % step == 0
