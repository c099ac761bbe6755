"""Attention past head dim 256, the shapes JAX's Pallas kernels take and
the port refused before: the port's plain attention against
``mha_core_qkv`` (interpret mode) at head dims 264 and 512; the padding
route at head dim 300 (to 320, the wide library's next instance) composed
with the plain versions, for kernels 1-2 and for the fused block 11-12;
and a profile transformer 512 wide with one head (d 512) on converted
weights against the JAX module.

On the card kernels 1-4 and 11-12 take every head dim up to 1,024
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``shapes`` phase
hold them to these plain versions there); on the CPU the wrappers take
the plain versions.

Tolerances are those of ``tests/test_torch_widths.py``: attention in bf16
against the JAX kernels, the forward 5e-2 and the backward 2e-2; the
module against the JAX module on its kernel route 5e-2 in bf16, and 5e-2
against its jnp fallback. The padding route adds zero columns to q, k
and v (nothing to q·kᵀ) and zero weights: the same as the plain version
up to the order of an f32 sum over the padded head dim, so within one
bf16 step (2⁻⁷) of max(1, max|·|) for attention, and the block's
forward within 1e-2 and 1e-3 relative L2, its gradients within 1e-4 of
their largest value (``tests/test_torch_block_widths.py``'s route check,
its 1e-5 widened for the padded sums).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.profile import (
    transformer as jax_transformer,
)
from multimodal_plankton_recognition_tpu.ops.pallas.attention import (
    mha_core_qkv,
)
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.models.profile.transformer import (
    ProfileTransformer,
)
from multimodal_plankton_recognition_torch.ops import attention as A
from multimodal_plankton_recognition_torch.ops import attention_block as ab
from test_torch_ffn import FALLBACK_TOL, MODULE_TOL, _close, jax_kernel_route
from torch_threads import one_thread  # noqa: F401  (autouse)

ATTN_FWD_TOL, ATTN_BWD_TOL = 5e-2, 2e-2


def _inputs(d, heads=1, b=2, l=17, seed=0):
    rs = np.random.RandomState(seed + d)
    qkv = rs.randn(b, l, 3 * heads * d).astype(np.float32)
    dout = rs.randn(b, l, heads * d).astype(np.float32)
    pad = rs.rand(b, l) < 0.3
    pad[:, 0] = False  # CLS is never masked
    return qkv, dout, np.where(pad, -1e9, 0.0).astype(np.float32)


@pytest.mark.parametrize("d,masked", [(264, True), (512, False)])
def test_plain_attention_matches_jax_kernel(d, masked):
    """Kernels 1-2's plain versions at head dims past 256, forward and
    backward, against JAX's ``mha_core_qkv`` (interpret mode) and its
    ``jax.grad``, one jitted compile."""
    heads = 1
    qkv, dout, bias = _inputs(d, heads)
    jbias, seed = jnp.asarray(bias), jnp.zeros((), jnp.int32)

    def loss(x):
        out = mha_core_qkv(x, jbias, seed, heads, 0.0, False, True, masked)
        return jnp.sum(out.astype(jnp.float32) * dout), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(qkv, jnp.bfloat16))
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    tbias = torch.from_numpy(bias) if masked else None
    out = A.mha_qkv(x, tbias, heads)
    grad = A.mha_qkv_bwd(x, tbias, torch.from_numpy(dout).to(torch.bfloat16),
                         heads)
    assert out.shape == want.shape and grad.shape == qkv.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=ATTN_FWD_TOL, atol=ATTN_FWD_TOL)
    np.testing.assert_allclose(grad.float().numpy(),
                               np.asarray(want_grad, np.float32),
                               rtol=ATTN_BWD_TOL, atol=ATTN_BWD_TOL)


def _one_step(got, want, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    top = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2.0 ** -7 * top, what


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_padding_route_equals_plain(p):
    """Head dim 300 on the card: ``pad_heads`` to 320, the kernels' math
    at 320 with the scale of 300, ``unpad_heads``; here with the plain
    versions in the kernels' place, against them at 300, forward and
    backward, the dropout bits those of (sample, head, row, key)."""
    heads, d = 2, 300
    dk = A.kernel_head_dim(d)
    assert dk == 320 and A.build.attention_unit("fwd", dk).endswith("d512")
    qkv, dout, bias = _inputs(d, heads, seed=5)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    tbias = torch.from_numpy(bias)
    g = torch.from_numpy(dout).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    padded = A.pad_heads(x, 3, heads, d)
    assert padded.shape[-1] == 3 * heads * dk
    out = A.unpad_heads(A.mha_qkv_reference(padded, tbias, heads, p, 9,
                                            scale), 1, heads, d)
    _one_step(out, A.mha_qkv_reference(x, tbias, heads, p, 9), "forward")
    grad = A.unpad_heads(A.mha_qkv_bwd_reference(
        padded, tbias, A.pad_heads(g, 1, heads, d), heads, p, 9, scale),
        3, heads, d)
    _one_step(grad, A.mha_qkv_bwd_reference(x, tbias, g, heads, p, 9),
              "backward")


def test_block_padding_route_equals_plain():
    """The fused block at (E, heads) (600, 2), head dim 300: ``pad_block``
    pads each head's weight rows and columns to 320 (E 600 needs none),
    the plain versions run at 320 with the scale of 300, and
    ``unpad_block_grads`` cuts the gradients back; against the plain
    versions at 300."""
    e, heads, b, l, p = 600, 2, 2, 9, 0.1
    assert ab.kernel_widths(e, heads) == (300, 320, 600)
    rs = np.random.RandomState(3)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32))

    x = rnd(b, l, e).to(torch.bfloat16)
    weights = (rnd(3 * e, e, scale=e ** -0.5), rnd(3 * e, scale=0.1),
               rnd(e, e, scale=e ** -0.5), rnd(e, scale=0.1))
    dy = rnd(b, l, e).to(torch.bfloat16)
    tbias = torch.from_numpy(np.where(rs.rand(b, l) < 0.3, -1e9, 0.0)
                             .astype(np.float32))
    tbias[:, 0] = 0.0
    px, *pw = ab.pad_block(x, *weights, heads)
    assert px is x and pw[0].shape == (3 * 640, e) and pw[2].shape == (e,
                                                                       640)
    scale = 1.0 / math.sqrt(300)
    y, qkv, o = ab.attn_block_reference(px, *pw, tbias, heads, p, 5,
                                        keep=True, scale=scale)
    want = ab.attn_block_reference(x, *weights, tbias, heads, p, 5)
    assert (y - want).float().abs().max() <= 1e-2
    assert (y - want).float().norm() <= 1e-3 * want.float().norm()
    grads = ab.unpad_block_grads(ab.attn_block_bwd_reference(
        px, *pw, tbias, dy, heads, p, 5, qkv=qkv, o=o, scale=scale), e,
        heads)
    for i, (g, w) in enumerate(zip(grads, ab.attn_block_bwd_reference(
            x, *weights, tbias, dy, heads, p, 5))):
        assert g.shape == w.shape and g.is_contiguous(), i
        if i == 0:  # dx, bf16
            _one_step(g, w, "dx")
        else:
            assert (g - w).abs().max() <= 1e-4 * w.abs().max(), i


def test_one_head_profile_transformer_matches_jax(monkeypatch):
    """The ``shapes`` card's profile encoder: 512 wide, one head (d 512),
    F 2,048, fused attention and FFN, bf16, on weights converted from the
    JAX module's: against the JAX module on its kernel routes (interpret
    mode) and as it runs on the CPU."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    args = dict(dim_hidden=512, target_size=16, num_head=1, num_layers=2,
                dim_feedforward=2048, fused_attention=True, fused_ffn=True)
    rs = np.random.RandomState(512)
    b, l = 3, 17
    profile = rs.randn(b, l, 6).astype(np.float32)
    time = np.tile(np.arange(l, dtype=np.int32), (b, 1))
    mask = np.zeros((b, l), bool)
    mask[1, 9:] = mask[2, 4:] = True
    plen = rs.randint(20, 400, (b, 1)).astype(np.int32)
    inputs = tuple(map(jnp.asarray, (profile, time, mask, plen)))
    jmod = jax_transformer.ProfileTransformer(**args, dtype=jnp.bfloat16)
    variables = jmod.init(jax.random.key(0), *inputs)
    with jax_kernel_route():
        want = jmod.apply(variables, *inputs)
    fallback = jmod.apply(variables, *inputs)
    model = ProfileTransformer(**args).to(torch.bfloat16).eval()
    load_flax(model, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (profile, time, mask, plen)))
    assert got.dtype == torch.bfloat16
    _close(got, want, MODULE_TOL["bfloat16"], "kernel route")
    _close(got, fallback, FALLBACK_TOL, "fallback")
