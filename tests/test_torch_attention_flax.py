"""``FusedSelfAttention(fused=False)``: the port of flax
``nn.MultiHeadDotProductAttention``, which the JAX encoders run when
``fused_attention`` is off (``models/image/vit.py:38-48``,
``models/profile/transformer.py:53-69`` of the JAX package).

Eval parity on converted weights at L 225 with key padding, alone and
through one ViT block and one ProfileTransformer layer. Tolerances: 1e-5
in f32 (the same math, another summation order); in bf16 4e-3 for the
module alone (flax and the port round q/√D, the scores, every softmax op,
p and the output at the same points, so an output lands at most about one
bf16 step apart: 2e-3 measured; the kernels' composition, with its f32
softmax, falls outside it, which the test asserts) and 5e-2 of max(1,
|output|) through a block or layer, whose LayerNorms and FFN add bf16
steps (the JAX suite's bf16 module tolerance). Train mode: flax draws
one (L, L) keep mask per call and broadcasts it over batch and heads
(``broadcast_dropout=True``); the port's mask comes from the step's
generator, so it is held by structure, not bits.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.image import vit as jax_vit
from multimodal_plankton_recognition_tpu.models.profile import (
    transformer as jax_transformer,
)
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.models.dropout import dropout_rng
from multimodal_plankton_recognition_torch.models.image.vit import ViT
from multimodal_plankton_recognition_torch.models.profile.transformer import (
    ProfileTransformer,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

ALONE_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _pad(b, l, rs):
    pad = rs.rand(b, l) < 0.3
    pad[:, 0] = False  # CLS is never masked
    return pad


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_flax_mha(dtype, masked):
    b, l, e, h = 2, 225, 64, 4
    rs = np.random.RandomState(0)
    x = rs.randn(b, l, e).astype(np.float32)
    pad = _pad(b, l, rs)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = fnn.MultiHeadDotProductAttention(num_heads=h, dtype=jdt,
                                            deterministic=True)
    jx = jnp.asarray(x, jdt)
    mask = jnp.asarray(~pad)[:, None, None, :] if masked else None
    variables = jmod.init(jax.random.key(0), jx, jx, jx, mask=mask)
    want = np.asarray(jmod.apply(variables, jx, jx, jx, mask=mask),
                      np.float32)
    mod = FusedSelfAttention(e, h, fused=False).to(tdt)
    load_flax(mod, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x).to(tdt),
                  torch.from_numpy(pad) if masked else None)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ALONE_TOL[dtype])
    if dtype == "bfloat16" and masked:  # the bound tells the routes apart
        kernel_math = FusedSelfAttention(e, h).to(tdt)
        kernel_math.load_state_dict(mod.state_dict())
        with torch.inference_mode():
            other = kernel_math(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(pad))
        assert np.abs(other.float().numpy() - want).max() > ALONE_TOL[dtype]


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_block_matches_jax(dtype):
    """A one-block ViT with ``fused_attention: false``."""
    kw = dict(img_size=32, depth=1, embed_dim=48, num_heads=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    image = np.random.RandomState(1).randn(2, 32, 32, 1).astype(np.float32)
    jmod = jax_vit.ViT(**kw, dtype=jdt)
    variables = jmod.init(jax.random.key(0), jnp.asarray(image))
    want = jmod.apply(variables, jnp.asarray(image))
    model = ViT(**kw).to(tdt).eval()
    load_flax(model, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(image))
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_layer_matches_jax(dtype):
    """A one-layer ProfileTransformer at 225 tokens with padding."""
    args = dict(dim_hidden=64, target_size=224, num_head=4, num_layers=1,
                dim_feedforward=96)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rs = np.random.RandomState(2)
    b, l = 2, 225
    profile = rs.randn(b, l, 6).astype(np.float32)
    time = np.tile(np.arange(l, dtype=np.int32), (b, 1))
    mask = np.zeros((b, l), bool)
    mask[0, 150:] = mask[1, 40:] = True
    plen = rs.randint(20, 400, (b, 1)).astype(np.int32)
    inputs = tuple(map(jnp.asarray, (profile, time, mask, plen)))
    jmod = jax_transformer.ProfileTransformer(**args, dtype=jdt)
    variables = jmod.init(jax.random.key(0), *inputs)
    want = jmod.apply(variables, *inputs)
    model = ProfileTransformer(**args).to(tdt).eval()
    load_flax(model, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (profile, time, mask, plen)))
    _close(got, want, LAYER_TOL[dtype])


def _train(mod, x, seed=0):
    with dropout_rng(torch.Generator().manual_seed(seed)), \
            torch.inference_mode():
        return mod.train()(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_mask_for_every_sample(dtype):
    """Two identical samples of a batch give identical outputs under
    dropout 0.5: one mask for the batch. The kernels' math draws one per
    (sample, head), so there they differ."""
    torch.manual_seed(0)
    x = torch.randn((1, 17, 48)).expand(2, -1, -1).to(dtype)
    mod = FusedSelfAttention(48, 3, fused=False, dropout_rate=0.5).to(dtype)
    y = _train(mod, x)
    assert torch.equal(y[0], y[1])
    assert not torch.equal(y, mod.eval()(x))
    kernel = FusedSelfAttention(48, 3, dropout_rate=0.5).to(dtype)
    kernel.load_state_dict(mod.state_dict())
    yk = _train(kernel, x)
    assert not torch.equal(yk[0], yk[1])


def test_one_mask_for_every_head():
    """Heads made identical (each head's q, k, v rows the same, ``out`` the
    identity) agree under dropout 0.5: one mask for all heads."""
    e, h, d = 48, 3, 16
    mod = FusedSelfAttention(e, h, fused=False, dropout_rate=0.5)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        block = torch.randn((3, d, e), generator=gen) / e ** 0.5
        mod.qkv.weight.copy_(block.repeat_interleave(h, dim=0)
                             .reshape(3, h, d, e).reshape(3 * e, e))
        mod.qkv.bias.zero_()
        mod.out.weight.copy_(torch.eye(e))
        mod.out.bias.zero_()
    x = torch.randn((2, 17, e), generator=gen)
    y = _train(mod, x).reshape(2, 17, h, d)
    for i in range(1, h):
        assert torch.equal(y[..., i, :], y[..., 0, :])
    assert not torch.equal(y, mod.eval()(x).reshape(2, 17, h, d))


def test_keep_share_and_scale():
    """The shared mask keeps 1 - p of the (L, L) probabilities (within 4
    sigma) and scales kept ones by 1/(1-p): with q = k = 0 and v = 1 each
    output is (kept keys of its row) / (L (1-p)), the same for every
    sample, head and column."""
    e, h, l, p = 16, 2, 64, 0.25
    mod = FusedSelfAttention(e, h, fused=False, dropout_rate=p)
    with torch.no_grad():
        mod.qkv.weight.zero_()
        mod.qkv.bias.copy_(torch.cat([torch.zeros(2 * e), torch.ones(e)]))
        mod.out.weight.copy_(torch.eye(e))
        mod.out.bias.zero_()
    y = _train(mod, torch.zeros((3, l, e)), seed=4)
    kept = y * l * (1 - p)
    assert torch.allclose(kept, kept.round(), atol=1e-4)
    assert torch.equal(y, y[:1, :, :1].expand_as(y))
    share = 1 - kept[0, :, 0].sum().item() / (l * l)
    assert abs(share - p) <= 4 * (p * (1 - p) / (l * l)) ** 0.5
