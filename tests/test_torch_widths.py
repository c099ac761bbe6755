"""Head dims and widths past the shipped cards': the port's plain attention
and FFN against the JAX package's Pallas kernels in interpret mode, and a
profile transformer 512 wide with 4 heads of 128 (and one 160 wide with 8
heads of 20) on converted weights against the JAX module, alone and in one
train step of a small CLIP card.

On the card the kernels take every head dim up to 256 (those that are not
a multiple of 8 through the padding route) and every width (E padded to a
multiple of 64); ``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s
``widths`` phase hold them to these plain versions there. On the CPU the
wrappers take the plain versions.

Tolerances are those of the existing tests at the same dtype:

* attention, bf16 against the JAX kernels in interpret mode: the forward
  5e-2 (``tests/test_torch_attention.py``), the backward 2e-2
  (``tests/test_torch_attention_bwd.py``);
* FFN against the JAX ``ffn_core`` in interpret mode, bf16 x: the output
  and every gradient within 1e-2 of its largest value, one bf16 step
  (``tests/test_torch_ffn.py``'s bf16 output bound), and each gradient
  within 2e-3 relative L2 (``FFN_REL_TOL``, the card's kernel-vs-plain
  bound). Past E 64 the two sides sum x . w1 and dy . w2^T in another
  order (XLA's and torch's f32 dots), so a few h_pre and dpre values round
  to the neighbouring bf16 value and move dx and the weight gradients by
  that step (measured: up to 5.5e-3 of the largest, 4.6e-4 relative L2,
  at E 512; exactly 0 and 1e-7 at E 64, where ``tests/test_torch_ffn.py``
  holds them to 1e-4);
* modules against the JAX modules on their kernel routes: f32 1e-4, bf16
  5e-2, and 5e-2 against the JAX fallback (``tests/test_torch_ffn.py``);
* the card's train step in bf16: the loss 2e-3 relative, the median update
  5e-2 and every update 0.3 (``tests/test_torch_train.py``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.config import (
    OptimConfig as JaxOptimConfig,
)
from multimodal_plankton_recognition_tpu.models.multi import (
    MultiModel as JaxMultiModel,
)
from multimodal_plankton_recognition_tpu.models.profile import (
    transformer as jax_transformer,
)
from multimodal_plankton_recognition_tpu.ops.pallas.attention import (
    mha_core, mha_core_qkv,
)
from multimodal_plankton_recognition_tpu.train.loop import (
    make_multi_steps as jax_make_multi_steps,
)
from multimodal_plankton_recognition_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
)
from multimodal_plankton_recognition_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_plankton_recognition_torch.config import OptimConfig
from multimodal_plankton_recognition_torch.convert import from_flax, load_flax
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.models.profile.transformer import (
    ProfileTransformer,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    mha, mha_bwd, mha_qkv, mha_qkv_bwd,
)
from multimodal_plankton_recognition_torch.ops.ffn import ffn_core
from multimodal_plankton_recognition_torch.ops.losses import l2_normalize
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_optimizer,
)
from test_torch_ffn import (
    FALLBACK_TOL, MODULE_TOL, OP_FWD_TOL, _close, _flagship_batch,
    _jax_kernel, _setup, jax_kernel_route,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

HEAD_DIMS = (20, 40, 80, 128)
WIDTHS = (96, 160, 512)
ATTN_FWD_TOL, ATTN_BWD_TOL = 5e-2, 2e-2
GRAD_REL_L2_TOL = 2e-3
# (dim_hidden, num_head, dim_feedforward): 4 heads of 128 with the card's
# F 2,048, and 8 heads of 20 (the padding route on the card) with F 4 E
PROFILES = [(512, 4, 2048), (160, 8, 640)]
PROFILE_IDS = ["512x4", "160x8"]
BF16_LOSS_TOL, BF16_MEDIAN_TOL, BF16_UPDATE_TOL = 2e-3, 5e-2, 0.3


def _attention_inputs(d, masked, heads=2, b=2, l=33, seed=0):
    rs = np.random.RandomState(seed + d)
    qkv = rs.randn(b, l, 3 * heads * d).astype(np.float32)
    dout = rs.randn(b, l, heads * d).astype(np.float32)
    pad = rs.rand(b, l) < 0.3
    pad[:, 0] = False  # CLS is never masked
    bias = np.where(pad & masked, -1e9, 0.0).astype(np.float32)
    return qkv, dout, bias


@pytest.mark.parametrize("route", ["packed", "separate"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_attention_matches_jax_kernel(d, masked, route):
    """Kernels 1-2 (packed: ``mha_core_qkv``) and 3-4 (separate q, k, v:
    ``mha_core``) at head dims 20-128: the forward and ``jax.grad`` through
    the JAX kernels in interpret mode against the port's plain versions."""
    heads = 2
    qkv, dout, bias = _attention_inputs(d, masked, heads)
    jbias, seed = jnp.asarray(bias), jnp.zeros((), jnp.int32)

    def jax_fwd(x):
        if route == "packed":
            return mha_core_qkv(x, jbias, seed, heads, 0.0, False, True,
                                masked)
        q, k, v = jnp.split(x, 3, axis=-1)
        return mha_core(q, k, v, jbias, seed, heads, 0.0, False, True,
                        has_bias=masked)

    jx = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(jax.jit(jax_fwd)(jx), np.float32)
    want_grad = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(
        jax_fwd(x).astype(jnp.float32) * dout)))(jx), np.float32)

    x = torch.from_numpy(qkv).to(torch.bfloat16)
    tbias = torch.from_numpy(bias) if masked else None
    g = torch.from_numpy(dout).to(torch.bfloat16)
    if route == "packed":
        out = mha_qkv(x, tbias, heads)
        grad = mha_qkv_bwd(x, tbias, g, heads)
    else:
        parts = [t.contiguous() for t in x.chunk(3, dim=-1)]
        out = mha(*parts, tbias, heads)
        grad = torch.cat(mha_bwd(*parts, tbias, g, heads), dim=-1)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    np.testing.assert_allclose(out.float().numpy(), want,
                               rtol=ATTN_FWD_TOL, atol=ATTN_FWD_TOL)
    assert grad.shape == qkv.shape
    np.testing.assert_allclose(grad.float().numpy(), want_grad,
                               rtol=ATTN_BWD_TOL, atol=ATTN_BWD_TOL)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("e", WIDTHS)
def test_plain_ffn_matches_jax_kernel_fwd(e, activation):
    """Widths past the shipped ones (96 and 160 not multiples of 64, 512
    above 384), F = 4 E, odd L, bf16 x."""
    x, w1, b1, w2, b2 = _setup(2, 29, e, 4 * e, seed=e)
    want = np.asarray(_jax_kernel(jnp.asarray(x, jnp.bfloat16), w1, b1, w2,
                                  b2, activation), np.float32)
    got = ffn_core(torch.from_numpy(x).to(torch.bfloat16),
                   *map(torch.from_numpy, (w1, b1, w2, b2)), activation)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    top = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= \
        OP_FWD_TOL["bfloat16"] * top


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("e", WIDTHS)
def test_plain_ffn_matches_jax_kernel_grad(e, activation):
    """``ffn_core``'s backward against ``jax.grad`` through the JAX
    kernels, at the same widths."""
    x, w1, b1, w2, b2 = _setup(2, 29, e, 4 * e, seed=e + 1)
    jx = jnp.asarray(x, jnp.bfloat16)

    def loss(*args):
        return jnp.sum(_jax_kernel(*args, activation).astype(jnp.float32)
                       ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        jx, *map(jnp.asarray, (w1, b1, w2, b2)))
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()]
    leaves += [torch.from_numpy(a).requires_grad_() for a in (w1, b1, w2, b2)]
    ffn_core(*leaves, activation).float().square().sum().backward()
    for name, leaf, w in zip(("x", "w1", "b1", "w2", "b2"), leaves, want):
        w = np.asarray(w, np.float32)
        assert leaf.grad.shape == w.shape, name
        g = leaf.grad.float().numpy()
        err = np.abs(g - w).max()
        assert err <= OP_FWD_TOL["bfloat16"] * np.abs(w).max(), (name, err)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL_L2_TOL, (name, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,heads,ff", PROFILES, ids=PROFILE_IDS)
def test_profile_transformer_matches_jax(dim, heads, ff, dtype, monkeypatch):
    """The profile transformer at the widths, ``fused_ffn`` and fused
    attention, on weights converted from the JAX module's: against the
    JAX module on its kernel routes (interpret mode) and as it runs on the
    CPU."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = dict(dim_hidden=dim, target_size=16, num_head=heads, num_layers=2,
                dim_feedforward=ff, fused_attention=True, fused_ffn=True)
    rs = np.random.RandomState(dim)
    b, l = 3, 17
    profile = rs.randn(b, l, 6).astype(np.float32)
    time = np.tile(np.arange(l, dtype=np.int32), (b, 1))
    mask = np.zeros((b, l), bool)
    mask[1, 9:] = mask[2, 4:] = True
    plen = rs.randint(20, 400, (b, 1)).astype(np.int32)
    inputs = tuple(map(jnp.asarray, (profile, time, mask, plen)))
    jmod = jax_transformer.ProfileTransformer(**args, dtype=jdt)
    variables = jax.jit(lambda key: jmod.init(key, *inputs))(
        jax.random.key(0))
    with jax_kernel_route():
        want = jax.jit(jmod.apply)(variables, *inputs)
    fallback = jax.jit(jmod.apply)(variables, *inputs)
    model = ProfileTransformer(**args).to(tdt).eval()
    load_flax(model, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (profile, time, mask, plen)))
    assert got.dtype == tdt
    _close(got, want, MODULE_TOL[dtype], "kernel route")
    _close(got, fallback, FALLBACK_TOL, "fallback")


def _card_args(dim, heads, ff):
    """A small bf16 CLIP card around the profile transformer at the
    widths: a 2-layer ViT 48 wide at 32 px, dropout 0 everywhere, fused
    attention and FFN in both towers."""
    return dict(
        dim_embed=32,
        image_encoder_args={
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "fused_ffn": True, "dropout": 0.0,
            "backbone_kwargs": {"img_size": 32, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        profile_encoder_args={
            "kind": "transformer", "dim_in": 6, "dim_hidden": dim,
            "num_layers": 2, "num_head": heads, "target_size": 16,
            "dim_feedforward": ff, "fused_attention": True,
            "fused_ffn": True, "dropout": 0.0},
        coordination_args={"method": "clip", "fused": True})


@functools.cache
def _jax_card_run(dim, heads, ff):
    """The JAX card in bf16 on its kernel routes (interpret mode): initial
    parameters, the encode of batch 1, and (loss, parameters) after one
    train step on batch 0, in the port's names."""
    args = _card_args(dim, heads, ff)
    old = os.environ.get("PLANKTON_FUSED_INTERPRET")
    os.environ["PLANKTON_FUSED_INTERPRET"] = "1"
    try:
        with jax_kernel_route():
            model = JaxMultiModel(dtype=jnp.bfloat16, **args)
            tx = jax_make_optimizer(JaxOptimConfig())
            batch = {k: jnp.asarray(v) for k, v in _flagship_batch(0).items()}
            state = jax.jit(lambda key: jax_create_train_state(
                model, key, batch, tx, init_kwargs={"buckets": 2}))(
                    jax.random.key(0))
            init = jax.tree.map(np.asarray, state.params)
            emb = jax.jit(lambda params, b: model.apply(
                {"params": params}, method="encode", train=False, **b))(
                    state.params, {k: jnp.asarray(v) for k, v in
                                   _flagship_batch(1).items()})
            train_step, _ = jax_make_multi_steps(model, tx, buckets=2)
            state, loss = train_step(state, batch, jax.random.key(1))
    finally:
        if old is None:
            os.environ.pop("PLANKTON_FUSED_INTERPRET")
        else:
            os.environ["PLANKTON_FUSED_INTERPRET"] = old
    after = from_flax({"params": jax.tree.map(np.asarray, state.params)})
    return (init, {k: np.asarray(v, np.float32) for k, v in emb.items()},
            float(loss), after)


@pytest.mark.parametrize("dim,heads,ff", PROFILES, ids=PROFILE_IDS)
def test_card_encode_and_train_step_match_jax(dim, heads, ff):
    """The card on converted weights: the encode (both towers' unit
    embeddings) and one train step (the loss and every master's update)
    against the JAX card's; the profile encoder's own tensors held to the
    median bound too."""
    init, want_emb, jloss, jparams = _jax_card_run(dim, heads, ff)
    args = _card_args(dim, heads, ff)
    model = MultiModel(dtype=torch.bfloat16, **args)
    load_flax(model, {"params": init})
    model.eval()
    with torch.inference_mode():
        emb = model.encode(**{k: torch.from_numpy(v) for k, v in
                              _flagship_batch(1).items()})
    for key in ("image_emb", "profile_emb"):
        w = want_emb[key] / np.linalg.norm(want_emb[key], axis=1,
                                           keepdims=True)
        _close(l2_normalize(emb[key]), w, MODULE_TOL["bfloat16"], key)

    model = MultiModel(dtype=torch.bfloat16, **args)
    start = from_flax({"params": init})
    tx = make_optimizer(OptimConfig())
    state = create_train_state(model, start, tx)
    train_step, _ = make_multi_steps(model, tx, buckets=2)
    state, loss = train_step(state, {k: torch.from_numpy(v) for k, v in
                                     _flagship_batch(0).items()}, 0)
    assert abs(loss.item() - jloss) <= BF16_LOSS_TOL * abs(jloss)
    errs = {}
    for name, s in start.items():
        want = (jparams[name] - s).double()
        got = state.params[name].double() - s.double()
        errs[name] = ((got - want).norm() / want.norm()).item()
    assert np.median(list(errs.values())) <= BF16_MEDIAN_TOL
    profile = [v for n, v in errs.items()
               if n.startswith("profile_encoder.")]
    assert np.median(profile) <= BF16_MEDIAN_TOL
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BF16_UPDATE_TOL, (worst, errs[worst])
