"""Fused FFN parity (kernels 9 and 10): the port's plain versions
(``ops/ffn.py``) against the JAX package's ``ffn_core`` run as its own
tests run it on the CPU (the Pallas kernels in interpret mode), the
dropout bits, the fused-FFN ViT and ProfileTransformer against the JAX
modules on converted weights, and the fused ViT flagship at two layers
(encode and a dropout-0 train step).

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); on the CPU ``ffn_core`` takes the plain versions.

Tolerances:

* operator level, against the JAX kernels in interpret mode (the same
  rounding points, f32 sums in another order): bf16 output within one bf16
  step of its largest value (1e-2 of it; measured 1e-5), f32 output within
  1e-5 of it, every gradient within 1e-4 of its largest value (measured
  1.2e-6);
* modules, against the JAX modules with their fused FFN on its kernel
  route (``ffn_core`` in interpret mode, as the JAX package runs it on a
  TPU; on any other backend it takes its jnp fallback): f32 within 1e-4
  (both sides round the FFN through bf16 at the same points), bf16 within
  5e-2 (the attention and LayerNorm round bf16 at other points, as in
  ``tests/test_torch_slice.py``);
* against the JAX modules as they run on the CPU (the jnp fallback, which
  rounds to the model dtype after each op and not through bf16 in f32):
  5e-2 in both dtypes, the bf16 gap of the fallback's f32 FFN;
* the flagship's train step, the bf16 bounds of ``tests/test_torch_train.py``
  (loss 2e-3 relative, median update 5e-2, every update 0.3).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.flagships import (
    flagship_vit as jax_flagship_vit,
)
from multimodal_plankton_recognition_tpu.models.image import vit as jax_vit
from multimodal_plankton_recognition_tpu.models.multi import (
    MultiModel as JaxMultiModel,
)
from multimodal_plankton_recognition_tpu.models.profile import (
    transformer as jax_transformer,
)
from multimodal_plankton_recognition_tpu.ops.pallas.experimental.ffn import (
    ffn_core as jax_ffn_core,
)
from multimodal_plankton_recognition_torch.convert import from_flax, load_flax
from multimodal_plankton_recognition_torch.models.flagships import (
    flagship_vit,
)
from multimodal_plankton_recognition_torch.models.image.vit import ViT
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.models.profile.transformer import (
    ProfileTransformer,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    dropout_threshold,
)
from multimodal_plankton_recognition_torch.ops.ffn import (
    ffn_bwd, ffn_core, ffn_dropout_bits, ffn_fwd, ffn_reference,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

OP_FWD_TOL = {"bfloat16": 1e-2, "float32": 1e-5}  # of the largest |y|
OP_GRAD_TOL = 1e-4  # of the largest |gradient|
MODULE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FALLBACK_TOL = 5e-2


def _setup(b, l, e, f, seed=0):
    """x, w1, b1, w2, b2 as in tests/test_ffn.py, as numpy f32."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, l, e).astype(np.float32),
            (rs.randn(e, f) * 0.1).astype(np.float32),
            (rs.randn(f) * 0.1).astype(np.float32),
            (rs.randn(f, e) * 0.1).astype(np.float32),
            (rs.randn(e) * 0.1).astype(np.float32))


def _jax_kernel(x, w1, b1, w2, b2, activation):
    return jax_ffn_core(x, w1, b1, w2, b2, jnp.zeros((), jnp.int32),
                        activation, 0.0, False, True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_plain_matches_jax_kernel_fwd(activation, dtype):
    """Odd L (29) as in tests/test_ffn.py; bf16 and f32 x."""
    x, w1, b1, w2, b2 = _setup(3, 29, 64, 256)
    want = np.asarray(_jax_kernel(jnp.asarray(x, getattr(jnp, dtype)), w1,
                                  b1, w2, b2, activation), np.float32)
    got = ffn_core(torch.from_numpy(x).to(getattr(torch, dtype)),
                   *map(torch.from_numpy, (w1, b1, w2, b2)), activation)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    top = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= OP_FWD_TOL[dtype] * top


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_plain_matches_jax_kernel_grad(activation, dtype):
    """``ffn_core``'s backward (``ffn_bwd_reference``) against ``jax.grad``
    through the JAX kernels (``_bwd_kernel`` in interpret mode)."""
    x, w1, b1, w2, b2 = _setup(2, 29, 64, 256, seed=1)
    jx = jnp.asarray(x, getattr(jnp, dtype))

    def loss(*args):
        return jnp.sum(_jax_kernel(*args, activation).astype(jnp.float32)
                       ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jx, *map(jnp.asarray, (w1, b1, w2, b2)))
    leaves = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()]
    leaves += [torch.from_numpy(a).requires_grad_() for a in (w1, b1, w2, b2)]
    ffn_core(*leaves, activation).float().square().sum().backward()
    for name, leaf, w in zip(("x", "w1", "b1", "w2", "b2"), leaves, want):
        w = np.asarray(w, np.float32)
        assert leaf.grad.shape == w.shape, name
        err = np.abs(leaf.grad.float().numpy() - w).max()
        assert err <= OP_GRAD_TOL * np.abs(w).max(), (name, err)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    x, w1, b1, w2, b2 = map(torch.from_numpy, _setup(2, 5, 32, 64))
    before = ffn_fwd.launches, ffn_bwd.launches
    y = ffn_fwd(x, w1, b1, w2, b2, "gelu", 0.1, 7)
    grads = ffn_bwd(x, w1, b1, w2, b2, torch.ones_like(y), "gelu", 0.1, 7)
    assert (ffn_fwd.launches, ffn_bwd.launches) == before == (0, 0)
    torch.testing.assert_close(y, ffn_reference(x, w1, b1, w2, b2, "gelu",
                                                0.1, 7), rtol=0, atol=0)
    assert [tuple(g.shape) for g in grads] == [
        (2, 5, 32), (32, 64), (64,), (64, 32), (32,)]


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty((2, 5, 64), device="meta")
    w = torch.empty((64, 64), device="meta")
    b = torch.empty((64,), device="meta")
    with pytest.raises(ValueError, match="no FFN kernel"):
        ffn_core(x, w, b, w, b)
    with pytest.raises(ValueError, match="activation"):
        ffn_core(x, w, b, w, b, "silu")


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_one_minus_p(p):
    """The hash keeps a fraction 1 - p of hidden units (within 5 sigma at
    64 x 2048 units), with no row or column pattern."""
    keep = (ffn_dropout_bits(11, 64, 2048) >= dropout_threshold(p)).float()
    n = keep.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep.mean().item() - (1 - p)) <= 5 * sigma
    assert keep.mean(1).std().item() < 0.05 and keep.mean(0).std() < 0.1
    assert not torch.equal(keep, (ffn_dropout_bits(12, 64, 2048)
                                  >= dropout_threshold(p)).float())


def test_backward_zeroes_exactly_the_dropped_units():
    """One row: the bias gradient db1[f], the column dw1[:, f] and the row
    dw2[f] are zero exactly where the forward dropped hidden unit f (GELU's
    derivative is never 0)."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _setup(1, 1, 32, 512, seed=3))
    p, seed = 0.3, 5
    keep = ffn_dropout_bits(seed, 1, 512)[0] >= dropout_threshold(p)
    assert 0 < keep.sum() < 512
    _, dw1, db1, dw2, _ = ffn_bwd(x, w1, b1, w2, b2, torch.ones_like(x),
                                  "gelu", p, seed)
    assert torch.equal(db1 != 0, keep)
    assert torch.equal((dw1 != 0).any(0), keep)
    assert torch.equal((dw2 != 0).any(1), keep)


# ----------------------------------------------------------------------------
# modules on converted weights
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def jax_kernel_route():
    """The JAX blocks' fused FFN on its TPU route (``ffn_core``), in
    interpret mode; on the CPU the JAX package otherwise takes its jnp
    fallback (``models/ffn.py:98-107``)."""
    def route(mod, x, k1, b1, k2, b2, activation, dropout_p, deterministic,
              dtype):
        train = not deterministic and dropout_p > 0.0
        seed = (jax.random.randint(mod.make_rng("dropout"), (), 0,
                                   jnp.iinfo(jnp.int32).max)
                if train else jnp.zeros((), jnp.int32))
        return jax_ffn_core(x.astype(dtype), k1, b1, k2, b2, seed,
                            activation, dropout_p, train, True)

    old = jax_vit.apply_fused_ffn, jax_transformer.apply_fused_ffn
    jax_vit.apply_fused_ffn = jax_transformer.apply_fused_ffn = route
    try:
        yield
    finally:
        jax_vit.apply_fused_ffn, jax_transformer.apply_fused_ffn = old


def _close(got: torch.Tensor, want, tol: float, what: str = ""):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().detach().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


VIT = dict(img_size=32, depth=2, embed_dim=48, num_heads=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_vit_matches_jax(dtype, monkeypatch):
    """ViT with ``fused_ffn`` (and fused attention) on converted weights:
    against the JAX ViT on its kernel route and as it runs on the CPU."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    image = np.random.RandomState(4).randn(3, 32, 32, 1).astype(np.float32)
    jmod = jax_vit.ViT(**VIT, fused_attention=True, fused_ffn=True,
                       dtype=jdt)
    variables = jmod.init(jax.random.key(0), jnp.asarray(image))
    with jax_kernel_route():
        want = jmod.apply(variables, jnp.asarray(image))
    fallback = jmod.apply(variables, jnp.asarray(image))
    model = ViT(**VIT, fused_attention=True, fused_ffn=True).to(tdt)
    load_flax(model, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(image))
    assert got.dtype == tdt
    _close(got, want, MODULE_TOL[dtype], "kernel route")
    _close(got, fallback, FALLBACK_TOL, "fallback")


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_profile_transformer_matches_jax(dtype, activation,
                                               monkeypatch):
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = dict(dim_hidden=64, target_size=16, num_head=4, num_layers=2,
                dim_feedforward=96, activation=activation,
                fused_attention=True, fused_ffn=True)
    rs = np.random.RandomState(5)
    b, l = 3, 17
    profile = rs.randn(b, l, 6).astype(np.float32)
    time = np.tile(np.arange(l, dtype=np.int32), (b, 1))
    mask = np.zeros((b, l), bool)
    mask[1, 9:] = mask[2, 4:] = True
    plen = rs.randint(20, 400, (b, 1)).astype(np.int32)
    inputs = tuple(map(jnp.asarray, (profile, time, mask, plen)))
    jmod = jax_transformer.ProfileTransformer(**args, dtype=jdt)
    variables = jmod.init(jax.random.key(0), *inputs)
    with jax_kernel_route():
        want = jmod.apply(variables, *inputs)
    fallback = jmod.apply(variables, *inputs)
    model = ProfileTransformer(**args).to(tdt).eval()
    load_flax(model, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (profile, time, mask, plen)))
    _close(got, want, MODULE_TOL[dtype], "kernel route")
    _close(got, fallback, FALLBACK_TOL, "fallback")


def test_fused_tree_converts_unchanged():
    """``fused_ffn`` keeps the Dense pair's tree: a fused Flax ViT's
    variables convert to the same names and shapes as an unfused one's, and
    load into the port's fused and unfused modules alike."""
    image = jnp.zeros((1, 32, 32, 1))
    trees = {}
    for fused in (False, True):
        v = jax_vit.ViT(**VIT, fused_ffn=fused).init(jax.random.key(0),
                                                      image)
        trees[fused] = {k: tuple(t.shape) for k, t in from_flax(
            jax.tree.map(np.asarray, v)).items()}
        for port_fused in (False, True):
            load_flax(ViT(**VIT, fused_ffn=port_fused),
                      jax.tree.map(np.asarray, v))
    assert trees[True] == trees[False]


# ----------------------------------------------------------------------------
# the fused ViT flagship, two layers
# ----------------------------------------------------------------------------

def _flagship_args(jmodel, img=32, target_size=16):
    """The JAX flagship's encoder arguments at 2 ViT layers and small
    inputs (the flagship's widths, heads and FFN kept)."""
    image = dict(jmodel.image_encoder_args,
                 backbone_kwargs={"img_size": img, "depth": 2})
    profile = dict(jmodel.profile_encoder_args, target_size=target_size)
    return dict(dim_embed=jmodel.dim_embed, image_encoder_args=image,
                profile_encoder_args=profile,
                coordination_args=jmodel.coordination_args)


def _flagship_batch(seed, bs=8, img=32, target_size=16):
    from multimodal_plankton_recognition_torch.data.tokenize import (
        tokenize_transformer,
    )
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, target_size + 1, bs)
    lengths[0] = target_size
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in lengths], target_size,
        pad_to=target_size + 1)
    return {"image": rs.randn(bs, img, img, 1).astype(np.float32),
            "image_shape": rs.randint(200, 400, (bs, 2)).astype(np.int32),
            "profile_len": rs.randint(100, 2000, (bs, 1)).astype(np.int32),
            **tokens}


def test_flagship_vit_takes_fused_ffn():
    """``flagship_vit(fused_ffn=True)`` hands the flag to every block of
    both encoders, as the JAX flagship does, and changes no parameter."""
    jmodel = jax_flagship_vit(fused_ffn=True)
    assert jmodel.image_encoder_args["fused_ffn"]
    assert jmodel.profile_encoder_args["fused_ffn"]
    fused, plain = flagship_vit(fused_ffn=True), flagship_vit()
    assert all(b.fused_ffn for b in fused.image_encoder.backbone.blocks)
    assert all(l.fused_ffn for l in fused.profile_encoder.layers)
    assert not any(b.fused_ffn for b in plain.image_encoder.backbone.blocks)
    assert {n: p.shape for n, p in fused.named_parameters()} == {
        n: p.shape for n, p in plain.named_parameters()}


@functools.cache
def _jax_flagship_run():
    """The JAX fused flagship at 2 layers, bf16, on its kernel routes
    (attention and FFN in interpret mode): initial parameters, the encode
    of batch 1, and (loss, parameters) after one dropout-0 train step on
    batch 0, converted to the port's names."""
    import os
    from multimodal_plankton_recognition_tpu.config import (
        OptimConfig as JaxOptimConfig,
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

    args = _flagship_args(jax_flagship_vit(fused_ffn=True))
    for key in ("image_encoder_args", "profile_encoder_args"):
        args[key] = dict(args[key], dropout=0.0)
    old = os.environ.get("PLANKTON_FUSED_INTERPRET")
    os.environ["PLANKTON_FUSED_INTERPRET"] = "1"
    try:
        with jax_kernel_route():
            model = JaxMultiModel(dtype=jnp.bfloat16, **args)
            tx = jax_make_optimizer(JaxOptimConfig())
            batch = {k: jnp.asarray(v) for k, v in _flagship_batch(0).items()}
            # one compile each (op-by-op, the interpreted kernels took most
            # of the file's time)
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
    return (args, init, {k: np.asarray(v, np.float32) for k, v in
                         emb.items()}, float(loss), after)


def test_fused_flagship_encode_matches_jax():
    from multimodal_plankton_recognition_torch.ops.losses import (
        l2_normalize,
    )
    args, init, want, _, _ = _jax_flagship_run()
    model = MultiModel(dtype=torch.bfloat16, **args)
    load_flax(model, {"params": init})
    model.eval()
    with torch.inference_mode():
        emb = model.encode(**{k: torch.from_numpy(v) for k, v in
                              _flagship_batch(1).items()})
    for key in ("image_emb", "profile_emb"):
        w = want[key] / np.linalg.norm(want[key], axis=1, keepdims=True)
        _close(l2_normalize(emb[key]), w, MODULE_TOL["bfloat16"], key)


def test_fused_flagship_train_step_matches_jax():
    from multimodal_plankton_recognition_torch.config import OptimConfig
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_multi_steps, make_optimizer,
    )
    args, init, _, jloss, jparams = _jax_flagship_run()
    model = MultiModel(dtype=torch.bfloat16, **args)
    start = from_flax({"params": init})
    tx = make_optimizer(OptimConfig())
    state = create_train_state(model, start, tx)
    train_step, _ = make_multi_steps(model, tx, buckets=2)
    state, loss = train_step(state, {k: torch.from_numpy(v) for k, v in
                                     _flagship_batch(0).items()}, 0)
    assert abs(loss.item() - jloss) <= 2e-3 * abs(jloss)
    errs = {}
    for name, s in start.items():
        want = (jparams[name] - s).double()
        got = state.params[name].double() - s.double()
        errs[name] = ((got - want).norm() / want.norm()).item()
    assert np.median(list(errs.values())) <= 5e-2
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.3, (worst, errs[worst])
    for n in ("image_encoder.backbone.blocks.1.mlp1.weight",
              "profile_encoder.layers.0.ff2.bias"):
        assert errs[n] <= 5e-2, (n, errs[n])
