"""SigLIP loss and coordination-head parity: the port's SigLIP plain
versions, its fused entry, its unfused losses and its ``CoordinationHead``
(all eight methods) against the JAX package's fused kernels (interpret
mode), ``ops.losses`` and ``CoordinationHead`` on converted parameters.

The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` compare them with these plain versions there).
Tolerances: the loss to 1e-5 relative (f32 math on both sides, summed in
another order; in bf16 the embeddings are the same bf16 numbers on both
sides and the math is f32 inside); gradients of the embeddings to 1e-5 of
their largest value in f32 and 1e-2 in bf16 (rounded to bf16 on return,
one bf16 step where an f32 value straddles a rounding boundary);
d logit_scale and d logit_bias to 1e-4 relative: both are sums whose
terms cancel, and at the init bias −10 almost all of d_bias comes from the
N diagonal terms, so they are checked relatively and not against the
largest gradient. The unfused bf16 losses round the normalised embeddings
and similarities to bf16 on both sides, in another order: 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.multi import (
    CoordinationHead as JaxCoordinationHead,
)
from multimodal_plankton_recognition_tpu.ops import losses as jax_losses
from multimodal_plankton_recognition_tpu.ops.pallas.contrastive import (
    siglip_loss_fused as jax_siglip_loss_fused,
)
from multimodal_plankton_recognition_torch.config import COORDINATION_METHODS
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models.multi import (
    CoordinationHead,
)
from multimodal_plankton_recognition_torch.ops import losses
from multimodal_plankton_recognition_torch.ops import contrastive
from multimodal_plankton_recognition_torch.ops.contrastive import (
    siglip_bwd, siglip_bwd_tile, siglip_fwd, siglip_fwd_tile,
    siglip_loss_bwd_reference, siglip_loss_fused, siglip_loss_fused_reference,
    siglip_scratch,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

# (logit_scale, logit_bias): a moderate pair, the init bias, and the
# saturated ends where a naive log(1 + e^x) would overflow
SCALARS = [(0.7, -3.0), (1.0, -10.0), (5.0, 30.0), (5.0, -30.0)]
SCALAR_TOL = 1e-4
# the CUDA kernels' regime edges, each at its own width: one row, one
# 16-row tile (the one-block backward), the first bucket of 32-row tiles
# (the two-kernel backward), one row past one 32-row tile and past the
# old 256-row cap; D 24 and 40 take 16-byte loads in bf16, 33 the scalar
# path, 32 both
EDGE_N_D = [(1, 24), (16, 32), (17, 33), (33, 40), (257, 24)]


def _emb(b=16, d=32, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(b, d).astype(np.float32), rs.randn(b, d).astype(np.float32)


def _jax_fused(img, prof, scale, bias, buckets, dtype):
    def f(i, p, s, b):
        return jax_siglip_loss_fused(i, p, s, b, buckets, True)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
        jnp.asarray(img, dtype), jnp.asarray(prof, dtype),
        jnp.float32(scale), jnp.float32(bias))


@pytest.mark.parametrize("scale,bias", SCALARS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("buckets", [1, 4])
def test_plain_versions_match_jax_kernels_interpret(buckets, dtype, scale,
                                                    bias):
    img, prof = _emb(seed=buckets)
    loss, (gi, gp, gs, gb) = _jax_fused(img, prof, scale, bias, buckets,
                                        getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    ti, tp = (torch.from_numpy(x).to(tdt) for x in (img, prof))
    ts, tb = torch.tensor(scale), torch.tensor(bias)
    got = siglip_fwd(ti, tp, ts, tb, buckets)  # CPU tensor: the plain version
    assert got.dtype == torch.float32 and torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    di, dp, ds, db = siglip_bwd(ti, tp, ts, tb, torch.tensor(1.0), buckets)
    assert di.dtype == tdt and dp.dtype == tdt
    assert ds.dtype == torch.float32 and db.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got_g, want_g in ((di, gi), (dp, gp)):
        want_g = np.asarray(want_g, np.float32)
        assert torch.isfinite(got_g).all()
        np.testing.assert_allclose(got_g.float().numpy(), want_g, rtol=tol,
                                   atol=tol * np.abs(want_g).max())
    np.testing.assert_allclose(ds.item(), float(gs), rtol=SCALAR_TOL,
                               atol=1e-7)
    np.testing.assert_allclose(db.item(), float(gb), rtol=SCALAR_TOL,
                               atol=1e-7)


@pytest.mark.parametrize("scale,bias", [(1.0, -10.0), (5.0, 30.0),
                                        (5.0, -30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", EDGE_N_D)
def test_plain_versions_match_jax_at_the_regime_edges(n, d, dtype, scale,
                                                      bias):
    """Two buckets of ``n`` rows at the kernels' regime edges: the plain
    forward and backward against the JAX kernels in interpret mode, at the
    head's init scalars and at the saturated ends; N 257 is past the old
    cap, which the kernels no longer have."""
    img, prof = _emb(b=2 * n, d=d, seed=n + d)
    loss, (gi, gp, gs, gb) = _jax_fused(img, prof, scale, bias, 2,
                                        getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    ti, tp = (torch.from_numpy(x).to(tdt) for x in (img, prof))
    ts, tb = torch.tensor(scale), torch.tensor(bias)
    got = siglip_fwd(ti, tp, ts, tb, 2)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    di, dp, ds, db = siglip_bwd(ti, tp, ts, tb, torch.tensor(1.0), 2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got_g, want_g in ((di, gi), (dp, gp)):
        want_g = np.asarray(want_g, np.float32)
        assert got_g.dtype == tdt and torch.isfinite(got_g).all()
        np.testing.assert_allclose(got_g.float().numpy(), want_g, rtol=tol,
                                   atol=tol * np.abs(want_g).max())
    np.testing.assert_allclose(ds.item(), float(gs), rtol=SCALAR_TOL,
                               atol=1e-7)
    np.testing.assert_allclose(db.item(), float(gb), rtol=SCALAR_TOL,
                               atol=1e-7)


@pytest.mark.parametrize("n", [1, 16, 17, 64, 128, 129, 256, 300, 512])
def test_siglip_kernel_layout(n):
    """The tiles of each regime and the scratch the wrapper allocates for
    them (``csrc/siglip_loss.cu``): the forward on 16-row tiles up to
    ``_SIGLIP_FWD_TILE16_ROWS`` rows, 32 above, with one partial a tile;
    the backward on one 16-row tile a bucket up to 16 rows (the one-block
    backward: two partials a bucket), above that on 32-row tiles (two N x
    NP operands, the q partials, the norms and two partials a tile); no
    cap on n."""
    buckets = 3
    rows = buckets * n
    tile = siglip_fwd_tile(n)
    assert tile == (16 if n <= contrastive._SIGLIP_FWD_TILE16_ROWS else 32)
    sizes = siglip_scratch(buckets, n)
    assert sizes["fwd"] == buckets * (-(-n // tile)) ** 2
    tile = siglip_bwd_tile(n)
    assert tile == (16 if n <= 16 else 32)
    tiles = -(-n // tile)
    if n <= 16:
        assert tiles == 1 and sizes["bwd"] == 2 * buckets
    else:
        np_ = -(-n // 32) * 32
        assert np_ % 32 == 0 and n <= np_ < n + 32
        assert sizes["bwd"] == (2 * rows * np_ + 2 * rows * tiles + 2 * rows
                                + 2 * buckets * tiles ** 2)
    assert not hasattr(contrastive, "SIGLIP_MAX_BUCKET")


@pytest.mark.parametrize("buckets", [1, 2, 4])
def test_fused_equals_plain_siglip_loss(buckets):
    """The fused loss's value and gradients are those of the unfused
    ``siglip_loss`` (port and JAX), both scalars' gradients included."""
    img, prof = _emb(seed=10 + buckets)
    scale, bias = np.float32(0.7), np.float32(-3.0)
    want = float(jax_losses.siglip_loss(jnp.asarray(img), jnp.asarray(prof),
                                        jnp.asarray(scale), jnp.asarray(bias),
                                        buckets))
    runs = []
    for fn in (siglip_loss_fused, losses.siglip_loss):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (img, prof)]
        leaves += [torch.tensor(v, requires_grad=True) for v in (scale, bias)]
        value = fn(*leaves, buckets)
        value.backward()
        np.testing.assert_allclose(value.item(), want, rtol=1e-6)
        runs.append([t.grad.numpy() for t in leaves])
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_bwd_reference_divides_the_cotangent_by_buckets():
    """``g / buckets`` per bucket, scalar gradients summed over buckets:
    the gradients scale linearly with g and equal autograd of the mean
    loss."""
    img, prof = _emb(seed=7)
    args = [torch.from_numpy(img), torch.from_numpy(prof),
            torch.tensor(0.7), torch.tensor(-3.0)]
    one = siglip_loss_bwd_reference(*args, torch.tensor(1.0), 4)
    three = siglip_loss_bwd_reference(*args, torch.tensor(3.0), 4)
    for a, b in zip(one, three):
        np.testing.assert_allclose(3 * a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-8)
    leaves = [t.clone().requires_grad_() for t in args]
    siglip_loss_fused_reference(*leaves, 4).backward()
    for a, b in zip(one, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-5,
                                   atol=1e-8)


def test_siglip_refuses_what_the_kernels_do_not_take():
    img, prof = _emb(b=10)
    with pytest.raises(ValueError, match="divisible"):
        siglip_loss_fused(torch.from_numpy(img), torch.from_numpy(prof),
                          torch.tensor(0.0), torch.tensor(0.0), 4)
    meta = [torch.empty((4, 8), device="meta") for _ in range(2)]
    scalar = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="no SigLIP kernel"):
        siglip_fwd(*meta, scalar, scalar, 1)
    with pytest.raises(ValueError, match="no SigLIP kernel"):
        siglip_bwd(*meta, scalar, scalar, scalar, 1)


def _head_case(method, fused, dtype, monkeypatch):
    """(JAX loss, port loss) of one ``CoordinationHead`` on the same
    embeddings, labels and converted parameters (non-default scalars)."""
    img, prof = _emb(seed=3)
    label = np.random.RandomState(4).randint(0, 5, img.shape[0])
    if fused:
        monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ji, jp = jnp.asarray(img, jdt), jnp.asarray(prof, jdt)
    kwargs = {"out_features": 5, "in_features": 32} \
        if method == "arcface" else {}
    jhead = JaxCoordinationHead(method=method, fused=fused, **kwargs)
    params = dict(jhead.init(jax.random.key(0), ji, jp, buckets=2,
                             label=jnp.asarray(label)).get("params", {}))
    if "logit_scale" in params:
        params["logit_scale"] = jnp.float32(0.4)
    if "logit_bias" in params:
        params["logit_bias"] = jnp.float32(-2.0)
    variables = {"params": jax.tree.map(np.asarray, params)}
    want = jhead.apply(variables, ji, jp, buckets=2,
                       label=jnp.asarray(label))
    # converted as the head of a MultiModel tree, where it is `coordination`
    state = from_flax({"params": {"coordination": variables["params"]}})
    head = CoordinationHead(method=method, fused=fused, **kwargs)
    head.load_state_dict({k.removeprefix("coordination."): v
                          for k, v in state.items()}, strict=True)
    got = head(torch.from_numpy(img).to(tdt), torch.from_numpy(prof).to(tdt),
               buckets=2, label=torch.from_numpy(label))
    return want, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", COORDINATION_METHODS)
def test_coordination_head_matches_jax(method, fused, dtype, monkeypatch):
    """Every coordination method, fused and unfused, on the same
    embeddings and converted parameters as the JAX head; the fused JAX
    head runs its kernels in interpret mode. ``fused`` changes nothing
    for rank, distance, arcface and zero, in both packages."""
    want, got = _head_case(method, fused, dtype, monkeypatch)
    assert got.dtype == getattr(torch, str(want.dtype))
    fused_path = fused and method in ("clip", "clipplus", "siglip",
                                      "siglipplus")
    tol = 1e-5 if dtype == "float32" or fused_path else 2e-2
    if method.endswith("plus") and dtype == "bfloat16":
        tol = 2e-2  # the bf16 MSE term
    np.testing.assert_allclose(got.float().item(), float(want), rtol=tol,
                               atol=1e-6)


def test_head_parameters_follow_the_flax_tree():
    """logit_scale (1.0) for the scaled losses, logit_bias (−10.0) for
    SigLIP only, ArcFace weight (out, in) Xavier-uniform, all f32; an
    unknown method raises."""
    names = {m: sorted(n for n, _ in CoordinationHead(
        method=m, out_features=3, in_features=4).named_parameters())
        for m in COORDINATION_METHODS}
    assert names == {
        "clip": ["logit_scale"], "clipplus": ["logit_scale"],
        "siglip": ["logit_bias", "logit_scale"],
        "siglipplus": ["logit_bias", "logit_scale"],
        "rank": [], "distance": [], "arcface": ["weight"], "zero": []}
    head = CoordinationHead(method="siglip")
    assert head.logit_scale.item() == 1.0 and head.logit_bias.item() == -10.0
    assert head.logit_bias.dtype == torch.float32
    weight = CoordinationHead(method="arcface", out_features=300,
                              in_features=200).weight
    bound = np.sqrt(6.0 / 500)
    assert weight.shape == (300, 200) and weight.dtype == torch.float32
    assert weight.abs().max().item() <= bound
    assert weight.std().item() == pytest.approx(bound / np.sqrt(3), rel=0.05)
    with pytest.raises(ValueError, match="not found"):
        CoordinationHead(method="bogus")
