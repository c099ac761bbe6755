"""CLIP loss parity: the port's fused plain versions, its unfused losses
and its coordination head against the JAX package's fused kernels
(interpret mode) and ``ops.losses``.

The CUDA kernels run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` compare them with these plain versions there).
Tolerances: 1e-6 on the f32 loss and gradients (both sides compute the
same f32 math and sum in another order; values are O(1) and O(1e-2));
in bf16 the embeddings are the same bf16 numbers on both sides and the
math is f32 inside, so the loss keeps 1e-6, and the gradients, rounded to
bf16 on return, may differ by one bf16 step where the f32 values straddle a
rounding boundary: 1e-2 relative. The unfused bf16 loss rounds the
normalised embeddings and similarities to bf16 on both sides, in another
order: 2e-2. The backward's plain version given the forward's statistics
(exp(z - lse) in place of the softmax) keeps the same tolerances against
JAX and against itself recomputing them.
"""

import importlib.util
from pathlib import Path

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
    clip_loss_fused as jax_clip_loss_fused,
)
from multimodal_plankton_recognition_torch.models.multi import (
    CoordinationHead,
)
from multimodal_plankton_recognition_torch.ops import contrastive, losses
from multimodal_plankton_recognition_torch.ops.contrastive import (
    clip_bwd, clip_bwd_tile, clip_fwd, clip_fwd_tile, clip_loss_bwd_reference,
    clip_loss_fused, clip_loss_fused_reference, clip_scratch,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

BUCKETS = [1, 2, 4]
REPO = Path(__file__).resolve().parents[1]
# the CUDA kernels' regime edges: one 16-row tile (the one-block backward),
# the first bucket of 32-row tiles (the two-kernel backward) and one row
# past one and two 32-row tiles; D 32 takes 16-byte loads, D 33 the scalar
# path
EDGE_N = [1, 16, 17, 33, 65]
EDGE_D = [32, 33]


def _emb(b=16, d=32, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, d).astype(np.float32),
            rs.randn(b, d).astype(np.float32), np.float32(0.7))


def _jax_fused(img, prof, scale, buckets, dtype):
    def f(i, p, s):
        return jax_clip_loss_fused(i, p, s, buckets, True)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(img, dtype), jnp.asarray(prof, dtype), jnp.asarray(scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("buckets", BUCKETS)
def test_plain_versions_match_jax_kernels_interpret(buckets, dtype):
    img, prof, scale = _emb(seed=buckets)
    loss, (gi, gp, gs) = _jax_fused(img, prof, scale, buckets,
                                    getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    ti, tp = (torch.from_numpy(x).to(tdt) for x in (img, prof))
    ts = torch.tensor(scale)
    got = clip_fwd(ti, tp, ts, buckets)  # CPU tensor: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    g = torch.tensor(1.0)
    di, dp, ds = clip_bwd(ti, tp, ts, g, buckets)
    assert di.dtype == tdt and dp.dtype == tdt and ds.dtype == torch.float32
    tol = 1e-6 if dtype == "float32" else 1e-2
    for got_g, want_g in ((di, gi), (dp, gp)):
        want_g = np.asarray(want_g, np.float32)
        np.testing.assert_allclose(got_g.float().numpy(), want_g, rtol=tol,
                                   atol=tol * np.abs(want_g).max())
    np.testing.assert_allclose(ds.item(), float(gs), rtol=1e-5)


def _assert_grads(got, want, dtype):
    """(d_image, d_profile, d_scale) against JAX's at the file's
    tolerances."""
    tol = 1e-6 if dtype == "float32" else 1e-2
    for got_g, want_g in zip(got[:2], want[:2]):
        want_g = np.asarray(want_g, np.float32)
        np.testing.assert_allclose(got_g.float().numpy(), want_g, rtol=tol,
                                   atol=tol * np.abs(want_g).max())
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", EDGE_D)
@pytest.mark.parametrize("n", EDGE_N)
def test_plain_versions_match_jax_at_the_regime_edges(n, d, dtype):
    """Two buckets of ``n`` rows: the plain forward (with its statistics)
    and backward against the JAX kernels in interpret mode."""
    img, prof, scale = _emb(b=2 * n, d=d, seed=n + d)
    loss, grads = _jax_fused(img, prof, scale, 2, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    ti, tp = (torch.from_numpy(x).to(tdt) for x in (img, prof))
    ts = torch.tensor(scale)
    got, stats = clip_fwd(ti, tp, ts, 2, keep=True)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    assert stats.shape == (4, 2 * n) and stats.dtype == torch.float32
    _assert_grads(clip_bwd(ti, tp, ts, torch.tensor(1.0), 2), grads, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 33])
def test_bwd_reference_takes_the_forward_statistics(n, dtype):
    """The backward's plain version given the forward's statistics equals
    the one recomputing them and JAX's gradients."""
    img, prof, scale = _emb(b=2 * n, d=33, seed=40 + n)
    _, grads = _jax_fused(img, prof, scale, 2, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    ti, tp = (torch.from_numpy(x).to(tdt) for x in (img, prof))
    ts, g = torch.tensor(scale), torch.tensor(1.0)
    stats = clip_loss_fused_reference(ti, tp, ts, 2, keep=True)[1]
    given = clip_bwd(ti, tp, ts, g, 2, stats=stats)
    _assert_grads(given, grads, dtype)
    recomputing = clip_loss_bwd_reference(ti, tp, ts, g, 2)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for a, b in zip(given, recomputing):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=tol, atol=tol * b.abs().max().item())


@pytest.mark.parametrize("n", [1, 16, 17, 32, 33, 64, 128, 129, 256, 300,
                               512])
def test_clip_kernel_layout(n):
    """The tiles of each regime and the scratch the wrapper allocates for
    them (``csrc/clip_loss.cu``): the forward on 16-row tiles up to
    ``_CLIP_FWD_TILE16_ROWS`` rows, 32 above; the backward on one 16-row
    tile a bucket up to 16 rows (the one-block backward, which needs one
    float a bucket), above that the two-kernel backward on 32-row tiles
    (two N x NP operands, the q partials and a partial a tile); no cap on
    n."""
    buckets = 3
    rows = buckets * n
    tile = clip_fwd_tile(n)
    assert tile == (16 if n <= contrastive._CLIP_FWD_TILE16_ROWS else 32)
    sizes = clip_scratch(buckets, n)
    assert sizes["fwd"] == 2 * 2 * rows * -(-n // tile) + rows
    tile = clip_bwd_tile(n)
    assert tile == (16 if n <= 16 else 32)
    tiles = -(-n // tile)
    if n <= 16:
        assert tiles == 1 and sizes["bwd"] == buckets
    else:
        np_ = -(-n // 32) * 32
        assert np_ % 32 == 0 and n <= np_ < n + 32
        assert sizes["bwd"] == (2 * rows * np_ + 2 * rows * tiles
                                + buckets * tiles ** 2)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("kernel", ["clip_fwd", "clip_bwd", "siglip_fwd",
                                    "siglip_bwd"])
def test_smoke_ranks_the_loss_kernels_at_timed_shapes(kernel):
    """Every label ``chip_smoke._rank_table`` ranks a loss kernel at is a
    shape the kernel phase times (``CLIP_SHAPES``, ``SIGLIP_SHAPES``), and
    each path's label is the bucket shape its step runs."""
    smoke = _smoke()
    shapes = smoke.CLIP_SHAPES if kernel.startswith("clip") \
        else smoke.SIGLIP_SHAPES
    timed = {f"buckets={b} N={n} D=512" for b, n in shapes}
    paths = smoke._rank_table()[kernel]
    for path, rows in paths.items():
        assert [r[0] for r in rows if r[1] is None] == [r[0] for r in rows]
        assert {r[0] for r in rows} <= timed, (path, rows)
    if kernel.startswith("clip"):
        assert paths["train"][0][0] == "buckets=16 N=16 D=512"
        assert paths["b0_card"][0][0] == "buckets=4 N=16 D=512"
        assert paths["global"][0][0] == "buckets=1 N=256 D=512"
    else:
        assert paths["card"][0][0] == "buckets=4 N=16 D=512"
        assert paths["siglip_global"][0][0] == "buckets=1 N=64 D=512"


@pytest.mark.parametrize("buckets", BUCKETS)
def test_fused_equals_plain_clip_loss(buckets):
    """The fused loss's value and gradients are those of the unfused
    ``clip_loss`` (port and JAX), d logit_scale included."""
    img, prof, scale = _emb(seed=10 + buckets)
    want = float(jax_losses.clip_loss(jnp.asarray(img), jnp.asarray(prof),
                                      jnp.asarray(scale), buckets))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (img, prof)]
    s1 = torch.tensor(scale, requires_grad=True)
    fused = clip_loss_fused(*leaves, s1, buckets)
    fused.backward()
    plain_leaves = [torch.from_numpy(x).requires_grad_() for x in (img, prof)]
    s2 = torch.tensor(scale, requires_grad=True)
    plain = losses.clip_loss(*plain_leaves, s2, buckets)
    plain.backward()
    np.testing.assert_allclose(fused.item(), want, rtol=1e-6)
    np.testing.assert_allclose(plain.item(), want, rtol=1e-6)
    for a, b in zip(leaves + [s1], plain_leaves + [s2]):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["clip", "clipplus"])
@pytest.mark.parametrize("fused", [False, True])
def test_coordination_head_matches_jax(fused, method, dtype, monkeypatch):
    """``CoordinationHead`` (CLIP and CLIP+, fused and unfused) on the same
    embeddings and logit_scale as the JAX head; the fused JAX head runs its
    kernels in interpret mode."""
    img, prof, _ = _emb(seed=3)
    if fused:
        monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ji, jp = jnp.asarray(img, jdt), jnp.asarray(prof, jdt)
    jhead = JaxCoordinationHead(method=method, fused=fused)
    variables = {"params": {"logit_scale": jnp.float32(0.4)}}
    want = float(jhead.apply(variables, ji, jp, buckets=2))
    head = CoordinationHead(method=method, fused=fused)
    with torch.no_grad():
        head.logit_scale.fill_(0.4)
    got = head(torch.from_numpy(img).to(tdt), torch.from_numpy(prof).to(tdt),
               buckets=2)
    tol = 1e-6 if dtype == "float32" or fused else 2e-2
    np.testing.assert_allclose(got.float().item(), want, rtol=tol)


def test_mse_and_clipplus_match_jax():
    img, prof, scale = _emb(seed=5)
    want_mse = float(jax_losses.mse_loss(jnp.asarray(img), jnp.asarray(prof)))
    got_mse = losses.mse_loss(torch.from_numpy(img), torch.from_numpy(prof))
    np.testing.assert_allclose(got_mse.item(), want_mse, rtol=1e-6)
    want = float(jax_losses.clipplus_loss(
        jnp.asarray(img), jnp.asarray(prof), jnp.asarray(scale), 4, 0.3))
    got = losses.clipplus_loss(torch.from_numpy(img), torch.from_numpy(prof),
                               torch.tensor(scale), 4, 0.3)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_bwd_reference_divides_the_cotangent_by_buckets():
    """``g / buckets`` per bucket, d logit_scale summed over buckets: the
    gradients scale linearly with g and equal autograd of the mean loss."""
    img, prof, scale = _emb(seed=7)
    ti, tp = torch.from_numpy(img), torch.from_numpy(prof)
    ts = torch.tensor(scale)
    one = clip_loss_bwd_reference(ti, tp, ts, torch.tensor(1.0), 4)
    three = clip_loss_bwd_reference(ti, tp, ts, torch.tensor(3.0), 4)
    for a, b in zip(one, three):
        np.testing.assert_allclose(3 * a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-8)
    leaves = [t.clone().requires_grad_() for t in (ti, tp, ts)]
    clip_loss_fused_reference(*leaves, 4).backward()
    for a, b in zip(one, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-5,
                                   atol=1e-8)


def test_bad_buckets_raise():
    img, prof, scale = _emb(b=10)
    with pytest.raises(ValueError, match="divisible"):
        clip_loss_fused(torch.from_numpy(img), torch.from_numpy(prof),
                        torch.tensor(scale), 4)
    with pytest.raises(ValueError, match="no CLIP kernel"):
        clip_fwd(torch.empty((4, 8), device="meta"),
                 torch.empty((4, 8), device="meta"),
                 torch.empty((), device="meta"), 1)
