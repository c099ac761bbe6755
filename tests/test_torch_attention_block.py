"""The fused attention block (kernels 11-12): the PyTorch port's plain
versions and module route (``PLANKTON_ATTN_FUSE_PROJ=1``) against the JAX
package's ``attn_block`` and ``FusedSelfAttention`` on the same route.

The CUDA kernels run only on the card (``chip_smoke.py`` and the ``gpu``
tests of ``tests/test_torch_cuda.py`` compare them with these plain
versions there); on the CPU the wrappers take the plain versions. The JAX
side runs its Pallas kernel in interpret mode. Tolerances: the bf16
forward within 1e-2 (the two sides round q, k, v, p, o and y at the same
points but sum in another order, so an output can land one bf16 step
apart: 2e-3 measured) and 1e-3 relative L2; f32 gradients within 1e-5 of
the largest |gradient| of their tensor (2e-7 measured), except the key
bias, whose gradient is zero in exact arithmetic (softmax ignores a shift
of a row): it must be as small as JAX's, below 1e-4 of the largest bias
gradient. The module route: 5e-2 in bf16, the JAX suite's own tolerance
for this route (tests/test_attention_block.py). Dropout: the TPU's bits
(``pltpu.prng_seed``) do not lower on the CPU, so it is held by
statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from multimodal_plankton_recognition_torch.models.dropout import dropout_rng
from multimodal_plankton_recognition_torch.ops import (
    attention_block as block_ops,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    mha_qkv_bwd_reference, mha_qkv_reference,
)
from multimodal_plankton_recognition_torch.ops.attention_block import (
    attn_block, attn_block_bwd, attn_block_bwd_reference, attn_block_fwd,
    attn_block_reference,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

JAX_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


def _inputs(b, l, e, seed=0):
    """x, the JAX kernel's weights (E, E) and biases (E,), a key bias with
    random padding (CLS kept)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, l, e).astype(np.float32)
    ws = {n: (rs.randn(e, e) / np.sqrt(e)).astype(np.float32)
          for n in ("wq", "wk", "wv", "wo")}
    ws.update({n: (rs.randn(e) * 0.1).astype(np.float32)
               for n in ("bq", "bk", "bv", "bo")})
    pad = rs.rand(b, l) < 0.3
    pad[:, 0] = False
    return x, ws, np.where(pad, -1e9, 0.0).astype(np.float32)


def _port_weights(ws):
    """The port's layout: qkv (3E, E) = the transposed q, k, v blocks, out
    (E, E) = wo transposed."""
    return tuple(map(torch.from_numpy, (
        np.concatenate([ws["wq"].T, ws["wk"].T, ws["wv"].T]),
        np.concatenate([ws["bq"], ws["bk"], ws["bv"]]),
        np.ascontiguousarray(ws["wo"].T), ws["bo"])))


def _jax_block(x, ws, bias, heads):
    return jax_attn_block(x, *(jnp.asarray(ws[n]) for n in JAX_NAMES),
                          jnp.asarray(bias), jnp.zeros((), jnp.int32), heads,
                          0.0, False, True, True)


@pytest.mark.parametrize("heads,l,e", [(3, 197, 192), (8, 225, 192)])
def test_plain_forward_matches_jax_kernel(heads, l, e):
    """bf16, b 2, random key padding (tests/test_attention_block.py's
    shapes)."""
    x, ws, bias = _inputs(2, l, e)
    want = np.asarray(_jax_block(jnp.asarray(x, jnp.bfloat16), ws, bias,
                                 heads), np.float32)
    got = attn_block_reference(torch.from_numpy(x).to(torch.bfloat16),
                               *_port_weights(ws), torch.from_numpy(bias),
                               heads)
    assert got.dtype == torch.bfloat16 and got.shape == (2, l, e)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 1e-2
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def test_plain_backward_matches_jax_grad():
    """f32, 4 heads, L 64, E 64: dx and the eight weight and bias
    gradients of sum(y²) against ``jax.grad`` of the interpret kernel."""
    heads, l, e = 4, 64, 64
    x, ws, bias = _inputs(2, l, e, seed=1)

    def loss(x, *w):
        out = _jax_block(x, dict(zip(JAX_NAMES, w)), bias, heads)
        return jnp.sum(out ** 2)

    grads = jax.grad(loss, argnums=tuple(range(9)))(
        jnp.asarray(x), *(jnp.asarray(ws[n]) for n in JAX_NAMES))
    want = dict(zip(("x",) + JAX_NAMES, map(np.asarray, grads)))
    tx, weights, tbias = torch.from_numpy(x), _port_weights(ws), \
        torch.from_numpy(bias)
    dy = 2 * attn_block_reference(tx, *weights, tbias, heads)
    dx, dwqkv, dbqkv, dwo, dbo = attn_block_bwd_reference(
        tx, *weights, tbias, dy, heads)
    q, k, v = (slice(i * e, (i + 1) * e) for i in range(3))
    got = {"x": dx, "wq": dwqkv[q].T, "wk": dwqkv[k].T, "wv": dwqkv[v].T,
           "bq": dbqkv[q], "bk": dbqkv[k], "bv": dbqkv[v], "wo": dwo.T,
           "bo": dbo}
    largest_bias = max(np.abs(want[n]).max() for n in ("bq", "bv", "bo"))
    for name, g in got.items():
        err = np.abs(g.numpy() - want[name]).max()
        if name == "bk":  # zero in exact arithmetic
            assert np.abs(g.numpy()).max() <= 1e-4 * largest_bias
            assert np.abs(want[name]).max() <= 1e-4 * largest_bias
        else:
            assert err <= 1e-5 * np.abs(want[name]).max(), (name, err)


def test_autograd_is_the_plain_backward():
    """``attn_block`` under autograd on the CPU returns the plain
    backward's gradients, in the parameters' dtype."""
    x, ws, bias = _inputs(2, 9, 48, seed=2)
    leaves = [t.clone().requires_grad_() for t in _port_weights(ws)]
    tx = torch.from_numpy(x).requires_grad_()
    y = attn_block(tx, *leaves, torch.from_numpy(bias), 3, 0.1, 5)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    y.backward(dy)
    want = attn_block_bwd_reference(tx.detach(), *_port_weights(ws),
                                    torch.from_numpy(bias), dy, 3, 0.1, 5)
    for got, w in zip([tx] + leaves, want):
        assert got.grad.dtype == torch.float32
        assert torch.equal(got.grad, w.reshape(got.shape))


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_plain_backward_takes_the_residuals_bit_for_bit(p):
    """Given the forward's q|k|v and o, the plain backward equals its
    recomputing self bit for bit, in bf16 with key padding and dropout;
    one residual alone is refused."""
    x, ws, bias = _inputs(2, 21, 48, seed=5)
    args = (torch.from_numpy(x).to(torch.bfloat16), *_port_weights(ws),
            torch.from_numpy(bias))
    dy = torch.randn((2, 21, 48), generator=torch.Generator().manual_seed(1)
                     ).to(torch.bfloat16)
    _, qkv, o = attn_block_fwd(*args, 3, p, 9, keep=True)
    given = attn_block_bwd_reference(*args, dy, 3, p, 9, qkv=qkv, o=o)
    rebuilt = attn_block_bwd_reference(*args, dy, 3, p, 9)
    for g, r in zip(given, rebuilt):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="both"):
        attn_block_bwd(*args, dy, 3, p, 9, qkv=qkv)


def test_forward_keeps_the_plain_projections():
    """``attn_block_fwd(..., keep=True)`` returns y and the residuals: the
    plain q|k|v projection (one rounding after the f32 bias) and the plain
    attention's o on it, y as without ``keep``."""
    x, ws, bias = _inputs(2, 17, 96, seed=6)
    tx, weights, tbias = (torch.from_numpy(x).to(torch.bfloat16),
                          _port_weights(ws), torch.from_numpy(bias))
    y, qkv, o = attn_block_fwd(tx, *weights, tbias, 4, 0.1, 3, keep=True)
    want = (tx.float() @ weights[0].to(torch.bfloat16).float().T
            + weights[1]).to(torch.bfloat16)
    assert qkv.dtype == torch.bfloat16 and qkv.shape == (2, 17, 288)
    assert torch.equal(qkv, want)
    assert torch.equal(o, mha_qkv_reference(want, tbias, 4, 0.1, 3))
    assert torch.equal(y, attn_block_fwd(tx, *weights, tbias, 4, 0.1, 3))


def test_autograd_keeps_residuals_only_for_a_gradient(monkeypatch):
    """The forward asks kernel 11 for its residuals only when a gradient
    will be taken, and the backward hands them to kernel 12; under
    ``no_grad``, ``inference_mode`` or on inputs that need no gradient it
    keeps nothing."""
    x, ws, bias = _inputs(2, 9, 48, seed=7)
    keeps, given = [], []
    fwd, bwd = block_ops.attn_block_fwd, block_ops.attn_block_bwd
    monkeypatch.setattr(block_ops, "attn_block_fwd",
                        lambda *a: keeps.append(a[-1]) or fwd(*a))
    monkeypatch.setattr(block_ops, "attn_block_bwd",
                        lambda *a, qkv, o: given.append(
                            (qkv is not None, o is not None))
                        or bwd(*a, qkv=qkv, o=o))
    leaves = [t.clone().requires_grad_() for t in _port_weights(ws)]
    tx, tbias = torch.from_numpy(x), torch.from_numpy(bias)
    with torch.no_grad():
        attn_block(tx, *leaves, tbias, 3)
    with torch.inference_mode():
        attn_block(tx, *leaves, tbias, 3)
    attn_block(tx, *_port_weights(ws), tbias, 3)
    attn_block(tx, *leaves, tbias, 3).sum().backward()
    assert keeps == [False, False, False, True]
    assert given == [(True, True)]


def test_autograd_with_residuals_matches_jax_grad():
    """f32, 4 heads, L 64, E 64 (``test_plain_backward_matches_jax_grad``'s
    case): dx and the weight and bias gradients of sum(y²) through
    ``attn_block`` under autograd, with the forward's saved q|k|v and o,
    against ``jax.grad`` of the interpret kernel at that test's
    tolerances."""
    heads, l, e = 4, 64, 64
    x, ws, bias = _inputs(2, l, e, seed=1)

    def loss(x, *w):
        out = _jax_block(x, dict(zip(JAX_NAMES, w)), bias, heads)
        return jnp.sum(out ** 2)

    grads = jax.grad(loss, argnums=tuple(range(9)))(
        jnp.asarray(x), *(jnp.asarray(ws[n]) for n in JAX_NAMES))
    want = dict(zip(("x",) + JAX_NAMES, map(np.asarray, grads)))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = [t.clone().requires_grad_() for t in _port_weights(ws)]
    attn_block(tx, *leaves, torch.from_numpy(bias), heads
               ).square().sum().backward()
    q, k, v = (slice(i * e, (i + 1) * e) for i in range(3))
    dwqkv, dbqkv, dwo, dbo = (t.grad for t in leaves)
    got = {"x": tx.grad, "wq": dwqkv[q].T, "wk": dwqkv[k].T,
           "wv": dwqkv[v].T, "bq": dbqkv[q], "bk": dbqkv[k], "bv": dbqkv[v],
           "wo": dwo.T, "bo": dbo}
    largest_bias = max(np.abs(want[n]).max() for n in ("bq", "bv", "bo"))
    for name, g in got.items():
        g = g.detach().numpy()
        if name == "bk":  # zero in exact arithmetic
            assert np.abs(g).max() <= 1e-4 * largest_bias
        else:
            err = np.abs(g - want[name]).max()
            assert err <= 1e-5 * np.abs(want[name]).max(), (name, err)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    x, ws, bias = _inputs(2, 9, 48, seed=3)
    args = (torch.from_numpy(x).to(torch.bfloat16), *_port_weights(ws),
            torch.from_numpy(bias))
    before = attn_block_fwd.launches, attn_block_bwd.launches
    assert torch.equal(attn_block_fwd(*args, 3),
                       attn_block_reference(*args, 3))
    attn_block_bwd(*args, args[0], 3)
    assert (attn_block_fwd.launches, attn_block_bwd.launches) == before \
        == (0, 0)
    meta = torch.empty((2, 9, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no attention-block kernel"):
        attn_block(meta, *args[1:], 3)


def _identity_block(b, l, e, seed):
    """x = ±1, q and k projections 0, v and out the identity, biases 0:
    the block's y is the attention of q = k = 0, v = x, every sum exact."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.where(torch.rand((b, l, e), generator=gen) < 0.5, -1.0,
                    1.0).to(torch.bfloat16)
    wqkv = torch.zeros((3 * e, e))
    wqkv[2 * e:] = torch.eye(e)
    return x, (wqkv, torch.zeros(3 * e), torch.eye(e), torch.zeros(e))


@pytest.mark.parametrize("heads,e", [(8, 192), (4, 128)])  # D 24 and 32
def test_plain_mask_is_the_attention_mask(heads, e):
    """Under identity projections the block's y equals ``mha_qkv``'s plain
    output on q = k = 0, v = x, and its dx the dv block of the plain
    backward, bit for bit, dropout 0.1 on: the same hashed mask."""
    b, l = 2, 21
    x, weights = _identity_block(b, l, e, seed=heads)
    pad = torch.rand((b, l), generator=torch.Generator().manual_seed(1)) \
        < 0.3
    pad[:, 0] = False
    bias = torch.where(pad, -1e9, 0.0)
    qkv = torch.cat([torch.zeros_like(x), torch.zeros_like(x), x], dim=-1)
    y = attn_block_reference(x, *weights, bias, heads, 0.1, 77)
    assert torch.equal(y, mha_qkv_reference(qkv, bias, heads, 0.1, 77))
    dy = torch.where(torch.rand((b, l, e), generator=torch.Generator()
                                .manual_seed(2)) < 0.5, -1.0, 1.0
                     ).to(torch.bfloat16)
    dx = attn_block_bwd_reference(x, *weights, bias, dy, heads, 0.1, 77)[0]
    dv = mha_qkv_bwd_reference(qkv, bias, dy, heads, 0.1, 77)[..., 2 * e:]
    assert torch.equal(dx, dv)


def test_dropout_statistics():
    """Train mode, p 0.2: under identity projections the dropped share of
    the probabilities is p (within 4 sigma), and over 200 seeds the mean
    output approaches the eval output (dropout is unbiased: kept ones
    scaled by 1/(1-p)) while each draw differs from it."""
    b, l, e, heads, p = 2, 33, 48, 3, 0.2
    _, weights = _identity_block(b, l, e, seed=0)
    # with q = k = 0 every probability is 1/L, so on v = 1 the output of a
    # row times L(1-p) counts its kept keys
    ones = torch.ones((b, l, e), dtype=torch.bfloat16)
    y = attn_block_reference(ones, *weights, None, heads, p, 3).float()
    kept = (y * l * (1 - p)).round()          # kept keys of each row
    share = 1 - kept.mean().item() / l
    sigma = (p * (1 - p) / (b * l * l * heads)) ** 0.5
    assert abs(share - p) <= 4 * sigma, (share, p)

    xs, ws, _ = _inputs(b, l, e, seed=4)
    args = (torch.from_numpy(xs), *_port_weights(ws), None, heads)
    eval_y = attn_block_reference(*args)
    draws = torch.stack([attn_block_reference(*args, p, s)
                         for s in range(200)])
    assert (draws[0] - eval_y).abs().max() > 0.05
    rel = ((draws.mean(0) - eval_y).norm() / eval_y.norm()).item()
    spread = ((draws[0] - eval_y).norm() / eval_y.norm()).item()
    assert rel <= 2.5 * spread / 200 ** 0.5, (rel, spread)


def test_module_route_matches_jax_module(monkeypatch):
    """``FusedSelfAttention`` under ``PLANKTON_ATTN_FUSE_PROJ=1`` in bf16
    and eval on weights converted by ``convert.from_flax``: the plain block
    against the JAX module's interpret kernel."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    monkeypatch.setenv("PLANKTON_ATTN_FUSE_PROJ", "1")
    b, l, e, h = 2, 33, 48, 4
    rs = np.random.RandomState(3)
    x = rs.randn(b, l, e).astype(np.float32)
    pad = rs.rand(b, l) < 0.25
    pad[:, 0] = False
    jmod = JaxFusedSelfAttention(num_heads=h, dtype=jnp.bfloat16)
    jx, jpad = jnp.asarray(x, jnp.bfloat16), jnp.asarray(pad)
    variables = jmod.init(jax.random.key(0), jx, jpad)
    want = np.asarray(jmod.apply(variables, jx, jpad), np.float32)
    mod = FusedSelfAttention(e, h).to(torch.bfloat16)
    load_flax(mod, jax.tree.map(np.asarray, variables))
    calls = []
    monkeypatch.setattr(module, "attn_block",
                        lambda *a: calls.append(1) or attn_block(*a))
    with torch.inference_mode():
        got = mod(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(pad))
    assert calls == [1]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def _routes(mod, x, monkeypatch):
    """Which core the module's forward calls: "block", "packed" or
    "unpacked"."""
    calls = []
    for name, tag in (("attn_block", "block"), ("mha_qkv", "packed"),
                      ("mha_qkv_reference", "packed"), ("mha", "unpacked"),
                      ("mha_reference", "unpacked")):
        core = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, core=core, tag=tag:
                            calls.append(tag) or core(*a))
    with torch.inference_mode():
        mod(x)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("setting", [None, "0", "1", "yes", ""])
def test_env_variable_gates_the_block(setting, monkeypatch):
    """``PLANKTON_ATTN_FUSE_PROJ``, read at every forward, takes the block
    where the JAX module's ``_fuse_proj_enabled`` does with its default
    attribute (only "1"); the block is chosen before the packed/unpacked
    variables."""
    x = torch.randn((2, 5, 48)).to(torch.bfloat16)
    mod = FusedSelfAttention(48, 3).to(torch.bfloat16)
    if setting is None:
        monkeypatch.delenv("PLANKTON_ATTN_FUSE_PROJ", raising=False)
    else:
        monkeypatch.setenv("PLANKTON_ATTN_FUSE_PROJ", setting)
    monkeypatch.setenv("PLANKTON_ATTN_QKV_PACKED", "0")
    jax_block = JaxFusedSelfAttention(num_heads=3)._fuse_proj_enabled()
    assert jax_block == (setting == "1")
    assert _routes(mod, x, monkeypatch) == [
        "block" if jax_block else "unpacked"]


@pytest.mark.parametrize("dtype,fused", [(torch.float32, True),
                                         (torch.bfloat16, False)])
def test_f32_and_unfused_modules_ignore_the_variable(dtype, fused,
                                                     monkeypatch):
    """An f32 module takes the plain packed composition and a
    ``fused=False`` one the flax route, whatever the variable says (JAX:
    the block only where the kernel gate is open)."""
    monkeypatch.setenv("PLANKTON_ATTN_FUSE_PROJ", "1")
    x = torch.randn((2, 5, 48)).to(dtype)
    mod = FusedSelfAttention(48, 3, fused=fused).to(dtype)
    assert _routes(mod, x, monkeypatch) == ([] if not fused else ["packed"])


def test_module_train_mode_draws_a_seed_per_call(monkeypatch):
    """Train mode: the block drops with a seed from the step's generator,
    one per call, so two calls differ and the same generator seed
    repeats."""
    monkeypatch.setenv("PLANKTON_ATTN_FUSE_PROJ", "1")
    calls = []
    monkeypatch.setattr(module, "attn_block",
                        lambda *a: calls.append(1) or attn_block(*a))
    torch.manual_seed(0)
    mod = FusedSelfAttention(48, 3, dropout_rate=0.1).to(torch.bfloat16)
    x = torch.randn((2, 9, 48)).to(torch.bfloat16)
    outs = []
    for _ in range(2):
        with dropout_rng(torch.Generator().manual_seed(7)):
            outs.append([mod(x), mod(x)])
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[0][1])
    assert len(calls) == 4
    with pytest.raises(RuntimeError, match="dropout_rng"):
        mod(x)
