"""The MBConv block core at the shapes the JAX package's Pallas kernels
take and no shipped backbone reaches: channel counts that are not
multiples of 8 and depthwise sizes other than 3 and 5. On the card the
port's kernels 13-16 run them through the padding route
(``ops/mbconv.py``: cin, mid and cout padded with zero channels to the
next multiple of 8) and instances for every odd k from 1 to 11; here the
plain versions behind ``mbconv_core`` are held against the JAX package,
and the padding route composed with the plain versions against the plain
versions at the true widths.

Inputs from a numpy seed, B 2-3, 6-8 px. JAX's ``mbconv_core`` in
interpret mode at the two shapes checked against it first (cin 5, mid
30, cout 12, k 3; cin = mid = cout = 12, k 7): each costs seconds of
interpretation, so the other shapes go against its plain
``mbconv_reference``. Tolerances are ``tests/test_mbconv.py``'s: forward
outputs and statistics within 3e-2 of max(1, max|·|), gradients (of a
loss on y3, m3 and v3) within 6e-2 of max(1e-3, max|·|); each JAX side
runs as one jitted ``value_and_grad``. The padding route adds zero
products and zero channels only, so it matches the plain version up to
the order of an f32 sum over a padded K, which can land a bf16
intermediate (y1, dy1, dx) on the other side of a rounding: every output
within one bf16 step (2⁻⁷) of max(1, max|·|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.ops.pallas.experimental.mbconv import (  # noqa: E501
    mbconv_core as jax_mbconv_core, mbconv_reference as jax_reference,
)
from multimodal_plankton_recognition_torch.ops import mbconv
from torch_threads import one_thread  # noqa: F401  (autouse)

NAMES = ["x", "wexp", "g1", "b1", "wdw", "g2", "b2", "wr", "br", "we", "be",
         "wproj"]
OUTS = ["y3", "m1", "v1", "m2", "v2", "m3", "v3"]
# (B, H = W, cin, mid, cout, k, r): against JAX's interpreted kernels
KERNEL_CASES = [(2, 6, 5, 30, 12, 3, 3), (2, 6, 12, 12, 12, 7, 3)]
# against JAX's plain reference: cin 20 and cout 20 (padded to 24) at k
# 9, cin 30 and mid 180 (to 32 and 184) at k 5, no expand at 20 channels
# with cout 12 at k 1, and k 11
REFERENCE_CASES = [(2, 8, 20, 120, 20, 9, 5), (2, 6, 30, 180, 30, 5, 7),
                   (3, 8, 20, 20, 12, 1, 5), (2, 7, 12, 24, 12, 11, 3)]


def _args(b, hw, cin, mid, cout, k, r, seed=0):
    """numpy args in NAMES order (None for a missing expand)."""
    rs = np.random.RandomState(seed + 7 * k + cin)
    expand = mid != cin

    def f(*s):
        return (rs.randn(*s) * 0.3).astype(np.float32)

    return [rs.randn(b, hw, hw, cin).astype(np.float32),
            f(cin, mid) if expand else None,
            1.0 + 0.1 * f(mid) if expand else None,
            0.1 * f(mid) if expand else None,
            f(k, k, 1, mid) * 0.5, 1.0 + 0.1 * f(mid), 0.1 * f(mid),
            f(mid, r), 0.1 * f(r), f(r, mid), 0.1 * f(mid), f(mid, cout)]


def _jax_args(args):
    return [None if a is None else
            jnp.asarray(a, jnp.bfloat16 if i == 0 else jnp.float32)
            for i, a in enumerate(args)]


def _torch_args(args, grad=False):
    return [None if a is None else
            (torch.from_numpy(a).to(torch.bfloat16) if i == 0
             else torch.from_numpy(a)).requires_grad_(grad)
            for i, a in enumerate(args)]


def _close(got, want, rel, floor, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=rel * max(floor, np.abs(want).max()),
                               err_msg=what)


def _loss_jax(fn):
    def loss(*a):
        y3, m1, v1, m2, v2, m3, v3 = fn(*a)
        return (jnp.sum(y3.astype(jnp.float32) ** 2) + 3.0 * jnp.sum(m3)
                + 2.0 * jnp.sum(v3))
    return loss


def _port(args, k):
    """The port's outputs and gradients (plain versions on the CPU)."""
    ta = _torch_args(args, grad=True)
    out = mbconv.mbconv_core(*ta, k)
    y3, m1, v1, m2, v2, m3, v3 = out
    (y3.float().pow(2).sum() + 3.0 * m3.sum() + 2.0 * v3.sum()).backward()
    return out, {n: t.grad for n, t in zip(NAMES, ta) if t is not None}


def _held(args, k, fn):
    """The port against the JAX function ``fn`` (its signature that of
    ``jax_reference`` with k bound): forward and gradients, from one
    compile of JAX's ``value_and_grad``."""
    out, grads = _port(args, k)
    ja = _jax_args(args)
    nums = tuple(i for i, a in enumerate(ja) if a is not None)
    present = [ja[i] for i in nums]

    def loss(*leaves):
        full = list(ja)
        for i, leaf in zip(nums, leaves):
            full[i] = leaf
        outs = fn(*full)
        return _loss_jax(lambda *_: outs)(), outs

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(nums))), has_aux=True))(*present)
    for name, g, w in zip(OUTS, out, want):
        if args[1] is None and name in ("m1", "v1"):
            continue  # the placeholders of a missing expand
        _close(g.detach().float().numpy(), w, 3e-2, 1.0, name)
    want = dict(zip([NAMES[i] for i in nums], jgrads))
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        _close(grads[name].float().numpy(), w, 6e-2, 1e-3, f"d{name}")


@pytest.mark.parametrize("b,hw,cin,mid,cout,k,r", KERNEL_CASES)
def test_plain_matches_jax_kernels(b, hw, cin, mid, cout, k, r):
    """cin 5 / cout 12 and k 7: JAX's Pallas kernels (interpret mode) take
    them, and so does the port."""
    _held(_args(b, hw, cin, mid, cout, k, r), k,
          lambda *a: jax_mbconv_core(*a, k, True))


@pytest.mark.parametrize("b,hw,cin,mid,cout,k,r", REFERENCE_CASES)
def test_plain_matches_jax_reference(b, hw, cin, mid, cout, k, r):
    _held(_args(b, hw, cin, mid, cout, k, r), k,
          lambda *a: jax_reference(*a, k=k))


def _near(got, want, what):
    """The padding route's tolerance: one bf16 step of max(1, max|·|)."""
    assert got.dtype == want.dtype, what
    _close(got.float().numpy(), want.float().numpy(), 2.0 ** -7, 1.0, what)


@pytest.mark.parametrize("cin,mid,cout,k", [(20, 30, 12, 3), (20, 20, 12, 7),
                                            (5, 30, 20, 1)])
def test_padding_route_equals_plain(cin, mid, cout, k):
    """``pad_mbconv`` → the four plain versions at the kernels' widths →
    ``unpad_mbconv_grads`` (what the card runs, with the plain versions in
    the kernels' place) against the plain versions at the true widths:
    equal within f32 summation order; the padded channels come out zero."""
    b, hw, r = 2, 6, 5
    args = _torch_args(_args(b, hw, cin, mid, cout, k, r, seed=3))
    x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj = args
    rs = np.random.RandomState(11)
    dy3 = torch.from_numpy(rs.randn(b, hw, hw, cout).astype(
        np.float32)).to(torch.bfloat16)
    ci, mi, co = (mbconv.kernel_channels(c) for c in (cin, mid, cout))
    px, pwexp, pg1, pb1, pwdw, pg2, pb2, pwr, pbr, pwe, pbe, pwproj = \
        mbconv.pad_mbconv(*args, k)
    assert px.shape[-1] == ci and pwdw.shape == (k, k, mi)
    assert pwproj.shape == (mi, co)

    y2, m1, v1, m2, v2 = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
    py2, pm1, pv1, pm2, pv2 = mbconv.ka_fwd_reference(px, pwexp, pg1, pb1,
                                                      pwdw, k)
    kb = (g2, b2, m2, v2, wr, br, we, be, wproj)
    pkb = (pg2, pb2, pm2, pv2, pwr, pbr, pwe, pbe, pwproj)
    y3, m3, v3 = mbconv.kb_fwd_reference(y2, *kb)
    py3, pm3, pv3 = mbconv.kb_fwd_reference(py2, *pkb)
    dy3p = torch.zeros((*dy3.shape[:-1], co), dtype=dy3.dtype)
    dy3p[..., :cout] = dy3
    kbb = mbconv.kb_bwd_reference(y2, dy3, *kb)
    pkbb = mbconv.kb_bwd_reference(py2, dy3p, *pkb)
    kab = mbconv.ka_bwd_reference(x, kbb[0], wexp, g1, b1, wdw, m1, v1, k)
    pkab = mbconv.ka_bwd_reference(px, pkbb[0], pwexp, pg1, pb1, pwdw, pm1,
                                   pv1, k)
    for name, got, want in (
            ("y2", py2[..., :mid], y2), ("m2", pm2[:mid], m2),
            ("v2", pv2[:mid], v2), ("y3", py3[..., :cout], y3),
            ("m3", pm3[:cout], m3), ("v3", pv3[:cout], v3)):
        _near(got, want, name)
    for t in (py2[..., mid:], py3[..., cout:], pkbb[0][..., mid:]):
        assert float(t.float().abs().sum()) == 0.0
    grads = mbconv.unpad_mbconv_grads(
        (pkab[0], pkab[1], pkab[2], pkab[3], pkab[4], pkbb[6], pkbb[7],
         pkbb[2], pkbb[3], pkbb[4], pkbb[5], pkbb[1]), cin, mid, cout)
    want = (kab[0], kab[1], kab[2], kab[3], kab[4], kbb[6], kbb[7], kbb[2],
            kbb[3], kbb[4], kbb[5], kbb[1])
    for i, (g, w) in enumerate(zip(grads, want)):
        if w is None:
            assert g is None, i
            continue
        assert g.shape == w.shape and g.is_contiguous(), i
        _near(g, w, f"grad {i}")


def test_kernel_sizes():
    """The card takes every odd depthwise size from 1 to 11 and refuses an
    even one (the reference's plain version grows its output there, unlike
    JAX's kernel) and one above ``MAX_KERNEL_SIZE``, each with its reason,
    before any launch."""
    assert mbconv.KERNEL_SIZES == (1, 3, 5, 7, 9, 11)
    for k in mbconv.KERNEL_SIZES:
        mbconv.check_kernel_size(k)
    for k in (2, 4):
        with pytest.raises(ValueError, match=f"size {k} .*even k"):
            mbconv.check_kernel_size(k)
    with pytest.raises(ValueError, match="size 13 .*MAX_KERNEL_SIZE=11"):
        mbconv.check_kernel_size(13)
    # the even-k disagreement that keeps even k off the card: the plain
    # version's output is a row and a column larger than its input
    x = torch.zeros((1, 6, 6, 8), dtype=torch.bfloat16)
    y2 = mbconv.ka_fwd_reference(x, None, None, None,
                                 torch.zeros((4, 4, 8)), 4)[0]
    assert y2.shape == (1, 7, 7, 8)
