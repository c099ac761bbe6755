"""The port's MBConv block core on the CPU (the plain versions of kernels
13-16 behind ``ops.mbconv.mbconv_core``) against the JAX package's
``mbconv_core`` (Pallas kernels in interpret mode) and its plain
``mbconv_reference``.

Inputs from a numpy seed, B 4, 8×8, cin 8, for (expand 6, k 3),
(expand 1, k 3) and (expand 6, k 5), with SE widths that are not powers of
two. Tolerances are ``tests/test_mbconv.py``'s own: forward outputs and
all six statistics within 3e-2 of max(1, max|·|); every gradient, through
a loss on y3, m3 and v3 (so the m3 / v3 fold is exercised), within 6e-2
of max(1e-3, max|·|). Both sides round to bf16 at the same points but sum
in other orders.
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
CASES = [(6, 3), (1, 3), (6, 5)]


def _args(expand_ratio, k, b=4, hw=8, cin=8, seed=0):
    """(numpy args in NAMES order, None for the missing expand)."""
    rs = np.random.RandomState(seed + k)
    mid = cin * expand_ratio
    cout = 16 if expand_ratio != 1 else cin
    r = max(1, int(cin * 0.25)) + 1  # 3: an odd SE width
    expand = expand_ratio != 1
    f = lambda *s: (rs.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    x = rs.randn(b, hw, hw, cin).astype(np.float32)
    return [x, f(cin, mid) if expand else None,
            1.0 + 0.1 * f(mid) if expand else None,
            0.1 * f(mid) if expand else None,
            f(k, k, 1, mid) * 0.5, 1.0 + 0.1 * f(mid), 0.1 * f(mid),
            f(mid, r), 0.1 * f(r), f(r, mid), 0.1 * f(mid), f(mid, cout)]


def _jax_args(args):
    return [None if a is None else
            jnp.asarray(a, jnp.bfloat16 if i == 0 else jnp.float32)
            for i, a in enumerate(args)]


def _torch_args(args, grad=False):
    out = []
    for i, a in enumerate(args):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(a)
        t = t.to(torch.bfloat16) if i == 0 else t
        out.append(t.requires_grad_(grad))
    return out


def _close(got, want, rel, floor, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=rel * max(floor, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("expand_ratio,k", CASES)
def test_forward_matches_jax(expand_ratio, k):
    args = _args(expand_ratio, k)
    got = mbconv.mbconv_core(*_torch_args(args), k)
    ja = _jax_args(args)
    for want in (jax.jit(lambda *a: jax_reference(*a, k=k))(*ja),
                 jax.jit(lambda *a: jax_mbconv_core(*a, k, True))(*ja)):
        for name, g, w in zip(OUTS, got, want):
            if expand_ratio == 1 and name in ("m1", "v1"):
                continue
            _close(g.float().numpy(), w, 3e-2, 1.0, name)
    if expand_ratio == 1:  # the placeholders
        assert torch.equal(got[1], torch.zeros(8))
        assert torch.equal(got[2], torch.ones(8))


def _jax_grads(fn, args, k):
    def loss(*a):
        y3, m1, v1, m2, v2, m3, v3 = fn(*a)
        return (jnp.sum(y3.astype(jnp.float32) ** 2) + 3.0 * jnp.sum(m3)
                + 2.0 * jnp.sum(v3))
    ja = _jax_args(args)
    nums = tuple(i for i, a in enumerate(ja) if a is not None)
    return dict(zip([NAMES[i] for i in nums],
                    jax.jit(jax.grad(loss, argnums=nums))(*ja)))


@pytest.mark.parametrize("expand_ratio,k", CASES)
def test_gradients_match_jax(expand_ratio, k):
    args = _args(expand_ratio, k)
    ta = _torch_args(args, grad=True)
    y3, m1, v1, m2, v2, m3, v3 = mbconv.mbconv_core(*ta, k)
    (y3.float().pow(2).sum() + 3.0 * m3.sum() + 2.0 * v3.sum()).backward()
    got = {n: t.grad for n, t in zip(NAMES, ta) if t is not None}
    for want in (_jax_grads(lambda *a: jax_reference(*a, k=k), args, k),
                 _jax_grads(lambda *a: jax_mbconv_core(*a, k, True), args,
                            k)):
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert got[name].dtype == ta[NAMES.index(name)].dtype, name
            _close(got[name].float().numpy(), w, 6e-2, 1e-3, f"d{name}")


def test_wrappers_count_no_launch_on_the_cpu():
    """A CPU tensor runs the plain versions: no kernel, no count."""
    before = [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd,
                                   mbconv.kb_bwd, mbconv.ka_bwd)]
    ta = _torch_args(_args(6, 3), grad=True)
    mbconv.mbconv_core(*ta, 3)[0].float().sum().backward()
    assert [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd,
                                 mbconv.kb_bwd, mbconv.ka_bwd)] == before


def test_other_devices_raise():
    x = torch.zeros((1, 2, 2, 4), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no MBConv kernel"):
        mbconv.ka_fwd(x, None, None, None, torch.zeros(3, 3, 4), 3)
