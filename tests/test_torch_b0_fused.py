"""The fused MBConv route against the JAX package's: one fused block (bf16,
and f32 at stride 1, where both frameworks round x to bf16 for the kernels
and run BN3 in f32) and the whole fused EfficientNet-B0 in train mode, the
port's plain ``mbconv_core`` (the kernels' CPU versions) against the Flax
modules through the Pallas kernels in interpret mode, on weights converted
by ``convert.py``.

Tolerances, of max(1, max|·|) of the JAX value: one block to 3e-2 and its
running statistics to 2e-2 (``tests/test_mbconv.py``'s own bounds), in
either dtype: the f32 block's core is the bf16 kernels' all the same; the
whole fused B0 statistically, correlation > 0.95 and relative RMS < 0.3,
as ``tests/test_mbconv.py`` holds the JAX fused net to its unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.image.efficientnet import (
    EfficientNet as JaxEfficientNet, _MBConv as JaxMBConv,
)
from multimodal_plankton_recognition_tpu.ops.pallas.experimental import (
    mbconv as jax_mbconv,
)
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models.image import efficientnet
from multimodal_plankton_recognition_torch.models.image.efficientnet import (
    EfficientNet, _MBConv,
)
from torch_threads import one_thread  # noqa: F401  (autouse)


def _np(tree):
    """A Flax tree as numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=tol * max(1.0, np.abs(want).max()),
                               rtol=0, err_msg=what)


def _stats_close(module, updated, tol):
    """The module's buffers (f32) against a Flax ``batch_stats`` tree."""
    want = from_flax({"params": {}, "batch_stats": _np(updated)})
    got = dict(module.named_buffers())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        _close(got[name].numpy(), w.numpy(), tol, name)


def _train_apply(module, variables, x):
    """A Flax module's train-mode apply (output, updated batch_stats),
    jitted: one compile where op-by-op dispatch of the interpreted Pallas
    kernels took most of this file's time."""
    return jax.jit(lambda v, x: module.apply(v, x, train=True,
                                             mutable=["batch_stats"]))(
        variables, x)


@pytest.fixture(scope="module")
def b0_variables():
    net = JaxEfficientNet(in_chans=1, dtype=jnp.float32)
    x = jnp.zeros((1, 8, 8, 1))
    init = jax.jit(lambda key: net.init(key, x, train=False))
    return _np(init(jax.random.key(0)))


# the JAX test's blocks: (cin, cout, expand, stride, k), with SE widths 4,
# 8, 4 and 10
BLOCKS = [(16, 16, 6, 1, 3), (32, 32, 1, 1, 3), (16, 24, 6, 2, 3),
          (40, 40, 6, 1, 5)]


@pytest.mark.parametrize("cin,cout,er,stride,k", BLOCKS)
def test_fused_block_matches_jax_fused(cin, cout, er, stride, k,
                                       monkeypatch):
    """One bf16 train-mode block, fused in both frameworks: the port's
    plain ``mbconv_core`` + BN3 against the Flax block through the Pallas
    kernels (interpret mode); output and the three running statistics."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jblock = JaxMBConv(cin, cout, er, stride, k, 0.25, jnp.bfloat16,
                       fused=True)
    x = np.random.RandomState(0).randn(4, 12, 12, cin).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = _np(jax.jit(lambda key: JaxMBConv(
        cin, cout, er, stride, k, 0.25, jnp.bfloat16).init(
            key, xb, train=False))(jax.random.key(0)))
    want, upd = _train_apply(jblock, variables, xb)
    block = _MBConv(cin, cout, er, stride, k, 0.25, fused=True)
    block.load_state_dict(from_flax(variables), strict=True)
    block.to(torch.bfloat16).train()
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block(xt.contiguous(memory_format=torch.channels_last))
    assert got.dtype == torch.bfloat16
    _close(got.permute(0, 2, 3, 1).float().numpy(), want, 3e-2, "block")
    _stats_close(block, upd["batch_stats"], 2e-2)


@pytest.mark.parametrize("cin,cout,er,stride,k",
                         [b for b in BLOCKS if b[3] == 1])
def test_f32_fused_block_matches_jax_fused(cin, cout, er, stride, k,
                                           monkeypatch):
    """One f32 train-mode block at stride 1 takes the kernel route in both
    frameworks (the JAX block has no dtype gate): x rounded to bf16 for
    ``mbconv_core``, BN3 and the residual in f32; output and the three
    running statistics (f32) against the Flax block through the Pallas
    kernels (interpret mode), and both cores reached once."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    calls = {"jax": 0, "port": 0}

    def counting(side, real):
        def core(*args):
            calls[side] += 1
            return real(*args)
        return core

    monkeypatch.setattr(jax_mbconv, "mbconv_core",
                        counting("jax", jax_mbconv.mbconv_core))
    monkeypatch.setattr(efficientnet, "mbconv_core",
                        counting("port", efficientnet.mbconv_core))
    x = np.random.RandomState(5).randn(4, 12, 12, cin).astype(np.float32)
    xj = jnp.asarray(x)
    variables = _np(jax.jit(lambda key: JaxMBConv(
        cin, cout, er, stride, k, 0.25, jnp.float32).init(
            key, xj, train=False))(jax.random.key(1)))
    want, upd = _train_apply(JaxMBConv(cin, cout, er, stride, k, 0.25,
                                       jnp.float32, fused=True),
                             variables, xj)
    assert want.dtype == jnp.float32
    block = _MBConv(cin, cout, er, stride, k, 0.25, fused=True)
    block.load_state_dict(from_flax(variables), strict=True)
    block.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block(xt.contiguous(memory_format=torch.channels_last))
    assert calls == {"jax": 1, "port": 1}
    assert got.dtype == torch.float32
    _close(got.permute(0, 2, 3, 1).numpy(), want, 3e-2, "block")
    _stats_close(block, upd["batch_stats"], 2e-2)


def test_fused_efficientnet_close_to_jax_fused(b0_variables, monkeypatch):
    """The whole bf16 B0 in train mode, fused in both frameworks: train
    BN's feedback across 16 blocks amplifies bf16 reassociation, so the
    bound is statistical, as the JAX test's fused-against-unfused one."""
    monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    x = np.random.RandomState(3).randn(16, 24, 24, 1).astype(np.float32)
    jnet = JaxEfficientNet(in_chans=1, dtype=jnp.bfloat16, fused=True)
    want, _ = _train_apply(jnet, b0_variables, jnp.asarray(x))
    net = EfficientNet(in_chans=1, fused=True)
    net.load_state_dict(from_flax(b0_variables), strict=True)
    net.to(torch.bfloat16).train()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(a).all()
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    rms = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))
    assert corr > 0.95, corr
    assert rms < 0.3, rms
