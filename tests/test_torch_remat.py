"""EfficientNet's ``se_ratio <= 0`` and ``remat`` in the port
(``models/image/efficientnet.py``, ``models/batchnorm.py``'s
``recomputing``), on the CPU:

* ``se_ratio: 0``: no ``se`` module anywhere, the tree JAX's (keys and
  shapes of ``jax.eval_shape`` of its init, also for ``fused=True``,
  whose blocks then keep the plain route in JAX and here: a spy on
  ``mbconv_core`` sees no call), and the features of JAX's
  ``EfficientNet(se_ratio=0, remat="conv_saves")`` (24 px, B 8, f32,
  converted weights) within 1e-4 of max(1, |·|) in eval and train mode,
  with the updated running statistics;
* ``remat`` true and "conv_saves" against ``remat: false`` in the port
  (B0 at 16 px, B 4, f32, the fused route too, its core on
  ``mbconv_core``'s plain versions): the loss, every gradient and every
  running statistic bit for bit, the statistics moved once (equal to the
  no-remat step's); on the plain route the forward's convolutions that
  the backward runs again (counted under a dispatch mode): none without
  remat, every block's under ``true``, only the squeeze-excite's two a
  block under "conv_saves" (the three named convolutions' outputs are
  kept); on the fused route ``mbconv_core`` runs again in the backward
  for every stride-1 block under either; a checkpoint only in a
  train-mode forward that takes gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multimodal_plankton_recognition_tpu.models.image.efficientnet import (
    EfficientNet as JaxEfficientNet,
)
from multimodal_plankton_recognition_torch.convert import from_flax, to_flax
from multimodal_plankton_recognition_torch.models.image import efficientnet
from multimodal_plankton_recognition_torch.models.image.efficientnet import (
    EfficientNet,
)
from multimodal_plankton_recognition_torch.models.initializers import (
    init_weights_,
)

from test_torch_classifier import _random_variables
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
STRIDE1_BLOCKS = 12  # B0's stride-1 blocks: the fused route's
SE_CONVS = 2  # reduce and expand, a block


def _image(b, size, seed=0):
    return np.random.RandomState(seed).randn(b, size, size, 1).astype(
        np.float32)


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_se_ratio_0_tree_is_jax(fused):
    jm = JaxEfficientNet(se_ratio=0.0, fused=fused)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            _image(2, 32), train=False))
    pm = EfficientNet(se_ratio=0.0, fused=fused)
    assert not any(n.endswith(".se") or ".se." in n
                   for n, _ in pm.named_modules())
    assert jax.tree.map(np.shape, to_flax(pm)) == \
        jax.tree.map(lambda s: s.shape, dict(shapes))


def test_se_ratio_0_never_takes_the_fused_route(monkeypatch):
    calls = []
    real = efficientnet.mbconv_core
    monkeypatch.setattr(efficientnet, "mbconv_core",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(_image(4, 16))
    for se_ratio, want in ((0.0, 0), (0.25, STRIDE1_BLOCKS)):
        model = init_weights_(EfficientNet(se_ratio=se_ratio, fused=True),
                              torch.Generator().manual_seed(0))
        calls.clear()
        model.train()(x).sum().backward()
        assert len(calls) == want, se_ratio


def test_se_ratio_0_remat_model_matches_jax():
    """JAX's ``remat="conv_saves"`` model without squeeze-excite, and the
    port's, on the same weights: the same tree, and features and
    statistics within 1e-4."""
    jm = JaxEfficientNet(se_ratio=0.0, remat="conv_saves")
    x = _image(8, 24, 1)
    variables = _random_variables(dict(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), x, train=False))))

    @jax.jit
    def forward(v, x):
        return (jm.apply(v, x, train=False),
                jm.apply(v, x, train=True, mutable=["batch_stats"]))

    want_eval, (want_train, updated) = forward(variables, x)
    pm = EfficientNet(se_ratio=0.0, remat="conv_saves")
    pm.load_state_dict(from_flax(variables), strict=True)
    _close(pm.eval()(torch.from_numpy(x)), want_eval, "eval")
    got = pm.train()(torch.from_numpy(x))
    _close(got, want_train, "train")
    got.sum().backward()  # through the checkpointed blocks
    stats = from_flax({"params": {}, **jax.tree.map(np.asarray, updated)})
    for n, buf in pm.named_buffers():
        _close(buf, stats[n].numpy(), n)


class _Convolutions(TorchDispatchMode):
    """Counts the convolutions that run (not those a checkpoint's policy
    hands back from its store)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


@functools.cache
def _step(remat, fused):
    """(loss, gradients, statistics before and after, forward
    convolutions the backward ran, ``mbconv_core`` calls) of one
    train-mode step of B0 at 16 px from a seeded init."""
    model = init_weights_(EfficientNet(remat=remat, fused=fused),
                          torch.Generator().manual_seed(0)).train()
    before = {n: b.clone() for n, b in model.named_buffers()}
    calls = []
    real = efficientnet.mbconv_core
    efficientnet.mbconv_core = lambda *a: calls.append(1) or real(*a)
    try:
        loss = model(torch.from_numpy(_image(4, 16, 2))).square().mean()
        forward_calls = len(calls)
        with _Convolutions() as convs:
            loss.backward()
    finally:
        efficientnet.mbconv_core = real
    return (loss.item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            before, {n: b.clone() for n, b in model.named_buffers()},
            convs.count, (forward_calls, len(calls) - forward_calls))


def _block_convs(model):
    """The convolutions of the MBConv blocks' forward on the plain
    route."""
    return sum(2 + int(getattr(model, n).has_expand) + SE_CONVS
               for n in model.block_names)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("remat", [True, "conv_saves"],
                         ids=["full", "conv_saves"])
def test_remat_matches_no_remat(remat, fused):
    loss0, grads0, init0, stats0, convs0, core0 = _step(False, fused)
    loss, grads, init, stats, convs, core = _step(remat, fused)
    assert loss == loss0
    assert sorted(grads) == sorted(grads0)
    for n, g in grads0.items():
        assert torch.equal(grads[n], g), n
    for n, b in stats0.items():
        assert torch.equal(stats[n], b), n  # one update, as without remat
        assert not torch.equal(b, init0[n]), n
    if not fused:
        model = EfficientNet()
        assert convs0 == 0
        assert convs == (_block_convs(model) if remat is True
                         else SE_CONVS * len(model.block_names))
    if fused:
        assert core0 == (STRIDE1_BLOCKS, 0)
        assert core == (STRIDE1_BLOCKS, STRIDE1_BLOCKS)  # recomputed
    else:
        assert core0 == core == (0, 0)


def test_remat_checkpoints_only_train_steps(monkeypatch):
    """A checkpoint a block in a train-mode forward that takes gradients;
    none in eval mode or under ``no_grad``; an unknown mode raises."""
    regions = []
    real = efficientnet.checkpoint
    monkeypatch.setattr(efficientnet, "checkpoint",
                        lambda *a, **k: regions.append(1) or real(*a, **k))
    model = init_weights_(EfficientNet(remat=True),
                          torch.Generator().manual_seed(0))
    x = torch.from_numpy(_image(2, 16, 3))
    model.eval()(x)
    with torch.no_grad():
        model.train()(x)
    assert not regions
    model.train()(x)
    assert len(regions) == len(model.block_names) == 16
    with pytest.raises(ValueError, match="remat"):
        EfficientNet(remat="sometimes")
