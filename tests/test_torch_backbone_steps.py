"""The module-6 image classifiers (ResNet-18, ResNet-50, DenseNet-121)
against the JAX package's at reduced depth, by the harness and the
tolerances of ``tests/test_torch_classifier.py``, in f32 at 32 px and
B 16: eval logits within 1e-4 of max(1, max|logit|); one dropout-0 train
step against JAX's ``make_classifier_steps`` (an SGD at lr 1 that keeps
the gradients in its state): the loss within 1e-5 relative, every
gradient and update within 1e-3 relative L2, the updated running
statistics within 1e-4 of max(1, |·|); the eval step's loss, ``pred``
and ``label``.

DenseNet's step is held on JAX's side of every ReLU's kink: at these
sizes its BatchNorms normalize 16-64 values a channel, which magnifies
the two frameworks' f32 rounding differences to about 1e-5 in the
pre-activations, and a pre-activation that close to 0 lands on the other
side of its ReLU in one of them (8e-6 in block3_layer0.bn2 of this
batch), which moves upstream gradients by up to 3%. So JAX's BatchNorm
outputs are captured (flax ``capture_intermediates``), and each port
BatchNorm output whose sign differs from JAX's (only within 1e-4 of 0,
asserted) is mirrored to JAX's side, keeping its gradient; then every
tensor is held to 1e-3 as the others are, but the stem BatchNorm's scale,
a near-cancelling sum over 4,096 positions a channel, to 1e-2
(``check_train_step``'s ``loose``).

Reduced depth: ``resnet18`` and ``resnet50`` fix their stage sizes and
``densenet121`` its block sizes, so no card key reaches them (JAX's
``backbone_kwargs`` cannot either). For this file both packages'
registries build the names at one block a stage (ResNet, basic and
bottleneck) and two layers a dense block, every projection and
transition kept; the full-depth trees are held in
``tests/test_torch_backbones.py``.
"""

import functools

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.image import (
    densenet as jax_densenet, registry as jax_registry, resnet as jax_resnet,
)
from multimodal_plankton_recognition_torch.models.image import (
    densenet, registry, resnet,
)

from multimodal_plankton_recognition_torch.convert import _module_name
from multimodal_plankton_recognition_torch.models.batchnorm import BatchNorm

from test_torch_classifier import (
    _inputs, _jax_model, _jax_run, check_logits, check_train_step,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

KINK = 1e-4  # the largest |pre-activation| whose ReLU side may differ
# DenseNet's stem BatchNorm scale: its gradient is a near-cancelling sum
# over the stem's 4,096 positions a channel (its RMS 0.5% of the median
# gradient's), whose f32 summation order alone moves it by 0.5%
STEM_SCALE = ("image_encoder.backbone.stem_bn.weight",)

REDUCED = {
    "resnet18": (jax_resnet.ResNet, resnet.ResNet,
                 {"stage_sizes": (1, 1, 1, 1), "bottleneck": False}),
    "resnet50": (jax_resnet.ResNet, resnet.ResNet,
                 {"stage_sizes": (1, 1, 1, 1), "bottleneck": True}),
    "densenet121": (jax_densenet.DenseNet, densenet.DenseNet,
                    {"block_config": (2, 2, 2, 2)}),
}


@pytest.fixture(scope="module", autouse=True)
def reduced_registries():
    """Both registries build ``REDUCED``'s depths under the shipped
    names for this file's tests, and are restored after them."""
    jax_entries = jax_registry.IMAGE_BACKBONES._entries
    saved = {name: (jax_entries[name], registry.IMAGE_BACKBONES[name])
             for name in REDUCED}
    for name, (jax_cls, port_cls, kw) in REDUCED.items():
        jax_entries[name] = functools.partial(jax_cls, **kw)
        registry.IMAGE_BACKBONES[name] = functools.partial(port_cls, **kw)
    yield
    for name, (jax_fn, port_fn) in saved.items():
        jax_entries[name] = jax_fn
        registry.IMAGE_BACKBONES[name] = port_fn


CASES = [f"image-{name}" for name in REDUCED]


@pytest.mark.parametrize("case", CASES)
def test_logits_match_jax(case):
    check_logits(case)


@pytest.mark.parametrize("case", ["image-resnet18", "image-resnet50"])
def test_train_step_matches_jax(case):
    check_train_step(case)


def _jax_bn_outputs(case):
    """JAX's train-mode BatchNorm outputs on the step's batch, by the
    port's module name, NCHW."""
    jmodel, _ = _jax_model(case)
    variables = _jax_run(case)["variables"]
    _, captured = jmodel.apply(
        variables, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, method: isinstance(
            mdl, fnn.BatchNorm) and method == "__call__",
        rngs={"dropout": jax.random.key(1)}, **_inputs(case, 3))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            captured["intermediates"])[0]:
        keys = tuple(k.key for k in path if hasattr(k, "key"))
        out[_module_name(keys[:-1])] = np.asarray(leaf).transpose(0, 3, 1, 2)
    return out


def test_densenet_step_matches_jax_on_its_relu_sides():
    case = "image-densenet121"
    sides = _jax_bn_outputs(case)
    mirrored = []

    def to_jax_side(name):
        def hook(module, inputs, out):
            if not module.training:  # the eval step: nothing captured
                return out
            want = torch.from_numpy(sides[name] > 0)
            wrong = want != (out.detach() > 0)
            if wrong.any():
                assert out.detach()[wrong].abs().max() < KINK, name
                mirrored.append((name, int(wrong.sum())))
            # the value mirrored through 0, the gradient kept
            return out - 2 * torch.where(wrong, out.detach(), 0.0)
        return hook

    def prepare(model):
        bns = {n: m for n, m in model.named_modules()
               if isinstance(m, BatchNorm)}
        assert set(bns) == set(sides)
        for name, module in bns.items():
            module.register_forward_hook(to_jax_side(name))

    check_train_step(case, prepare, loose=STEM_SCALE)
    assert mirrored  # this batch has pre-activations at a kink
