"""The module-6 image backbones (``models/image/resnet.py``,
``models/image/densenet.py``) against the JAX package's modules, on
weights converted by ``convert.py`` from random Flax variables, with
inputs from a numpy seed, and the six shipped module-6 cards' trees:

* features of ResNet (basic and bottleneck blocks, one a stage) and
  DenseNet (two layers a block) at 32 px, B 8, eval and train mode, and
  the updated running statistics, in f32: within 1e-4 of max(1, |·|);
* the same in bf16 (JAX's module at ``dtype=bfloat16``): the features
  within a relative L2 error of 3e-2 (eval) and 0.1 (train mode, where
  B 8 leaves the last stages' BatchNorms 8-32 values a channel, which
  magnify every rounding); the two frameworks round bf16 convolutions
  and sums at different points (measured on this CPU: at most 1.8e-2
  eval, 2.5e-2 to 7.9e-2 train);
* DenseNet's 2 x 2 average pool against flax's ``avg_pool``: bf16 bit
  for bit, odd sizes too (flax's window sum rounds after each add in
  order, which ``avg_pool2d``'s single rounding would not match); f32
  within 1e-6 on unit-scale inputs (XLA's CPU pool pairs the adds at some
  shapes);
* full depth, nothing compiled: for each of the six shipped cards
  (resnet18, resnet50, densenet121, densenet169, lstm_1, lstm_2) the
  port classifier's state dict has exactly the keys and shapes that
  ``convert.from_flax`` gives for JAX's tree (``jax.eval_shape`` of its
  init), loads it strictly, and ``convert.to_flax`` gives JAX's tree back;
* ``chip_smoke.py``'s ``BACKBONE_CARDS`` literals equal their YAML
  files.

The reduced-depth classifier train steps are in
``tests/test_torch_backbone_steps.py``; the LSTM's parity in
``tests/test_torch_lstm.py``.
"""

import copy
import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models import build as jax_build
from multimodal_plankton_recognition_tpu.models.image import (
    densenet as jax_densenet, resnet as jax_resnet,
)
from multimodal_plankton_recognition_tpu.models.image.registry import (
    create_backbone as jax_create_backbone,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax, to_flax
from multimodal_plankton_recognition_torch.models import build
from multimodal_plankton_recognition_torch.models.image import (
    densenet, resnet,
)

from test_torch_classifier import _random_variables
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 1e-4
BF16_EVAL_REL, BF16_TRAIN_REL = 3e-2, 0.1
F32_POOL_TOL = 1e-6
B = 8
MODULES = {
    "resnet-basic": (jax_resnet.ResNet, resnet.ResNet,
                     {"stage_sizes": (1, 1, 1, 1)}),
    "resnet-bottleneck": (jax_resnet.ResNet, resnet.ResNet,
                          {"stage_sizes": (1, 1, 1, 1), "bottleneck": True}),
    "densenet": (jax_densenet.DenseNet, densenet.DenseNet,
                 {"block_config": (2, 2, 2, 2)}),
}
NUM_FEATURES = {"resnet18": 512, "resnet50": 2048, "densenet121": 1024,
                "densenet169": 1664}
CARDS = {"resnet18": "image", "resnet50": "image", "densenet121": "image",
         "densenet169": "image", "lstm_1": "profile", "lstm_2": "profile"}


def _image(seed=0):
    return np.random.RandomState(seed).randn(B, 32, 32, 1).astype(np.float32)


def _pair(name, dtype=jnp.float32):
    """(JAX module at ``dtype``, its random variables, the port module
    with them loaded, in f32)."""
    jax_cls, port_cls, kw = MODULES[name]
    jm = jax_cls(dtype=dtype, **kw)
    variables = _random_variables(dict(jax.eval_shape(
        lambda: jm.init(jax.random.key(0), _image(), train=False))))
    pm = port_cls(**kw)
    pm.load_state_dict(from_flax(variables), strict=True)
    return jm, variables, pm


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", MODULES)
def test_features_match_jax_f32(name):
    jm, variables, pm = _pair(name)
    x = _image(1)
    evaluate = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    train = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                          mutable=["batch_stats"]))
    _close(pm.eval()(torch.from_numpy(x)), evaluate(variables, x), F32_TOL,
           f"{name} eval")
    want, updated = train(variables, x)
    _close(pm.train()(torch.from_numpy(x)), want, F32_TOL, f"{name} train")
    stats = from_flax({"params": {}, **jax.tree.map(np.asarray, updated)})
    buffers = dict(pm.named_buffers())
    assert sorted(stats) == sorted(buffers)
    for n, want_stat in stats.items():
        _close(buffers[n], want_stat.numpy(), F32_TOL, n)


@pytest.mark.parametrize("name", MODULES)
def test_features_match_jax_bf16(name):
    jm, variables, pm = _pair(name, jnp.bfloat16)
    pm = pm.to(torch.bfloat16)
    x = _image(2)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    got = pm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got, want) <= BF16_EVAL_REL
    want, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = pm.train()(torch.from_numpy(x))
    assert _rel(got, want) <= BF16_TRAIN_REL
    assert all(b.dtype == torch.float32 for b in pm.buffers())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [(8, 8), (7, 9)], ids=["even", "odd"])
def test_avg_pool_matches_flax(size, dtype):
    x = np.random.RandomState(3).randn(4, *size, 16).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(fnn.avg_pool(xj, (2, 2), strides=(2, 2)), np.float32)
    t = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = densenet._avg_pool_2x2(t.permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    if dtype == jnp.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_POOL_TOL)


def _yaml(label):
    kind = CARDS[label]
    return yaml.safe_load((REPO / "model_cards" / kind /
                           f"{label}.yaml").read_text())


@pytest.mark.parametrize("label", CARDS)
def test_full_depth_trees_match_jax(label):
    """The shipped card's classifier, as both packages build it."""
    kind = CARDS[label]
    d = _yaml(label)
    names = [f"c{i}" for i in range(5)]
    jmodel = getattr(jax_build, f"build_{kind}_classifier")(
        jax_config.ModelCard.from_dict(copy.deepcopy(d)), names)
    if kind == "image":
        inputs = {"image": jnp.zeros((2, 224, 224, 1)),
                  "image_shape": jnp.ones((2, 2), jnp.int32)}
    else:
        inputs = {"profile": jnp.zeros((2, 256, 6)),
                  "last_idx": jnp.array([255, 10]),
                  "profile_len": jnp.ones((2, 1), jnp.int32)}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                **inputs))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        dict(shapes))
    model = getattr(build, f"build_{kind}_classifier")(
        config.ModelCard.from_dict(copy.deepcopy(d)), names,
        dtype=torch.float32)
    converted = from_flax(tree)
    want = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert {n: tuple(t.shape) for n, t in converted.items()} == want
    model.load_state_dict(converted, strict=True)
    back = to_flax(model)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, tree)
    if kind == "image":
        assert model.image_encoder.backbone.num_features == \
            jax_create_backbone(label).num_features == NUM_FEATURES[label]


def test_smoke_backbone_literals_are_the_yaml_cards():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sorted(smoke.BACKBONE_CARDS) == sorted(CARDS)
    for label, (kind, literal) in smoke.BACKBONE_CARDS.items():
        assert kind == CARDS[label]
        assert literal == _yaml(label), label
        card = config.ModelCard.from_dict(copy.deepcopy(literal))
        assert card.trainer_args.compute_dtype == "bfloat16"
