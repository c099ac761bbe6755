"""npz pretrained weights in the port (``models/pretrained.py``,
``convert.to_flax``, ``train/drivers.py``'s ``_maybe_load_pretrained``)
against the JAX package's ``models/pretrained.py`` and its driver's
``_maybe_load_pretrained``, on the CPU, for the resnet18 image classifier
(full depth, random weights from ``jax.eval_shape``, nothing compiled)
and a BatchNorm-free ViT one:

* an npz written by JAX's ``save_params_npz`` (a ``params/`` and a
  ``batch_stats/`` subtree of the backbone, a kernel of another shape, an
  unknown key, bare keys): the port's ``loaded`` / ``skipped`` /
  ``missing`` equal JAX's, and its merged state dict is JAX's merged
  tree through ``convert.from_flax``, bit for bit;
* an npz from JAX's ``convert_to_npz`` (timm weights, here synthesized)
  with its default prefix ``image_encoder/backbone``: JAX's classifier
  tree names the encoder after its backbone (``resnet18/backbone``), so
  nothing loads (``loaded`` 0, every key skipped) in JAX, and the port
  gives the same counts; with the prefix ``resnet18/backbone`` every
  backbone leaf loads in both;
* ``strict`` raises the same ``KeyError`` in both;
* a model without BatchNorm skips ``batch_stats/`` keys in both and keeps
  its (empty) statistics;
* the drivers: ``pretrained: true`` with a path merges the npz into the
  masters and statistics before the train state is made, printing JAX's
  line; ``pretrained`` unset loads nothing even with a path, as in JAX;
* ``flatten_params`` / ``unflatten_params`` / ``save_params_npz`` round
  trip as JAX's.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models import build as jax_build
from multimodal_plankton_recognition_tpu.models import (
    pretrained as jax_pretrained,
)
from multimodal_plankton_recognition_tpu.models.convert_timm import (
    convert_to_npz, synthesize_state_dict,
)
from multimodal_plankton_recognition_tpu.train import drivers as jax_drivers
from multimodal_plankton_recognition_tpu.train.state import (
    TrainState as JaxTrainState,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models import build, pretrained
from multimodal_plankton_recognition_torch.train import drivers

from test_torch_classifier import _random_variables
from torch_threads import one_thread  # noqa: F401  (autouse)

NAMES = [f"c{i}" for i in range(5)]
RESNET = {"image_encoder_args": {"name": "resnet18"},
          "trainer_args": {"precision": "32"}}
VIT = {"image_encoder_args": {
    "name": "vit_tiny_patch16_224", "fused_attention": True,
    "backbone_kwargs": {"img_size": 32, "depth": 2, "embed_dim": 48,
                        "num_heads": 3}},
    "target_size": 32, "trainer_args": {"precision": "32"}}


def _models(d, seed=1):
    """(JAX classifier variables, port classifier with them loaded)."""
    size = d.get("target_size", 224)
    jmodel = jax_build.build_image_classifier(
        jax_config.ModelCard.from_dict(copy.deepcopy(d)), NAMES)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), image=np.zeros((2, size, size, 1), np.float32),
        image_shape=np.ones((2, 2), np.int32)))
    variables = _random_variables(dict(shapes), seed)
    model = build.build_image_classifier(
        config.ModelCard.from_dict(copy.deepcopy(d)), NAMES)
    model.load_state_dict(from_flax(variables), strict=True)
    return variables, model


def _jax_merge(variables, path, strict=False):
    return jax_pretrained.load_pretrained_npz(
        variables["params"], path, strict,
        batch_stats=variables.get("batch_stats", {}))


def _same(got, want_params, want_stats):
    want = from_flax({"params": want_params,
                      **({"batch_stats": want_stats} if want_stats else {})})
    assert sorted(got) == sorted(want)
    for n, t in want.items():
        assert torch.equal(got[n], t), n


def _backbone_npz(path, variables, other):
    """A ``save_params_npz`` file: ``other``'s stage-1 block under
    ``params/`` and ``batch_stats/``, its stem bare, an fc kernel of
    another shape, an unknown key."""
    backbone = other["params"]["resnet18"]["backbone"]
    stats = other["batch_stats"]["resnet18"]["backbone"]
    tree = {"params": {"resnet18": {"backbone": {
                "stage1_block0": backbone["stage1_block0"]}},
                       "fc": {"kernel": np.zeros((7, 5), np.float32)}},
            "batch_stats": {"resnet18": {"backbone": {
                "stage1_block0": stats["stage1_block0"]}}},
            "resnet18": {"backbone": {"stem_conv": backbone["stem_conv"]}},
            "nope": {"kernel": np.ones((3,), np.float32)}}
    jax_pretrained.save_params_npz(tree, path)
    return path


def test_save_params_npz_merge_matches_jax(tmp_path):
    variables, model = _models(RESNET)
    other, _ = _models(RESNET, seed=2)
    path = _backbone_npz(tmp_path / "w.npz", variables, other)
    params, stats_tree, want = _jax_merge(variables, path)
    got_sd, got = pretrained.load_pretrained_into(model, path)
    assert got == want and want["loaded"] > 0 and want["skipped"] == 2
    _same(got_sd, params, stats_tree)
    stem = got_sd["image_encoder.backbone.stem_conv.weight"]
    assert not torch.equal(stem, model.state_dict()[
        "image_encoder.backbone.stem_conv.weight"])
    with pytest.raises(KeyError, match="npz key") as jax_error:
        _jax_merge(variables, path, strict=True)
    with pytest.raises(KeyError, match="npz key") as port_error:
        pretrained.load_pretrained_into(model, path, strict=True)
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("prefix", ["image_encoder/backbone",
                                    "resnet18/backbone"],
                         ids=["default", "tree"])
def test_convert_to_npz_counts_match_jax(prefix, tmp_path):
    variables, model = _models(RESNET)
    backbone = variables["params"]["resnet18"]["backbone"]
    stats = variables["batch_stats"]["resnet18"]["backbone"]
    sd = synthesize_state_dict("resnet18", backbone, stats, src_in_chans=3)
    src = tmp_path / "w.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    out = tmp_path / "w.npz"
    counts = convert_to_npz("resnet18", str(src), str(out), in_chans=1,
                            prefix=prefix)
    params, stats_tree, want = _jax_merge(variables, out)
    got_sd, got = pretrained.load_pretrained_into(model, out)
    assert got == want
    n = counts["params"] + counts["batch_stats"]
    if prefix == "image_encoder/backbone":
        # the finding: the default prefix names no path of the tree
        assert want == {"loaded": 0, "skipped": n,
                        "missing": want["missing"]}
        assert all(torch.equal(got_sd[k], v)
                   for k, v in model.state_dict().items())
    else:
        assert want["loaded"] == n and want["skipped"] == 0
    _same(got_sd, params, stats_tree)


def test_batch_norm_free_model_skips_statistics(tmp_path):
    variables, model = _models(VIT)
    path = tmp_path / "w.npz"
    np.savez(path, **{
        "batch_stats/vit_tiny_patch16_224/backbone/x/mean": np.zeros(3),
        "params/fc/bias": np.full(5, 0.5, np.float32)})
    params, stats_tree, want = _jax_merge(variables, path)
    got_sd, got = pretrained.load_pretrained_into(model, path)
    assert got == want == {"loaded": 1, "skipped": 1,
                           "missing": want["missing"]}
    assert stats_tree == {} and not list(model.buffers())
    _same(got_sd, params, None)
    assert torch.equal(got_sd["fc.bias"], torch.full((5,), 0.5))


@pytest.mark.parametrize("pretrained_flag", [True, False])
def test_drivers_load_as_jax(pretrained_flag, tmp_path, capsys):
    variables, _ = _models(RESNET)
    other, _ = _models(RESNET, seed=2)
    path = _backbone_npz(tmp_path / "w.npz", variables, other)
    d = copy.deepcopy(RESNET)
    d["image_encoder_args"].update(pretrained=pretrained_flag,
                                   pretrained_path=str(path))
    jstate = JaxTrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=None)
    jstate = jax_drivers._maybe_load_pretrained(
        jstate, jax_config.ModelCard.from_dict(copy.deepcopy(d)))
    jax_line = capsys.readouterr().out
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    masters = from_flax(variables)
    got = drivers._maybe_load_pretrained(card, masters, "image", NAMES)
    assert capsys.readouterr().out == jax_line
    assert bool(jax_line) == pretrained_flag
    _same(got, jstate.params, jstate.batch_stats)
    # the train state is made from them
    model, _, state = drivers.multi_state(card, "cpu", kind="image",
                                          class_names=NAMES)
    init = drivers._maybe_load_pretrained(
        card, drivers.init_masters(card, "image", NAMES), "image", NAMES)
    for n, m in state.params.items():
        assert torch.equal(m, init[n]), n
    for n, b in state.batch_stats.items():
        assert torch.equal(b, init[n]), n


def test_flatten_round_trip_as_jax(tmp_path):
    tree = {"a": {"b": np.arange(3.0), "c": {"d": np.ones((2, 2))}},
            "e": np.zeros(1)}
    flat = pretrained.flatten_params(tree)
    assert flat.keys() == jax_pretrained.flatten_params(tree).keys()
    assert pretrained.unflatten_params(flat).keys() == tree.keys()
    pretrained.save_params_npz(tree, tmp_path / "port.npz")
    jax_pretrained.save_params_npz(tree, tmp_path / "jax.npz")
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
