"""The supervised classifiers' drivers (``train/drivers.py``
``train_image`` / ``train_profile`` and their CLIs), their host layers
(``data/transforms.py`` ``ImageTransforms`` / ``ProfileTransform``,
``data/pipeline.py`` ``ImageCollate`` / ``ProfileCollate``), the
classifier checkpoints (``load_from_checkpoint``, the bridge) and the
predict path (``retrieval/encode.py`` ``predict_classifier``,
``scripts/encode_torch.py --logits``) against the JAX package's, on the
CPU:

* the raw transforms bit for bit on the same numpy generator, which each
  leaves in the same state; the collates equal;
* both drivers for 2 epochs on the synthetic dataset with tiny f32 cards:
  ``valid_acc`` in the history, the checkpoint's kind, monitor and mode,
  and ``test_acc`` equal to the argmax accuracy of ``predict_classifier``
  on the best checkpoint;
* (``tests/test_torch_classifier_bridge.py``: a JAX ``train_image``
  checkpoint bridged, predicted and written by ``--logits`` as JAX's;)
* the module-6 encoders (ResNet, DenseNet, the LSTM) train one epoch
  through both drivers; the default device is the card;
* ``chip_smoke.py``'s ``IMAGE_CARD`` and ``PROFILE_CARD`` literals equal
  their YAML files, and build as the JAX package builds them.
"""

import copy
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.data import dataset as jax_dataset
from multimodal_plankton_recognition_tpu.data import pipeline as jax_pipeline
from multimodal_plankton_recognition_tpu.data import tokenize as jax_tokenize
from multimodal_plankton_recognition_tpu.data import (
    transforms as jax_transforms,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.data import dataset, pipeline
from multimodal_plankton_recognition_torch.data import tokenize, transforms
from multimodal_plankton_recognition_torch.models.classifier import (
    ImageClassifier, ProfileClassifier,
)
from multimodal_plankton_recognition_torch.retrieval.encode import (
    eval_pipeline, predict_classifier,
)
from multimodal_plankton_recognition_torch.train import drivers
from multimodal_plankton_recognition_torch.train.checkpoint import (
    load_from_checkpoint, read_metadata,
)
from multimodal_plankton_recognition_torch.utils import LabelVocab
from torch_threads import single_thread

REPO = Path(__file__).resolve().parent.parent
TS = 32
IMAGE_SIZES = [(60, 90), (130, 70), (80, 80), (200, 41)]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_state(a, b):
    assert a.bit_generator.state == b.bit_generator.state


# --- the raw transforms and the collates, bit for bit ---------------------


def _image(h, w, seed, rgb=False):
    rs = np.random.RandomState(seed)
    arr = rs.randint(0, 256, (h, w), np.uint8)
    arr[:, :3] = 200  # a dominant rim value: the mode
    if rgb:
        return np.repeat(arr[..., None], 3, axis=2)
    return Image.fromarray(arr, mode="L")


@pytest.mark.parametrize("target", [TS, None], ids=["resized", "native"])
@pytest.mark.parametrize("size", IMAGE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_image_transforms_match_jax(size, target):
    """The scale bar's noise, then the padding's (none when square), from
    the caller's generator; a PIL image, and an RGB array through
    ``to_grayscale``."""
    for rgb in (False, True):
        img = _image(*size, seed=size[0], rgb=rgb)
        g_port, g_jax = np.random.default_rng(5), np.random.default_rng(5)
        got = transforms.ImageTransforms(target)(img, g_port)
        want = jax_transforms.ImageTransforms(target)(img, g_jax)
        side = target or max(size)
        assert got.shape == (side, side, 1) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        _same_state(g_port, g_jax)


def test_image_helpers_match_jax():
    arr = np.asarray(_image(70, 110, seed=1))
    bg, std = transforms.find_background_stats(arr)
    jbg, jstd = jax_transforms.find_background_stats(arr)
    np.testing.assert_array_equal(bg, jbg)
    np.testing.assert_array_equal(std, jstd)
    for fn in ("cover_scale", "pad_image_to_square"):
        got = getattr(transforms, fn)(arr, bg, std,
                                      np.random.default_rng(0))
        want = getattr(jax_transforms, fn)(arr, bg, std,
                                           np.random.default_rng(0))
        np.testing.assert_array_equal(got, want)
    rgb = np.asarray(_image(20, 30, seed=2, rgb=True))
    np.testing.assert_array_equal(transforms.to_grayscale(rgb),
                                  jax_transforms.to_grayscale(rgb))


@pytest.mark.parametrize("max_len", [None, 0, 32, 256])
def test_profile_transform_matches_jax(max_len):
    for length in (1, 31, 32, 400):
        prof = np.random.RandomState(length).gamma(2.0, 300.0, (length, 6))
        got = transforms.ProfileTransform(max_len)(prof)
        want = jax_transforms.ProfileTransform(max_len)(prof)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _sets(split, kind):
    """The driver's train sets of both packages for a kind."""
    image_tf = (transforms.ImageTransforms(TS),
                jax_transforms.ImageTransforms(TS))
    max_len = 32 if kind == "profile" else 0
    profile_tf = (transforms.ProfileTransform(max_len),
                  jax_transforms.ProfileTransform(max_len))
    return (dataset.MultiSet(split / "train.csv", image_tf[0], profile_tf[0],
                             transforms.PairAugmentation()),
            jax_dataset.MultiSet(split / "train.csv", image_tf[1],
                                 profile_tf[1],
                                 jax_transforms.PairAugmentation()))


@pytest.mark.parametrize("kind", ["image", "profile-transformer",
                                  "profile-cnn"])
def test_items_and_collates_match_jax(kind, synthetic_dataset):
    port_set, jax_set = _sets(Path(synthetic_dataset), kind.split("-")[0])
    vocab = LabelVocab(port_set.class_names)
    np.testing.assert_array_equal(port_set.class_names, jax_set.class_names)
    samples = {"port": [], "jax": []}
    for i in range(len(port_set)):
        g_port, g_jax = np.random.default_rng(i), np.random.default_rng(i)
        samples["port"].append(port_set.__getitem__(i, g_port))
        samples["jax"].append(jax_set.__getitem__(i, g_jax))
        _same_state(g_port, g_jax)
    if kind == "image":
        collates = (pipeline.image_collate_fn(vocab),
                    jax_pipeline.image_collate_fn(vocab))
    else:
        enc = kind.split("-")[1]
        pad_to = 33 if enc == "transformer" else 32
        collates = (pipeline.profile_collate_fn(
            tokenize.get_tokenizer(enc, 32, pad_to), vocab),
            jax_pipeline.profile_collate_fn(
                jax_tokenize.get_tokenizer(enc, 32, pad_to), vocab))
    for start in range(0, len(port_set), 5):
        got = collates[0](samples["port"][start:start + 5])
        want = collates[1](samples["jax"][start:start + 5])
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --- the drivers, on the CPU ----------------------------------------------


def _card(kind="image", **overrides) -> dict:
    """A tiny f32 classifier card: a 2-block ViT 48 wide at 32 px, or a
    2-layer profile transformer 64 wide over max_len 32; bs 4, dropout
    0.1."""
    d = {"bs": 4, "target_size": TS, "max_len": 32, "num_workers": 2,
         "save_top_k": 1, "patience": 5,
         "optim_args": {"lr": 5e-2, "momentum": 0.9, "weight_decay": 1e-3,
                        "nesterov": True},
         "trainer_args": {"precision": "32", "min_epochs": 1,
                          "max_epochs": 2}}
    if kind == "image":
        d["image_encoder_args"] = {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": 0.1,
            "backbone_kwargs": {"img_size": TS, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}}
    else:
        d["profile_encoder_args"] = {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": 32,
            "dim_feedforward": 96, "fused_attention": True, "dropout": 0.1}
    d.update(overrides)
    return d


def _write_card(path: Path, d: dict) -> Path:
    path.write_text(json.dumps(d))
    return path


@pytest.fixture(scope="module")
def trained(synthetic_dataset, tmp_path_factory):
    """Both port drivers, 2 epochs each: the image one through its CLI."""
    tmp = tmp_path_factory.mktemp("classifier_drivers")
    out = {"tmp": tmp}
    image_card = _write_card(tmp / "tiny_image.json", _card("image"))
    out["image"] = _script("train_image_torch").main(
        ["-d", str(synthetic_dataset), "-m", str(image_card), "-l",
         str(tmp / "image"), "--device", "cpu"])
    out["profile"] = drivers.train_profile(
        synthetic_dataset, config.ModelCard.from_dict(_card("profile")),
        logdir=tmp / "profile", device="cpu")
    return out


@pytest.mark.parametrize("kind", ["image", "profile"])
def test_driver_trains_and_tests_the_best_checkpoint(kind, trained,
                                                     synthetic_dataset):
    result = trained[kind]
    history = result["history"]
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert {"train_loss", "valid_loss", "valid_acc",
                "samples_per_sec"} <= set(h)
        assert np.isfinite(h["train_loss"]) and 0 <= h["valid_acc"] <= 1
    assert result["state"].step == 2 * 12 // 4
    ckpt = Path(result["logdir"]) / "checkpoints"
    meta = read_metadata(ckpt)
    assert (meta["kind"], meta["_monitor"], meta["_mode"]) \
        == (kind, "valid_acc", "max")
    assert meta["class_names"] == ["genus_0", "genus_1", "genus_2"]
    # top-1 by valid_acc, the later epoch on a tie (orbax's rule)
    accs = [h["valid_acc"] for h in history]
    assert result["best_step"] == max(range(2), key=lambda e: (accs[e], e))
    model, payload, _ = load_from_checkpoint(ckpt, device="cpu")
    assert isinstance(model, ImageClassifier if kind == "image"
                      else ProfileClassifier)
    assert model.fc.out_features == 3
    assert payload["step"] == 3 * (result["best_step"] + 1)
    pred = predict_classifier(ckpt, Path(synthetic_dataset) / "test.csv",
                              batch_size=5, num_workers=1, device="cpu")
    assert pred["logits"].shape == (12, 3)
    np.testing.assert_array_equal(pred["classes"], meta["class_names"])
    acc = float((pred["classes"][pred["logits"].argmax(1)]
                 == pred["label"]).mean())
    assert result["test_acc"] == acc
    lines = (Path(result["logdir"]) / "metrics.jsonl").read_text()
    records = [json.loads(x) for x in lines.splitlines()]
    assert records[-1] == {"step": 0, "test_acc": acc}


def test_eval_pipelines_of_the_classifier_kinds():
    card = config.ModelCard.from_dict(_card("profile", max_len=None))
    image_tf, profile_tf, tok = eval_pipeline(card, "profile")
    assert isinstance(image_tf, transforms.ImageTransforms)
    assert profile_tf.max_len is None and tok.pad_to == 257
    card = config.ModelCard.from_dict(_card("profile"))
    _, profile_tf, tok = eval_pipeline(card, "image")
    assert profile_tf.max_len == 0 and tok.pad_to is None
    _, profile_tf, tok = eval_pipeline(card, "profile")
    assert profile_tf.max_len == 32 and tok.pad_to == 33


@pytest.mark.parametrize("kind,args", [
    ("image", {"name": "resnet18"}),
    ("image", {"name": "densenet121"}),
    ("profile", {"kind": "lstm", "dim_in": 6, "dim_hidden": 16,
                 "num_layers": 1}),
], ids=["resnet18", "densenet121", "lstm"])
def test_module_6_cards_raise_before_any_step(kind, args, synthetic_dataset,
                                              tmp_path, monkeypatch):
    """Named for the refusals these cards met before queue 1 module 6 was
    ported: each driver now trains one epoch of them on the CPU (32 px,
    max_len 32, bs 4, one PyTorch thread), every step through
    ``make_classifier_steps``, and writes its run directory and test
    accuracy."""
    steps = []
    real = drivers.make_classifier_steps

    def spy(*a, **k):
        train_step, eval_step = real(*a, **k)

        def counted(state, batch, seed):
            steps.append(batch["label"].shape[0])
            return train_step(state, batch, seed)
        return counted, eval_step

    monkeypatch.setattr(drivers, "make_classifier_steps", spy)
    d = _card(kind)
    d[f"{kind}_encoder_args"] = copy.deepcopy(args)
    train = drivers.train_image if kind == "image" else drivers.train_profile
    with single_thread():
        out = train(synthetic_dataset, config.ModelCard.from_dict(d),
                    logdir=tmp_path, max_epochs=1, device="cpu")
    assert steps and set(steps) == {4} and out["state"].step == len(steps)
    assert np.isfinite(out["history"][0]["train_loss"])
    assert 0.0 <= out["test_acc"] <= 1.0
    assert (Path(out["logdir"]) / "metrics.jsonl").is_file()


@pytest.mark.parametrize("overrides,error,match", [
    ({"loader": "grain", "num_workers": 0}, None, None),
    ({"mesh": {"data": 2}}, ValueError, "torchrun --nproc_per_node 2"),
], ids=["grain", "mesh"])
def test_driver_refusals(overrides, error, match, synthetic_dataset,
                         tmp_path):
    """``loader: grain`` (ported: ``data.grain_pipeline``) trains, with
    the history of ``loader: threads``; a ``mesh`` of two processes in a
    run of one names the launch that gives them."""
    d = _card("profile", **overrides)
    if error is None:
        histories = []
        for loader in ("grain", "threads"):
            d["loader"] = loader
            with single_thread():
                out = drivers.train_profile(
                    synthetic_dataset, config.ModelCard.from_dict(d),
                    logdir=tmp_path / loader, max_epochs=1, device="cpu")
            histories.append([{k: v for k, v in h.items()
                               if k != "samples_per_sec"}
                              for h in out["history"]])
        assert histories[0] == histories[1]
        return
    with pytest.raises(error, match=match):
        drivers.train_profile(synthetic_dataset,
                              config.ModelCard.from_dict(d),
                              logdir=tmp_path, device="cpu")
    assert not any(tmp_path.iterdir())


def test_default_device_is_the_card(synthetic_dataset, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for train in (drivers.train_image, drivers.train_profile):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train(synthetic_dataset, config.ModelCard.from_dict(_card()),
                  logdir=tmp_path)
    ckpt = tmp_path / "ckpt"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        predict_classifier(ckpt, "unused.csv")
    assert not any(tmp_path.iterdir())


def test_smoke_classifier_literals_are_the_yaml_cards():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for literal, path in ((smoke.IMAGE_CARD, "image/vit_tiny_16.yaml"),
                          (smoke.PROFILE_CARD,
                           "profile/transformer_2.yaml")):
        want = yaml.safe_load((REPO / "model_cards" / path).read_text())
        assert literal == want, path
        card = config.ModelCard.from_dict(copy.deepcopy(literal))
        jcard = jax_config.ModelCard.from_dict(copy.deepcopy(literal))
        assert card.to_dict() == jcard.to_dict()
        assert card.trainer_args.compute_dtype == "bfloat16"
    assert smoke.PROFILE_CARD["max_len"] + 1 == smoke.SHAPES["cls profile"][1]
