"""The port's train driver (``train/drivers.py``: ``train_multi``) and its
CLI (``scripts/train_multi_torch.py``) against the JAX package's.

* Resume parity: the JAX ``train_multi`` trains a tiny f32 ViT +
  ProfileTransformer CLIP card (dropout 0, the CSV path with the random
  train transforms, so every draw is numpy's) for one epoch; its orbax
  checkpoint goes through ``scripts/checkpoint_from_jax.py``; then the
  JAX driver resumes from the orbax directory and the port's from the
  bridged one, 2 epochs each. Each epoch's train and valid loss within
  1e-4 relative, the same step, best step and run directory, every
  master's update since the resume within 1e-3 relative L2 (the f32
  bound of ``test_torch_card.py``).
* The seeded init (``models.initializers``) against the JAX package's
  ``model.init`` of the same card, by statistics: the same names and
  shapes, each tensor's mean and std within 6 σ/sqrt(n) of JAX's (σ
  JAX's std), constants equal, and no draw beyond 2.5 σ (a truncated normal or a
  uniform) where JAX has none.
* The driver's other branches and refusals, its profile of epoch 0, and
  the CLI end to end, on the CPU.
"""

import copy
import importlib.util
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models.build import (
    build_multi_model as jax_build_multi_model,
)
from multimodal_plankton_recognition_tpu.train.drivers import (
    train_multi as jax_train_multi,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.data.packed import pack_split
from multimodal_plankton_recognition_torch.data.synthetic import (
    make_synthetic_dataset,
)
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.flagships import (
    synthetic_batch_b0,
)
from multimodal_plankton_recognition_torch.train import drivers
from multimodal_plankton_recognition_torch.train.checkpoint import (
    CheckpointManager,
)
from torch_threads import single_thread
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
TS = 32
LOSS_TOL, UPDATE_TOL = 1e-4, 1e-3
SIGMAS = 6.0
# a normal truncated at ±2 draws nothing beyond 2.274 std, a plain one 1.2%
# of its draws beyond 2.5 (none of 1,000 with odds of 4e-6)
TAIL = 2.5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _card(**overrides) -> dict:
    """A tiny f32 card: 32 px, 2 ViT blocks 48 wide, a 64-wide profile
    transformer over 32 steps, CLIP, bs 4 in 2 buckets, dropout 0."""
    d = {
        "bs": 4, "buckets": 2, "target_size": TS, "dim_embedding": 32,
        "num_workers": 2, "save_top_k": 2, "patience": 5,
        "image_encoder_args": {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": 0.0,
            "backbone_kwargs": {"img_size": TS, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        "profile_encoder_args": {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": TS,
            "dim_feedforward": 96, "fused_attention": True, "dropout": 0.0},
        "coordination_args": {"method": "clip"},
        "optim_args": {"lr": 5e-2, "momentum": 0.9, "weight_decay": 1e-3,
                       "nesterov": True},
        "trainer_args": {"precision": "32", "min_epochs": 1,
                         "max_epochs": 2},
    }
    d.update(overrides)
    return d


def _b0_card(**overrides) -> dict:
    """A small-input B0 card: EfficientNet-B0 + ProfileCNN at 32 px."""
    d = _card(**overrides)
    d["image_encoder_args"] = {"name": "efficientnet_b0", "in_chans": 1,
                               "metadata": True, "dropout": 0.0}
    d["profile_encoder_args"] = {"kind": "cnn", "dim_in": 6,
                                 "blocks": [1, 1, 1, 1], "base_channels": 8,
                                 "dropout": 0.0}
    return d


def _write_card(path: Path, d: dict) -> Path:
    path.write_text(json.dumps(d))
    return path


def _rel(logdir, root):
    return Path(logdir).relative_to(root)


# --- resume parity with the JAX driver -------------------------------------


@pytest.fixture(scope="module")
def resumed(synthetic_dataset, tmp_path_factory):
    """The JAX run of one epoch, its bridged checkpoint, and both drivers
    resumed from it for 2 epochs."""
    tmp = tmp_path_factory.mktemp("drivers_resume")
    card_path = _write_card(tmp / "tiny.json", _card())
    first = jax_train_multi(synthetic_dataset, card_path,
                            logdir=tmp / "first", max_epochs=1)
    jax_ckpt = Path(first["logdir"]) / "checkpoints"
    port_ckpt = tmp / "bridged"
    _script("checkpoint_from_jax").bridge(jax_ckpt, port_ckpt)
    want = jax_train_multi(synthetic_dataset, card_path,
                           logdir=tmp / "jax", max_epochs=2,
                           resume=str(jax_ckpt))
    got = drivers.train_multi(synthetic_dataset, card_path,
                              logdir=tmp / "port", max_epochs=2,
                              resume=port_ckpt, device="cpu")
    start = CheckpointManager(port_ckpt, save_top_k=0).restore()
    return {"tmp": tmp, "want": want, "got": got, "start": start,
            "jax_ckpt": jax_ckpt, "card_path": card_path,
            "data": Path(synthetic_dataset)}


def test_resume_matches_jax(resumed):
    want, got, tmp = resumed["want"], resumed["got"], resumed["tmp"]
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"]
        for key in ("train_loss", "valid_loss"):
            assert math.isfinite(g[key])
            assert abs(g[key] - w[key]) <= LOSS_TOL * abs(w[key]), (g, w)
    steps_per_epoch = 12 // 4
    assert resumed["start"]["step"] == steps_per_epoch
    assert got["state"].step == int(want["state"].step) \
        == 3 * steps_per_epoch
    assert got["best_step"] == want["best_step"]
    name = "tiny_" + "_".join(resumed["data"].parts[-2:])
    assert _rel(got["logdir"], tmp / "port") \
        == _rel(want["logdir"], tmp / "jax") == Path(name) / "version_0"


def test_resumed_masters_update_as_jax(resumed):
    start = resumed["start"]["params"]
    jax_params = from_flax({"params": jax.tree.map(
        np.asarray, resumed["want"]["state"].params)})
    port_params = resumed["got"]["state"].params
    assert port_params.keys() == jax_params.keys() == start.keys()
    errs = {}
    for name, s in start.items():
        want = (jax_params[name] - s).double()
        got = port_params[name].double() - s.double()
        assert port_params[name].dtype == torch.float32
        errs[name] = ((got - want).norm() / want.norm()).item()
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])


def test_resume_refuses_an_orbax_directory(resumed, synthetic_dataset,
                                           tmp_path):
    with pytest.raises(ValueError, match="checkpoint_from_jax.py"):
        drivers.train_multi(synthetic_dataset, resumed["card_path"],
                            logdir=tmp_path, resume=resumed["jax_ckpt"],
                            device="cpu")
    assert not any(tmp_path.iterdir())


def test_resume_takes_the_latest_kept_step_not_the_best(tmp_path):
    """As the JAX driver's orbax manager opened with ``save_top_k=0``: the
    latest kept step, though an earlier one has the better metric."""
    card = config.ModelCard.from_dict(_card())
    _, _, state = drivers.multi_state(card, "cpu")
    mngr = CheckpointManager(tmp_path, save_top_k=-1, metadata={
        "card": card.to_dict(), "kind": "multi", "class_names": ["a"]})
    for epoch, (step, loss) in enumerate(((3, 0.5), (6, 0.9))):
        state.step = step
        mngr.save(epoch, state, {"valid_loss": loss})
    assert CheckpointManager(tmp_path, save_top_k=1).best_step() == 0
    _, _, resumed = drivers.multi_state(card, "cpu", resume=tmp_path)
    assert resumed.step == 6


# --- the seeded init against JAX's, by statistics ---------------------------


def _vit_batch(bs=4):
    rs = np.random.RandomState(0)
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in (TS, 5, 17, 30)], TS,
        pad_to=TS + 1)
    return {"image": rs.randn(bs, TS, TS, 1).astype(np.float32),
            "image_shape": rs.randint(50, 400, (bs, 2)).astype(np.int32),
            "profile_len": rs.randint(20, 2000, (bs, 1)).astype(np.int32),
            **tokens}


def _b0_batch(bs=4):
    return {k: v.numpy() for k, v in synthetic_batch_b0(
        bs, img=TS, plen=TS, seed=0).items()}


def _unfused(d):
    for field in ("image_encoder_args", "profile_encoder_args"):
        d[field]["fused_attention"] = False
    return d


INIT_CARDS = {
    "vit-clip": (_card(), _vit_batch),
    "flax-attention-siglip": (_unfused(_card(coordination_args={
        "method": "siglip"})), _vit_batch),
    "b0-cnn-arcface": (_b0_card(coordination_args={
        "method": "arcface", "out_features": 5}), _b0_batch),
}


@pytest.mark.parametrize("name", list(INIT_CARDS))
def test_init_matches_jax_by_statistics(name):
    d, batch = INIT_CARDS[name]
    card = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    label = {"label": np.arange(4, dtype=np.int32) % 5} \
        if "arcface" in name else {}
    init = jax.jit(jax_build_multi_model(card).init,
                   static_argnames=("buckets",))
    variables = init(jax.random.key(0), **batch(), **label,
                     buckets=card.buckets)
    want = from_flax(jax.tree.map(np.asarray, dict(variables)))
    got = drivers.init_masters(config.ModelCard.from_dict(copy.deepcopy(d)))
    assert got.keys() == want.keys()
    truncated = 0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == torch.float32, key
        w, g = w.double(), g.double()
        n = w.numel()
        if n < 2 or w.std() == 0:
            assert torch.equal(g, w), key
            continue
        sw = w.std().item()
        bound = SIGMAS * sw / math.sqrt(n)
        assert abs(g.mean().item() - w.mean().item()) <= bound, key
        assert abs(g.std().item() - sw) <= bound, key
        if n >= 1000:
            cut = not (g.abs() > TAIL * g.std()).any()
            assert cut == (not (w.abs() > TAIL * sw).any()), key
            truncated += cut
    assert truncated > 0
    if "arcface" in name:
        assert got["coordination.weight"].shape == (5, 32)


# --- the driver's branches, refusals and profile, on the CPU ---------------


@pytest.fixture(scope="module")
def packed_split(tmp_path_factory):
    split = make_synthetic_dataset(tmp_path_factory.mktemp("drivers_data"),
                                   n_classes=3, n_per_class=8, seed=4)
    for name in ("train", "test"):
        pack_split(split / f"{name}.csv", TS)
    return split


def _spy_steps(monkeypatch):
    """Record the shapes of every batch a train step is given."""
    seen = []
    real = drivers.make_multi_steps

    def spy(*args, **kwargs):
        train_step, eval_step = real(*args, **kwargs)

        def counted(state, batch, seed):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return train_step(state, batch, seed)
        return counted, eval_step

    monkeypatch.setattr(drivers, "make_multi_steps", spy)
    return seen


@pytest.mark.parametrize("branch", ["packed", "device_augment"])
def test_branch_trains_one_epoch(branch, packed_split, tmp_path,
                                 monkeypatch):
    """The packed caches (host suffix) and the CSV path with the oversize
    prefixes (the step crops on the device) each train an epoch; the
    train batches have the branch's shapes."""
    seen = _spy_steps(monkeypatch)
    d = _card(**{"packed_cache": branch == "packed",
                 "device_augment": branch == "device_augment"})
    out = drivers.train_multi(packed_split, config.ModelCard.from_dict(d),
                              logdir=tmp_path, max_epochs=1, device="cpu")
    assert len(seen) == 12 // 4 and out["state"].step == 3
    over = math.ceil(1.05 * TS)
    want = {"packed": {"image": (4, TS, TS, 1), "profile": (4, TS + 1, 6),
                       "time": (4, TS + 1), "padding_mask": (4, TS + 1)},
            "device_augment": {"image": (4, over, over, 1),
                               "profile": (4, over, 6)}}[branch]
    for shapes in seen:
        assert {k: shapes[k] for k in want} == want
        assert shapes["image_shape"] == (4, 2) \
            and shapes["profile_len"] == (4, 1)
    assert math.isfinite(out["history"][0]["valid_loss"])
    assert Path(out["logdir"]).relative_to(tmp_path) \
        == Path("card_" + "_".join(packed_split.parts[-2:])) / "version_0"


def test_arcface_takes_the_class_count(packed_split, tmp_path):
    d = _card(packed_cache=True, coordination_args={"method": "arcface"})
    out = drivers.train_multi(packed_split, config.ModelCard.from_dict(d),
                              logdir=tmp_path, max_epochs=1, device="cpu")
    weight = out["state"].params["coordination.weight"]
    assert weight.shape == (3, 32)
    assert math.isfinite(out["history"][0]["train_loss"])


@pytest.mark.parametrize("overrides,error,match", [
    ({"loader": "grain"}, None, "grain"),
    ({"mesh": {"data": 2}}, ValueError, "torchrun --nproc_per_node 2"),
    ({"mesh": {"data": 1, "model": 2}}, ValueError,
     "torchrun --nproc_per_node 2"),
    ({"image_encoder_args": {"pretrained": True}}, None, None),
], ids=["grain", "mesh-data", "mesh-model", "pretrained"])
def test_unported_options_raise_before_any_step(overrides, error, match,
                                                packed_split, tmp_path,
                                                monkeypatch, capsys):
    """A ``mesh`` of more processes than the run has raises before any
    step (queue 1 module 7 is ported: the message names the launch that
    gives them); ``pretrained: true`` (queue 1 module 6, ported) with no
    ``pretrained_path`` prints the JAX driver's message and trains from
    scratch: one epoch of steps, the masters the seeded init's; ``loader:
    grain`` (queue 1 module 8, ported) trains one epoch of steps through
    its worker processes."""
    seen = _spy_steps(monkeypatch)
    d = _card(packed_cache=True)
    for key, value in overrides.items():
        if isinstance(value, dict) and key.endswith("_args"):
            d[key].update(value)
        else:
            d[key] = value
    card = config.ModelCard.from_dict(d)
    if match == "grain":
        with single_thread():
            out = drivers.train_multi(packed_split, card, logdir=tmp_path,
                                      max_epochs=1, device="cpu")
        assert len(seen) == out["state"].step > 0
        assert math.isfinite(out["history"][0]["train_loss"])
        return
    if match is None:
        with single_thread():
            out = drivers.train_multi(packed_split, card, logdir=tmp_path,
                                      max_epochs=1, device="cpu")
        assert "pretrained: true but no pretrained_path given; training " \
            "from scratch (produce an npz with scripts/convert_timm_torch.py)" \
            in capsys.readouterr().out
        assert len(seen) == out["state"].step > 0
        assert math.isfinite(out["history"][0]["train_loss"])
        init = drivers.init_masters(card)
        _, _, scratch = drivers.multi_state(card, "cpu")
        assert all(torch.equal(scratch.params[n], init[n])
                   for n in scratch.params)
        return
    with pytest.raises(error, match=match):
        drivers.train_multi(packed_split, card, logdir=tmp_path,
                            device="cpu")
    assert not seen and not any(tmp_path.iterdir())


def test_one_device_mesh_and_shard_map_train(packed_split, tmp_path):
    """``mesh: {data: 1}`` and ``parallel: shard_map`` on one device are
    the plain steps, as JAX's ``n_mesh == 1`` branch."""
    d = _card(packed_cache=True, mesh={"data": 1, "model": 1},
              parallel="shard_map")
    out = drivers.train_multi(packed_split, config.ModelCard.from_dict(d),
                              logdir=tmp_path, max_epochs=1, device="cpu")
    assert out["state"].step == 3


def test_default_device_is_the_card(packed_split, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default trains on it")
    d = _card(packed_cache=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        drivers.train_multi(packed_split, config.ModelCard.from_dict(d),
                            logdir=tmp_path)
    assert not any(tmp_path.iterdir())


def test_profile_traces_epoch_zero_only(packed_split, tmp_path):
    d = _card(packed_cache=True)
    out = drivers.train_multi(packed_split, config.ModelCard.from_dict(d),
                              logdir=tmp_path, max_epochs=2, profile=True,
                              device="cpu")
    traces = list((Path(out["logdir"]) / "profile").iterdir())
    assert [t.name for t in traces] == [drivers.TRACE_FILE]
    events = json.loads(traces[0].read_text())["traceEvents"]
    sgd = [e for e in events if e.get("name") == "Optimizer.step#SGD.step"
           and e.get("cat") == "user_annotation"]
    assert len(out["history"]) == 2 and out["state"].step == 6
    assert len(sgd) == 3  # epoch 0's three updates, none of epoch 1's


def test_cli_trains_a_json_card(packed_split, tmp_path, capsys):
    """``scripts/train_multi_torch.py`` with ``--device cpu``: the JAX run
    layout (``metrics.jsonl``, ``checkpoints/<epoch>/state.pt``,
    ``plankton_metadata.json``), then ``--resume`` continues from the
    latest kept step into ``version_1``."""
    card_path = _write_card(tmp_path / "tiny_card.json",
                            _card(packed_cache=True, save_top_k=-1))
    cli = _script("train_multi_torch")
    args = ["-d", str(packed_split), "-m", str(card_path), "-l",
            str(tmp_path / "logs"), "--device", "cpu"]
    first = cli.main(args)
    run = tmp_path / "logs" / ("tiny_card_" + "_".join(
        packed_split.parts[-2:])) / "version_0"
    assert Path(first["logdir"]) == run
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "0", "1", "plankton_metadata.json"]
    assert (run / "checkpoints" / "1" / "state.pt").is_file()
    meta = json.loads((run / "checkpoints" /
                       "plankton_metadata.json").read_text())
    assert meta["kind"] == "multi" and meta["format"] == "torch"
    assert meta["class_names"] == ["genus_0", "genus_1", "genus_2"]
    second = cli.main(args + ["--resume", str(run / "checkpoints"),
                              "--max-epochs", "1"])
    assert Path(second["logdir"]) == run.parent / "version_1"
    assert second["state"].step == first["state"].step + 3 == 9
    assert "Logs and checkpoints in" in capsys.readouterr().out
