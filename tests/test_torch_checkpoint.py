"""Checkpoints of the port (``train/checkpoint.py``), serving from them
(``retrieval/encode.py``: ``encode_dataset``, ``encode_split``;
``scripts/encode_torch.py``) and the bridge from the JAX package's orbax
checkpoints (``scripts/checkpoint_from_jax.py``), against the JAX package.

Tolerances: the manager keeps exactly JAX's steps; a save → load round
trip and a resumed step are bit for bit; encodings of a bridged
checkpoint within ``rtol=atol=1e-4`` of JAX's (as
``test_torch_slice.py::test_encode_csv_matches_jax``: f32 on both sides,
the JAX matmuls at "highest"); the step after a bridged checkpoint within
``test_torch_card.py``'s f32 bounds (loss 1e-5 relative, each parameter's
update 1e-3 relative L2).
"""

import copy
import importlib.util
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models.build import (
    build_multi_model as jax_build_multi_model,
)
from multimodal_plankton_recognition_tpu.retrieval import encode as jax_encode
from multimodal_plankton_recognition_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from multimodal_plankton_recognition_tpu.train.loop import (
    make_multi_steps as jax_make_multi_steps,
)
from multimodal_plankton_recognition_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
)
from multimodal_plankton_recognition_tpu.train.state import (
    TrainState as JaxTrainState, create_train_state as jax_create_train_state,
)
from multimodal_plankton_recognition_tpu.utils.labels import (
    LabelVocab as JaxLabelVocab,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.build import (
    build_for_kind, build_multi_model, step_buckets,
)
from multimodal_plankton_recognition_torch.models.flagships import (
    flagship_card, init_weights_, synthetic_batch_b0,
)
from multimodal_plankton_recognition_torch.retrieval.encode import (
    encode_dataset, encode_split, eval_pipeline,
)
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_optimizer,
)
from multimodal_plankton_recognition_torch.train.checkpoint import (
    CheckpointManager, load_from_checkpoint, read_metadata,
)
from multimodal_plankton_recognition_torch.utils import LabelVocab

REPO = Path(__file__).resolve().parent.parent
CARDS = sorted((REPO / "model_cards").rglob("*.yaml"))
B0_CLIP_CARD = REPO / "model_cards/multi/efficientnet_b0_cnn_2_512_clip.yaml"
F32_LOSS_TOL, F32_UPDATE_TOL = 1e-5, 1e-3
ENCODE_TOL = 1e-4
TS = 32


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _vit_card(precision="32", every_k=1, dropout=0.0) -> dict:
    """A small ViT card: 32 px, 2 ViT blocks 48 wide, a 64-wide profile
    transformer over 32 steps, bs 6, CLIP (unfused: the JAX side stays on
    jnp in f32)."""
    return {
        "bs": 6, "buckets": 2, "target_size": TS, "dim_embedding": 32,
        "image_encoder_args": {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": dropout,
            "backbone_kwargs": {"img_size": TS, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        "profile_encoder_args": {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": TS,
            "dim_feedforward": 96, "fused_attention": True,
            "dropout": dropout},
        "coordination_args": {"method": "clip"},
        "optim_args": {"lr": 5e-2, "momentum": 0.9, "weight_decay": 1e-3,
                       "nesterov": True},
        "trainer_args": {"precision": precision,
                         "accumulate_grad_batches": every_k},
    }


def _b0_card(precision="16-mixed") -> dict:
    d = yaml.safe_load(B0_CLIP_CARD.read_text())
    d.update(target_size=TS, bs=8, buckets=2)
    d["trainer_args"].update(precision=precision)
    return d


def _vit_batch(seed: int, bs: int = 6) -> dict:
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, TS + 1, bs)
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in lengths], TS,
        pad_to=TS + 1)
    return {"image": rs.randn(bs, TS, TS, 1).astype(np.float32),
            "image_shape": rs.randint(200, 400, (bs, 2)).astype(np.int32),
            "profile_len": rs.randint(100, 2000, (bs, 1)).astype(np.int32),
            **tokens}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_state(d, seed=0):
    """Card → bf16/f32 model, f32 masters from a seeded f32 init."""
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    model = build_multi_model(card)
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(seed)).state_dict()
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    state = create_train_state(model, init, tx)
    steps = make_multi_steps(model, tx, step_buckets(card))
    return card, model, tx, state, steps


def _metadata(card, classes=("a", "b")):
    return {"card": card.to_dict(), "kind": "multi",
            "class_names": list(classes)}


# --- config.to_dict, LabelVocab ------------------------------------------


@pytest.mark.parametrize("source", [*CARDS, "flagship vit", "flagship b0"],
                         ids=lambda p: getattr(p, "name", p))
def test_card_to_dict_round_trips(source):
    """``from_dict(to_dict(card))`` gives back an equal card, also through
    JSON (the metadata file), and ``to_dict`` equals the JAX card's."""
    if isinstance(source, Path):
        d = yaml.safe_load(source.read_text())
    else:
        d = flagship_card(source.split()[1])
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    assert config.ModelCard.from_dict(card.to_dict()) == card
    through_json = json.loads(json.dumps(card.to_dict()))
    assert config.ModelCard.from_dict(through_json) == card
    assert card.to_dict() == jax_config.ModelCard.from_dict(
        copy.deepcopy(d)).to_dict()


@pytest.mark.parametrize("name", ["vit", "b0"])
def test_flagship_card_builds_the_flagship(name):
    from multimodal_plankton_recognition_torch.models import flagships

    built = build_multi_model(config.ModelCard.from_dict(flagship_card(name)))
    want = getattr(flagships, f"flagship_{name}")()
    assert repr(built) == repr(want)
    assert [(k, v.shape, v.dtype) for k, v in built.state_dict().items()] \
        == [(k, v.shape, v.dtype) for k, v in want.state_dict().items()]


def test_label_vocab_matches_jax():
    labels = ["diatom", "ciliate", "diatom", "zz", "a b", "ciliate"]
    port, jax_vocab = LabelVocab(labels), JaxLabelVocab(labels)
    assert len(port) == len(jax_vocab) == 4
    np.testing.assert_array_equal(port.classes_, jax_vocab.classes_)
    assert port.to_list() == jax_vocab.to_list()
    np.testing.assert_array_equal(port.transform(labels),
                                  jax_vocab.transform(labels))
    assert port.transform(labels).dtype == np.int32
    np.testing.assert_array_equal(port.transform("zz"),
                                  jax_vocab.transform("zz"))
    np.testing.assert_array_equal(port.inverse_transform([3, 0, 1]),
                                  jax_vocab.inverse_transform([3, 0, 1]))
    with pytest.raises(ValueError, match="Unknown label"):
        port.transform(["nope"])


# --- top-k retention -----------------------------------------------------

SEQUENCES = {
    # a missing value, NaN, inf and ties (equal metrics at several steps)
    "mixed": [0.5, None, 0.3, float("nan"), 0.3, 0.7, 0.2, 0.2,
              float("inf"), 0.25],
    "ties": [1.0, 1.0, 2.0, 1.0, 0.5, 0.5, 2.0],
}


def _steps_on_disk(directory: Path):
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit())


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("sequence", list(SEQUENCES))
@pytest.mark.parametrize("save_top_k", [0, 1, 2, -1])
def test_top_k_retention_matches_jax(tmp_path, save_top_k, sequence, mode):
    """After every epoch both managers report the same save result, keep
    the same step directories and name the same best step."""
    params = {"w": jnp.zeros((2,))}
    jax_state = JaxTrainState(step=0, params=params, batch_stats={},
                              opt_state=optax.sgd(0.1).init(params))
    model = torch.nn.Linear(2, 1)
    state = create_train_state(model, model.state_dict(), make_optimizer(
        config.OptimConfig()))
    jax_mngr = JaxCheckpointManager(tmp_path / "jax", mode=mode,
                                    save_top_k=save_top_k)
    port = CheckpointManager(tmp_path / "port", mode=mode,
                             save_top_k=save_top_k)
    for epoch, value in enumerate(SEQUENCES[sequence]):
        metrics = {} if value is None else {"valid_loss": value}
        assert port.save(epoch, state, metrics) == \
            jax_mngr.save(epoch, jax_state, metrics), epoch
        jax_mngr.wait()
        assert _steps_on_disk(tmp_path / "port") == \
            _steps_on_disk(tmp_path / "jax") == port.all_steps(), epoch
        assert port.best_step() == jax_mngr.best_step(), epoch
    jax_mngr.close()
    # a fresh manager reads the same steps back and restores the best one
    fresh = CheckpointManager(tmp_path / "port", mode=mode,
                              save_top_k=save_top_k)
    assert fresh.all_steps() == port.all_steps()
    assert fresh.best_step() == port.best_step()
    if fresh.all_steps():
        assert fresh.restore()["step"] == 0
    else:
        with pytest.raises(FileNotFoundError):
            fresh.restore()


def test_writes_are_atomic(tmp_path):
    """A step directory appears only whole; a leftover temporary directory
    is not a checkpoint."""
    model = torch.nn.Linear(2, 1)
    state = create_train_state(model, model.state_dict(), make_optimizer(
        config.OptimConfig()))
    (tmp_path / ".3.tmp-1").mkdir()
    mngr = CheckpointManager(tmp_path, save_top_k=-1)
    assert mngr.all_steps() == []
    assert mngr.save(0, state, {"valid_loss": 1.0})
    assert sorted(p.name for p in (tmp_path / "0").iterdir()) == \
        ["metrics.json", "state.pt"]
    assert not any(p.name.startswith(".0.") for p in tmp_path.iterdir())
    payload = torch.load(tmp_path / "0" / "state.pt", weights_only=True)
    assert sorted(payload) == ["batch_stats", "grad_acc", "opt", "params",
                               "step"]


# --- round trip, resume ---------------------------------------------------


@pytest.mark.parametrize("family", ["vit", "b0"])
def test_save_load_round_trip(tmp_path, family):
    """save → ``load_from_checkpoint(device="cpu")`` gives back the state
    exactly: the payload's masters, statistics, step and optimizer state,
    and a module at the card's bf16 with the masters rounded as
    ``load_into`` rounds them and the BatchNorm statistics f32."""
    d = _vit_card("16-mixed") if family == "vit" else _b0_card()
    card, model, _, state, (train_step, _) = _port_state(d)
    if family == "vit":
        batch = _torch(_vit_batch(0))
    else:
        batch = synthetic_batch_b0(8, img=TS, plen=TS, seed=0)
    for _ in range(2):
        state, _ = train_step(state, batch, 0)
    mngr = CheckpointManager(tmp_path, metadata=_metadata(card))
    assert mngr.save(0, state, {"valid_loss": 1.0})
    loaded, payload, meta = load_from_checkpoint(tmp_path, device="cpu")
    assert meta == {**_metadata(card), "_monitor": "valid_loss",
                    "_mode": "min", "format": "torch"}
    assert payload["step"] == state.step == 2
    assert payload["params"].keys() == state.params.keys()
    for n, m in state.params.items():
        assert payload["params"][n].dtype == torch.float32
        assert torch.equal(payload["params"][n], m), n
    saved_opt, live_opt = payload["opt"], state.opt.state_dict()
    assert saved_opt["param_groups"] == live_opt["param_groups"]
    for i, s in live_opt["state"].items():
        assert torch.equal(saved_opt["state"][i]["momentum_buffer"],
                           s["momentum_buffer"])
    # the B0 card accumulates 4 micro-steps: 2 of them are pending
    assert (payload["grad_acc"] is None) == (state.grad_acc is None) \
        == (family == "vit")
    for n, g in (state.grad_acc or {}).items():
        assert torch.equal(payload["grad_acc"][n], g), n
    assert payload["batch_stats"].keys() == state.batch_stats.keys()
    if family == "b0":
        assert len(state.batch_stats) > 0
    reference = copy.deepcopy(model)
    state.load_into(reference)
    params = dict(loaded.named_parameters())
    for n, p in reference.named_parameters():
        assert params[n].dtype == p.dtype
        assert torch.equal(params[n], p), n
    assert any(p.dtype == torch.bfloat16 for p in params.values())
    for n, b in loaded.named_buffers():
        assert b.dtype == torch.float32, n
        assert torch.equal(b, state.batch_stats[n]), n


def test_resume_mid_accumulation_is_bit_exact(tmp_path):
    """A checkpoint taken mid-accumulation (step 3 at k = 2, dropout 0.1),
    restored into a fresh ``TrainState`` (masters, statistics, step,
    optimizer state, ``grad_acc``), takes the next step exactly as the
    run that was never interrupted."""
    d = _vit_card("32", every_k=2, dropout=0.1)
    batches = [_torch(_vit_batch(s)) for s in range(4)]
    card, _, _, state, (train_step, _) = _port_state(d)
    for b in batches[:3]:
        state, _ = train_step(state, b, 7)
    assert state.grad_acc is not None and state.step == 3
    CheckpointManager(tmp_path, metadata=_metadata(card)).save(
        0, state, {"valid_loss": 1.0})
    state, want_loss = train_step(state, batches[3], 7)

    payload = CheckpointManager(tmp_path).restore()
    model = build_multi_model(card)
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    resumed = create_train_state(
        model, {**payload["params"], **payload["batch_stats"]}, tx)
    resumed.step = payload["step"]
    resumed.opt.load_state_dict(payload["opt"])
    resumed.grad_acc = payload["grad_acc"]
    step, _ = make_multi_steps(model, tx, step_buckets(card))
    resumed, loss = step(resumed, batches[3], 7)
    assert torch.equal(loss, want_loss)
    assert resumed.step == state.step == 4 and resumed.grad_acc is None
    for n, m in state.params.items():
        assert torch.equal(resumed.params[n], m), n


# --- the bridge from orbax ------------------------------------------------


def _jax_checkpoint(root: Path, every_k: int, steps: int):
    """The small f32 ViT card trained by the JAX package for ``steps``
    micro-steps (SGD with momentum, accumulation ``every_k``) and saved by
    its ``CheckpointManager``; then JAX's next step. Returns (card dict,
    orbax dir, (loss, params) of the next step in the port's names,
    params before it)."""
    d = _vit_card("32", every_k=every_k)
    card = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    model = jax_build_multi_model(card)
    tx = jax_make_optimizer(card.optim_args, every_k)
    batches = [{k: jnp.asarray(v) for k, v in _vit_batch(s).items()}
               for s in range(steps + 1)]
    state = jax_create_train_state(model, jax.random.key(0), batches[0], tx,
                                   init_kwargs={"buckets": card.buckets})
    train_step, _ = jax_make_multi_steps(model, tx, card.buckets)
    for b in batches[:steps]:
        state, _ = train_step(state, b, jax.random.key(1))
    orbax_dir = root / "jax"
    mngr = JaxCheckpointManager(orbax_dir, save_top_k=1, metadata={
        "card": card.to_dict(), "kind": "multi",
        "class_names": ["class_0", "class_1", "class_2"]})
    assert mngr.save(0, state, {"valid_loss": 1.5})
    mngr.wait()
    mngr.close()

    def params(s):
        return from_flax({"params": jax.tree.map(np.asarray, s.params)})

    before = params(state)
    state, loss = train_step(state, batches[steps], jax.random.key(1))
    return d, orbax_dir, (float(loss), params(state)), before


@pytest.fixture(scope="module")
def bridge_runs(tmp_path_factory):
    """(every_k, steps) -> a JAX checkpoint, bridged once per module."""
    runs = {}

    def run(every_k, steps):
        if (every_k, steps) not in runs:
            root = tmp_path_factory.mktemp(f"bridge_k{every_k}")
            d, orbax_dir, after, before = _jax_checkpoint(root, every_k,
                                                          steps)
            port_dir = root / "torch"
            assert _script("checkpoint_from_jax").bridge(
                orbax_dir, port_dir) == [0]
            runs[every_k, steps] = {
                "card": d, "jax": orbax_dir, "port": port_dir,
                "after": after, "before": before, "every_k": every_k,
                "steps": steps}
        return runs[every_k, steps]

    return run


@pytest.fixture(params=[(1, 2), (2, 3)], ids=["k1_after_2", "k2_after_3"])
def bridged(request, bridge_runs):
    """SGD with momentum bridged after 2 steps, and with accumulation 2
    after 3 micro-steps (mid-accumulation)."""
    return bridge_runs(*request.param)


@pytest.fixture
def bridged_k1(bridge_runs):
    return bridge_runs(1, 2)


def test_bridge_carries_the_state(bridged):
    """Masters, step, momentum and ``grad_acc`` come over; one more port
    step then matches JAX's next step."""
    d = bridged["card"]
    meta = read_metadata(bridged["port"])
    assert meta["format"] == "torch" and meta["card"] == d
    assert meta == {**read_metadata(bridged["jax"]), "format": "torch"}
    model, payload, _ = load_from_checkpoint(bridged["port"], device="cpu")
    assert payload["step"] == bridged["steps"]
    for n, m in bridged["before"].items():
        assert torch.equal(payload["params"][n], m), n
    momentum = [s["momentum_buffer"] for s in payload["opt"]["state"].values()]
    assert len(momentum) == len(payload["params"])
    assert all(b.abs().sum() > 0 for b in momentum[:4])
    pending = bridged["steps"] % bridged["every_k"]
    assert (payload["grad_acc"] is not None) == bool(pending)

    card = config.ModelCard.from_dict(copy.deepcopy(d))
    tx = make_optimizer(card.optim_args, bridged["every_k"])
    state = create_train_state(
        model, {**payload["params"], **payload["batch_stats"]}, tx)
    state.step = payload["step"]
    state.opt.load_state_dict(payload["opt"])
    state.grad_acc = payload["grad_acc"]
    step, _ = make_multi_steps(model, tx, step_buckets(card))
    state, loss = step(state, _torch(_vit_batch(bridged["steps"])), 0)
    jloss, jparams = bridged["after"]
    assert abs(loss.item() - jloss) <= F32_LOSS_TOL * abs(jloss)
    before = bridged["before"]
    for n, start in before.items():
        want = (jparams[n] - start).double()
        got = state.params[n].double() - start.double()
        assert want.norm() > 0, n
        assert ((got - want).norm() / want.norm()).item() <= \
            F32_UPDATE_TOL, n


def test_bridged_encode_matches_jax(bridged_k1, synthetic_dataset):
    """``encode_dataset`` and ``encode_split`` on the bridged checkpoint
    against the JAX package's on its orbax checkpoint, same CSVs."""
    bridged = bridged_k1
    csv = synthetic_dataset / "test.csv"
    want = jax_encode.encode_dataset(bridged["jax"], csv, batch_size=5,
                                     num_workers=1)
    got = encode_dataset(bridged["port"], csv, batch_size=5, num_workers=1,
                         device="cpu")
    assert sorted(got) == sorted(want) == ["classes", "image", "label",
                                           "profile"]
    for key in ("image", "profile"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=ENCODE_TOL,
                                   atol=ENCODE_TOL, err_msg=key)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["classes"], want["classes"])

    want = jax_encode.encode_split(bridged["jax"], synthetic_dataset,
                                   batch_size=5, num_workers=1)
    got = encode_split(bridged["port"], synthetic_dataset, batch_size=5,
                       num_workers=1, device="cpu")
    assert sorted(got) == sorted(want) == ["classes", "test", "train"]
    for split in ("train", "test"):
        for key in ("image", "profile"):
            np.testing.assert_allclose(got[split][key], want[split][key],
                                       rtol=ENCODE_TOL, atol=ENCODE_TOL,
                                       err_msg=f"{split} {key}")
        np.testing.assert_array_equal(got[split]["label"],
                                      want[split]["label"])
    np.testing.assert_array_equal(got["classes"], want["classes"])


def test_encode_cli_writes_the_jax_schema(bridged_k1, synthetic_dataset,
                                          tmp_path, monkeypatch):
    """``scripts/encode_torch.py`` on the bridged checkpoint writes the
    pickle ``scripts/encode.py`` writes on the orbax one: flat, then the
    nested layout appended under another fold."""
    bridged = bridged_k1
    outputs = {}
    for name, ckpt, extra in (("encode", bridged["jax"], []),
                              ("encode_torch", bridged["port"],
                               ["--device", "cpu"])):
        out = tmp_path / f"{name}.pkl"
        common = ["-k", str(ckpt), "-o", str(out), "--name", "vit",
                  "--batch-size", "5", "--num-workers", "1", *extra]
        for argv in (["-d", str(synthetic_dataset / "test.csv"),
                      "--fold", "1"],
                     ["-d", str(synthetic_dataset), "--train-test",
                      "--fold", "2", "--append"]):
            monkeypatch.setattr(sys, "argv", [name, *common, *argv])
            _script(name).main()
        with open(out, "rb") as f:
            outputs[name] = pickle.load(f)
    want, got = outputs["encode"], outputs["encode_torch"]

    def schema(tree):
        if isinstance(tree, dict):
            return {k: schema(v) for k, v in tree.items()}
        return (type(tree).__name__, getattr(tree, "dtype", None),
                getattr(tree, "shape", None))

    assert schema(got) == schema(want)
    assert sorted(got["vit"]) == [1, 2]
    flat, nested = got["vit"][1], got["vit"][2]
    np.testing.assert_allclose(flat["image"], want["vit"][1]["image"],
                               rtol=ENCODE_TOL, atol=ENCODE_TOL)
    np.testing.assert_allclose(nested["train"]["profile"],
                               want["vit"][2]["train"]["profile"],
                               rtol=ENCODE_TOL, atol=ENCODE_TOL)
    # --logits takes a classifier checkpoint, as JAX's predict_classifier
    monkeypatch.setattr(sys, "argv", [
        "encode_torch", "-k", str(bridged["port"]), "-d", "unused.csv",
        "-o", str(tmp_path / "x.pkl"), "--logits", "--device", "cpu"])
    with pytest.raises(ValueError, match="image/profile checkpoint"):
        _script("encode_torch").main()


# --- refusals ---------------------------------------------------------------


def test_loader_refuses_orbax_and_classifier_checkpoints(bridged_k1,
                                                         tmp_path):
    """The loader refuses an orbax directory; since the classifiers were
    ported, an ``image`` / ``profile`` directory loads as its classifier
    over the stored classes (and an empty one has no checkpoint), and
    their eval pipelines are the raw transforms."""
    bridged = bridged_k1
    with pytest.raises(ValueError, match="checkpoint_from_jax.py"):
        load_from_checkpoint(bridged["jax"], device="cpu")
    card = config.ModelCard.from_dict(_vit_card())
    names = ["a", "b", "c"]
    for kind in ("image", "profile"):
        meta = {"card": card.to_dict(), "kind": kind, "class_names": names}
        CheckpointManager(tmp_path / kind, metadata=meta)
        with pytest.raises(FileNotFoundError, match="No checkpoints"):
            load_from_checkpoint(tmp_path / kind, device="cpu")
        model = build_for_kind(card, kind, names)
        state = create_train_state(
            model, {k: v.float() for k, v in model.state_dict().items()},
            make_optimizer(card.optim_args))
        CheckpointManager(tmp_path / f"{kind}_saved", metadata=meta).save(
            0, state, {"valid_loss": 1.0})
        loaded, payload, got = load_from_checkpoint(tmp_path / f"{kind}_saved",
                                                    device="cpu")
        assert type(loaded) is type(model) and got["kind"] == kind
        assert loaded.fc.out_features == len(names)
        for name, value in loaded.state_dict().items():
            assert torch.equal(value, model.state_dict()[name]), name
        image_tf = eval_pipeline(card, kind)[0]
        assert type(image_tf).__name__ == "ImageTransforms"


def test_serving_entry_points_default_to_the_card(bridged_k1,
                                                   monkeypatch):
    """Without a card, a call that names no device raises instead of
    returning a CPU result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = bridged_k1["port"]
    for call in (lambda: load_from_checkpoint(port),
                 lambda: encode_dataset(port, "unused.csv"),
                 lambda: encode_split(port, "unused_dir")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
