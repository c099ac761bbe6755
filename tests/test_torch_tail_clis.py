"""The port's serving and analysis CLIs (``scripts/export_model_torch.py``,
``scripts/serve_torch.py``, ``scripts/analysis_torch.py``) against the JAX
package's (``scripts/export_model.py``, ``scripts/serve.py``,
``scripts/analysis.py``) on the synthetic dataset, on the CPU.

The checkpoint: a small f32 ViT card's seeded init saved by the JAX
package's orbax manager and carried over by
``scripts/checkpoint_from_jax.py``. Tolerances: the retrieval artifact's
predictions CSV equal to JAX's, byte for byte (the gallery: the port's
encode of the train split, the same pickle for both); the ``multi``
artifact's served pickle within 1e-5 of ``scripts/encode_torch.py``'s;
``analysis_torch.py stats`` and ``norms`` print what ``analysis.py``
prints.
"""

import copy
import functools
import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models.build import (
    build_multi_model as jax_build_multi_model,
)
from multimodal_plankton_recognition_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from multimodal_plankton_recognition_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
)
from multimodal_plankton_recognition_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TS = 32
EMB_TOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"cli_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(name, argv, monkeypatch, capsys):
    """A CLI's ``main`` in this process with ``argv``; its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    _script(name).main()
    return capsys.readouterr().out


def _card():
    return {
        "bs": 6, "buckets": 2, "target_size": TS, "dim_embedding": 32,
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
        "optim_args": {"lr": 5e-2, "momentum": 0.9},
        "trainer_args": {"precision": "32"},
    }


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, synthetic_dataset):
    """(orbax dir, port dir): a seeded init, saved by JAX, bridged."""
    root = tmp_path_factory.mktemp("cli_ckpt")
    card = jax_config.ModelCard.from_dict(copy.deepcopy(_card()))
    rs = np.random.RandomState(0)
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in (5, 9, 32, 3, 7, 12)],
        TS, pad_to=TS + 1)
    batch = {"image": rs.randn(6, TS, TS, 1).astype(np.float32),
             "image_shape": np.full((6, 2), 100, np.int32),
             "profile_len": np.full((6, 1), 50, np.int32), **tokens}
    model = jax_build_multi_model(card)
    # create_train_state's init, compiled once (an op-by-op init takes
    # several times as long on the CPU)
    model.init = jax.jit(functools.partial(model.init,
                                           buckets=card.buckets))
    state = jax_create_train_state(
        model, jax.random.key(0),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax_make_optimizer(card.optim_args, 1))
    classes = sorted(p.name for p in synthetic_dataset.parent.iterdir()
                     if p.is_dir() and p.name != synthetic_dataset.name)
    mngr = JaxCheckpointManager(root / "jax", save_top_k=1, metadata={
        "card": card.to_dict(), "kind": "multi", "class_names": classes})
    assert mngr.save(0, state, {"valid_loss": 1.0})
    mngr.wait()
    mngr.close()
    assert _script("checkpoint_from_jax").bridge(root / "jax",
                                                 root / "torch") == [0]
    return root / "jax", root / "torch"


def test_export_then_serve_matches_jax(checkpoints, synthetic_dataset,
                                       tmp_path, monkeypatch, capsys):
    """Retrieval artifacts of the same checkpoint and gallery: the port's
    ``serve_torch.py`` predictions CSV equals JAX's ``serve.py`` one, and
    both print the same accuracy line; a pinned batch size pads the
    trailing partial batch and gives the same CSV."""
    jax_dir, port_dir = checkpoints
    test_csv = synthetic_dataset / "test.csv"
    gallery = tmp_path / "gallery.pkl"
    _run("encode_torch", ["-k", port_dir, "-d", synthetic_dataset /
                          "train.csv", "-o", gallery, "--name", "m",
                          "--fold", "1", "--batch-size", "5",
                          "--num-workers", "1", "--device", "cpu"],
         monkeypatch, capsys)
    out = _run("export_model_torch", [
        "-c", port_dir, "-o", tmp_path / "port_art", "--platforms", "cpu",
        "--gallery", gallery, "-k", "3"], monkeypatch, capsys)
    assert "Exported serving artifact" in out
    _run("export_model", ["-c", jax_dir, "-o", tmp_path / "jax_art",
                          "--platforms", "cpu", "--gallery", gallery,
                          "-k", "3"], monkeypatch, capsys)
    served = {}
    for name, art, extra in (
            ("serve_torch", "port_art", ["--device", "cpu"]),
            ("serve", "jax_art", [])):
        out = _run(name, ["-a", tmp_path / art, "-d", test_csv, "-o",
                          tmp_path / f"{name}.csv", "--batch-size", "4",
                          "--num-workers", "1", *extra], monkeypatch, capsys)
        served[name] = ((tmp_path / f"{name}.csv").read_text(),
                        [l for l in out.splitlines()
                         if l.startswith("accuracy")])
    assert served["serve_torch"] == served["serve"]
    assert len(served["serve"][0].splitlines()) == 1 + len(
        test_csv.read_text().splitlines()) - 1
    assert served["serve"][1]  # an accuracy line

    _run("export_model_torch", [
        "-c", port_dir, "-o", tmp_path / "pinned", "--platforms", "cpu",
        "--gallery", gallery, "-k", "3", "--batch-size", "4"],
        monkeypatch, capsys)
    out = _run("serve_torch", ["-a", tmp_path / "pinned", "-d", test_csv,
                               "-o", tmp_path / "pinned.csv",
                               "--batch-size", "7", "--num-workers", "1",
                               "--device", "cpu"], monkeypatch, capsys)
    assert "artifact pins batch_size=4" in out
    assert (tmp_path / "pinned.csv").read_text() == served["serve"][0]
    out = _run("export_model_torch", ["--load", tmp_path / "pinned",
                                      "--device", "cpu"], monkeypatch, capsys)
    assert '"kind": "retrieval"' in out and '"batch_size": 4' in out


def test_serve_multi_writes_the_encode_pickle(checkpoints, synthetic_dataset,
                                              tmp_path, monkeypatch, capsys):
    _, port_dir = checkpoints
    test_csv = synthetic_dataset / "test.csv"
    _run("export_model_torch", ["-c", port_dir, "-o", tmp_path / "art",
                                "--platforms", "cpu"], monkeypatch, capsys)
    _run("serve_torch", ["-a", tmp_path / "art", "-d", test_csv, "-o",
                         tmp_path / "served.pkl", "--name", "m", "--fold",
                         "2", "--num-workers", "1", "--device", "cpu"],
         monkeypatch, capsys)
    _run("encode_torch", ["-k", port_dir, "-d", test_csv, "-o",
                          tmp_path / "enc.pkl", "--name", "m", "--fold", "2",
                          "--num-workers", "1", "--device", "cpu"],
         monkeypatch, capsys)
    with open(tmp_path / "served.pkl", "rb") as f:
        got = pickle.load(f)["m"][2]
    with open(tmp_path / "enc.pkl", "rb") as f:
        want = pickle.load(f)["m"][2]
    assert sorted(got) == sorted(want)
    for key in ("image", "profile"):
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=EMB_TOL,
                                   atol=EMB_TOL)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["classes"], want["classes"])


@pytest.mark.parametrize("command", ["stats", "norms"])
def test_analysis_prints_what_jax_prints(command, synthetic_dataset,
                                         monkeypatch, capsys):
    root = synthetic_dataset.parent
    want = _run("analysis", [command, "-d", root], monkeypatch, capsys)
    got = _run("analysis_torch", [command, "-d", root], monkeypatch, capsys)
    assert got == want and len(got.splitlines()) >= 3


@pytest.mark.parametrize("method", ["pacmap", "pca"])
def test_analysis_embed_writes_a_png(method, checkpoints, synthetic_dataset,
                                     tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    labels = np.repeat(["a", "b", "c"], 10)
    emb = {"m": {1: {"image": rng.normal(size=(30, 8)).astype(np.float32),
                     "profile": rng.normal(size=(30, 8)).astype(np.float32),
                     "label": labels}}}
    with open(tmp_path / "emb.pkl", "wb") as f:
        pickle.dump(emb, f)
    out = tmp_path / f"{method}.png"
    printed = _run("analysis_torch", [
        "embed", "-e", tmp_path / "emb.pkl", "-o", out, "--method", method,
        "--device", "cpu"], monkeypatch, capsys)
    assert f"wrote {out}" in printed
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
