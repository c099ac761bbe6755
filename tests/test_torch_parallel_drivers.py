"""The train drivers on two gloo ranks on the CPU against the one-process
run, over a tiny synthetic dataset (12 train and 15 test pairs: the test
split divides neither by the batch of 4 nor by 4 × 2):

* ``train_multi`` (packed pairs, host suffix, ``mesh: {data: 2}``) for 2
  epochs, then resumed for 1: one run directory (``version_0``, then
  ``version_1``) written by rank 0 alone, the history of both runs and
  the final masters equal to the one-process runs';
* ``train_image``: the history, the ``test_acc`` on every test row (the
  trailing 3-row batch split 2 + 1 over the ranks) equal to the
  one-process run's;
* the refusals: a card's ``mesh`` that the process count does not give
  (one process), a batch that does not divide by the ranks (JAX's
  message, naming a process count that divides), ``parallel: shard_map``
  with a BatchNorm model (JAX's error), each before anything is written;
  bucketed negatives that do not divide by the ranks under ``shard_map``
  print JAX's line and train on the GSPMD step.

Tolerances: losses to 1e-5 relative, masters to 1e-4 relative L2 (f32;
dropout 0; the same global batches in the same order, each rank's share
of the augmentation drawn per sample as the one-process run draws it).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.data.packed import pack_split
from multimodal_plankton_recognition_torch.data.synthetic import (
    make_synthetic_dataset,
)
from multimodal_plankton_recognition_torch.train import drivers
from torch_ranks import Ranks
from torch_threads import single_thread

TS = 16
LOSS_TOL, REL_L2_TOL = 1e-5, 1e-4


def _card(**overrides) -> dict:
    d = {
        "bs": 4, "buckets": 2, "target_size": TS, "dim_embedding": 16,
        "num_workers": 2, "save_top_k": 2, "patience": 5,
        "image_encoder_args": {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": 0.0,
            "backbone_kwargs": {"img_size": TS, "depth": 1, "embed_dim": 32,
                                "num_heads": 2}},
        "profile_encoder_args": {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 32,
            "num_layers": 1, "num_head": 2, "target_size": TS,
            "dim_feedforward": 64, "fused_attention": True, "dropout": 0.0},
        "coordination_args": {"method": "clip"},
        "optim_args": {"lr": 5e-2, "momentum": 0.9, "weight_decay": 1e-3,
                       "nesterov": True},
        "trainer_args": {"precision": "32", "min_epochs": 1,
                         "max_epochs": 2},
    }
    d.update(overrides)
    return d


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(2, tmp_path_factory.mktemp("parallel_drivers"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    split = make_synthetic_dataset(tmp_path_factory.mktemp("parallel_data"),
                                   n_classes=3, n_per_class=9, seed=4)
    for name in ("train", "test"):
        pack_split(split / f"{name}.csv", TS)
    return split


def _one_process(kind, split, card, logdir, **kw):
    fn = {"multi": drivers.train_multi, "image": drivers.train_image}[kind]
    with single_thread():
        return fn(split, config.ModelCard.from_dict(card), logdir=logdir,
                  device="cpu", **kw)


def _same_history(got, want, keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in keys:
            assert abs(g[key] - w[key]) <= LOSS_TOL * abs(w[key]), (key, g, w)


def _same_masters(got, want):
    for name, master in want.items():
        master = master.numpy()
        err = np.linalg.norm(got[name] - master) / np.linalg.norm(master)
        assert err <= REL_L2_TOL, name


def test_train_multi_on_two_ranks(ranks, split, tmp_path):
    card = _card(packed_cache=True, mesh={"data": 2})
    logs = tmp_path / "ranks"
    got = ranks.run("drive", "multi", str(split), card, str(logs))
    single = _card(packed_cache=True)  # one process: no mesh
    one = _one_process("multi", split, single, tmp_path / "one")
    assert got[0]["logdir"] == got[1]["logdir"]
    run = Path(got[0]["logdir"])
    assert run.parent.parent == logs and run.name == "version_0"
    assert [p.name for p in run.parent.iterdir()] == ["version_0"]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [0, 1]
    assert got[0]["best_step"] == got[1]["best_step"] == one["best_step"]
    keys = ("train_loss", "valid_loss")
    for rank in got:
        _same_history(rank["history"], one["history"], keys)
        _same_masters(rank["params"], one["state"].params)
    for name in got[0]["params"]:
        np.testing.assert_array_equal(got[0]["params"][name],
                                      got[1]["params"][name])

    # resumed from the run's checkpoints: one more epoch in version_1
    resumed = ranks.run("drive", "multi", str(split), card, str(logs),
                        max_epochs=1, resume=str(run / "checkpoints"))
    one_resumed = _one_process("multi", split, single, tmp_path / "one",
                               max_epochs=1,
                               resume=Path(one["logdir"]) / "checkpoints")
    assert Path(resumed[0]["logdir"]).name == "version_1"
    for rank in resumed:
        _same_history(rank["history"], one_resumed["history"], keys)
        _same_masters(rank["params"], one_resumed["state"].params)


def test_train_image_on_two_ranks(ranks, split, tmp_path):
    card = _card()
    got = ranks.run("drive", "image", str(split), card, str(tmp_path / "r"),
                    max_epochs=2)
    one = _one_process("image", split, card, tmp_path / "one", max_epochs=2)
    for rank in got:
        _same_history(rank["history"], one["history"],
                      ("train_loss", "valid_loss"))
        assert [h["valid_acc"] for h in rank["history"]] == \
            [h["valid_acc"] for h in one["history"]]
        assert rank["test_acc"] == one["test_acc"]
        assert rank["best_step"] == one["best_step"]
        _same_masters(rank["params"], one["state"].params)


def test_mesh_of_other_processes_raises(split, tmp_path):
    for mesh in ({"data": 2}, {"data": 1, "model": 2}):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            _one_process("multi", split, _card(packed_cache=True, mesh=mesh),
                         tmp_path)
    assert not any(tmp_path.iterdir())


def test_refusals_on_two_ranks(ranks, split, tmp_path):
    bn = _card(packed_cache=True, parallel="shard_map")
    bn["profile_encoder_args"] = {"kind": "cnn", "dim_in": 6,
                                  "blocks": [1, 1, 1, 1],
                                  "base_channels": 8, "dropout": 0.0}
    for card, want in (
            (_card(bs=3, buckets=1),
             "Batch size 3 not divisible by data-axis size 2; launch "
             "torchrun --nproc_per_node 1, whose data axis divides it"),
            (bn, drivers.BATCHNORM_REFUSAL)):
        for got in ranks.run("refusal", "multi", str(split), card,
                             str(tmp_path)):
            assert got == want
    assert not any(tmp_path.iterdir())


def test_shard_map_with_indivisible_buckets_falls_back(ranks, split,
                                                       tmp_path):
    card = _card(packed_cache=True, parallel="shard_map", buckets=1)
    got = ranks.run("drive", "multi", str(split), card, str(tmp_path),
                    max_epochs=1, capture=True)
    for rank in got:
        assert "parallel: shard_map unavailable (parallel: shard_map with " \
            "bucketed negatives needs buckets (1) divisible by the " \
            "data-axis size (2)" in rank["printed"]
        assert "falling back to GSPMD" in rank["printed"]
        assert np.isfinite(rank["history"][0]["train_loss"])
