"""``correct`` on the CPU at tiny sizes: sound runs of the timed path
hold the cells' limits; the control (the reference at float8 in the
program's place) and each fault a cell can have, planted in the program
underneath an otherwise whole run, do not. Widths are the cells'; the
images, batches and gallery are cut (``tests/cells.py``)."""

import time

import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_torch.models import build
from multimodal_plankton_recognition_torch.models import multi as port_multi
from multimodal_plankton_recognition_torch.retrieval import export
from portbench.harness import compare
from portbench.harness.manifest import driver
from portbench.harness.runner import execute
from portbench.harness.taps import FAULTS, plant_fault
from portbench.tests.cells import tiny
from portbench.reference.precision import FP8

TRAIN = ["vit_t16_tf2_clip.train_b512", "effb0_cnn2_clip.train_b256"]
CLASSIFY = ["vit_t16_tf2_clip.classify_b256",
            "effb0_cnn2_clip.classify_b256"]
SEED = 2 ** 35 + 17  # past 32 bits, as the driver's seeds are
CPU = torch.device("cpu")
torch.set_num_threads(4)


def _run(cell):
    code, result, lines = execute(cell, SEED, 0.5, False, CPU,
                                  time.perf_counter())
    assert code == 0, lines
    assert lines[-1].startswith("check failed_units")
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("name", ["vit_t16_tf2_clip.train_b512",
                                  "vit_t16_tf2_clip.classify_b256"])
def test_sound_run_is_correct(name):
    result = _run(tiny(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("name", TRAIN + CLASSIFY)
def test_control_fails(name):
    """The reference at float8 in the program's place fails at least one
    of the cell's numbers."""
    cell = tiny(name)
    numbers = driver(cell.traffic["driver"]).control_numbers(
        cell, SEED, CPU, FP8)
    assert compare.judge(numbers, cell.limits["numbers"]), numbers


@pytest.fixture
def unchanged_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer's update
    does nothing."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, *a, **k: None)


@pytest.fixture
def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    loss = port_multi.MultiModel.loss

    def half(self, buckets=1, label=None, **batch):
        n = next(iter(batch.values())).shape[0] // 2
        return loss(self, buckets=max(1, buckets // 2), label=label,
                    **{k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(port_multi.MultiModel, "loss", half)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_faults_fail(name, fault, request):
    request.getfixturevalue(fault)
    assert not _run(tiny(name))["correct"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("kind", FAULTS)
def test_dropout_faults_fail(name, kind):
    """A dropout fault planted at every site of the program (nothing
    dropped, kept values unscaled, or twice the rate) underneath the
    window's steps: the dropout numbers fail."""
    undo = plant_fault(kind)
    try:
        result = _run(tiny(name))
    finally:
        undo()
    assert not result["correct"]
    assert {n for n, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]} \
        & {"attn_drop_var_z", "attn_drop_bias_z", "drop_share_z",
           "drop_scale_gap"}, result["checks"]


def test_program_bucket_rule_must_match_the_cards(monkeypatch):
    """The reference takes the card's buckets by the benchmark's own rule;
    a program step that would take others is refused before it runs."""
    monkeypatch.setattr(build, "step_buckets", lambda card: 1)
    with pytest.raises(ValueError, match="contrastive buckets"):
        _run(tiny("vit_t16_tf2_clip.train_b512"))


@pytest.fixture
def altered_answer(monkeypatch):
    """A class altered where it is produced."""
    call = export.ServingModel.call

    def altered(self, batch):
        out = call(self, batch)
        out["class_id"] = (out["class_id"] + 1) % out["votes"].shape[1]
        return out

    monkeypatch.setattr(export.ServingModel, "call", altered)


@pytest.fixture
def half_served(monkeypatch):
    """Half of the batch left out: the second half's answers are the
    first half's."""
    call = export.ServingModel.call

    def half(self, batch):
        out = call(self, batch)
        for v in out.values():
            n = v.shape[0] // 2
            v[n:2 * n] = v[:n]
        return out

    monkeypatch.setattr(export.ServingModel, "call", half)


@pytest.mark.parametrize("name", CLASSIFY)
@pytest.mark.parametrize("fault", ["altered_answer", "half_served"])
def test_classify_faults_fail(name, fault, request):
    request.getfixturevalue(fault)
    assert not _run(tiny(name))["correct"]


def test_numbers_hold_their_own_limits():
    """``judge``: a number over its limit, missing or not finite fails."""
    limits = {"a": {"limit": 1.0}, "b": {"limit": 2.0}}
    assert compare.judge({"a": 0.5, "b": 2.0}, limits) == []
    assert compare.judge({"a": 1.5, "b": 0.0}, limits) == ["a"]
    assert compare.judge({"a": np.inf}, limits) == ["a", "b"]
