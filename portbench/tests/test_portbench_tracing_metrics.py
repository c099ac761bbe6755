"""The readers of the program's spans and counters on a hand-made
``Record``, ``Trace`` and span table: each reads its value, and nothing
where the table is empty, where its count of units is not the profiled
sub-window's, or where the program has no span module at all."""

import sys

import pytest

from multimodal_plankton_recognition_torch.utils import tracing
from portbench.harness.manifest import metric_module
from portbench.harness.runner import Record
from portbench.harness.trace import Trace

UNITS = 8
TRAIN_TABLE = {
    "train.step": {"count": UNITS, "total_s": 1.0, "self_s": 0.04},
    "train.load": {"count": UNITS, "total_s": 0.05, "self_s": 0.05},
    "train.forward": {"count": UNITS, "total_s": 0.4, "self_s": 0.4},
    "train.backward": {"count": UNITS, "total_s": 0.3, "self_s": 0.3},
    "train.update": {"count": UNITS, "total_s": 0.21, "self_s": 0.21},
}
SERVE_TABLE = {
    "serve.call": {"count": UNITS, "total_s": 0.5, "self_s": 0.01},
    "serve.copy_in": {"count": UNITS, "total_s": 0.1, "self_s": 0.1},
    "serve.program": {"count": UNITS, "total_s": 0.16, "self_s": 0.16},
    "serve.copy_out": {"count": UNITS, "total_s": 0.23, "self_s": 0.23},
}
BYTES = 52_000_000  # a call's arrays


def _record(kind, units=UNITS, h2d_s=0.064, forward_s=0.12):
    trace = Trace(window_s=1.0, busy_s=0.7, kernels=100, h2d_s=h2d_s,
                  range_s={"plankton::train.forward": forward_s},
                  device_ops=[], idle_gaps=[])
    return Record(kind=kind, card={}, batch=256, buckets=16, units=100,
                  wall_s=20.0, trace=trace, trace_units=units)


@pytest.fixture
def program(monkeypatch):
    """Set the program's span table and counters."""
    def put(table, counters=None):
        monkeypatch.setattr(tracing, "table", lambda: table)
        monkeypatch.setattr(tracing, "counters", lambda: counters or {})
    return put


CASES = [
    ("forward_device_ms.train", "train", TRAIN_TABLE, {}, 0.12 / 8 * 1e3),
    ("forward_host_ms.train", "train", TRAIN_TABLE, {}, 0.4 / 8 * 1e3),
    ("update_host_ms.train", "train", TRAIN_TABLE, {}, 0.26 / 8 * 1e3),
    ("program_host_ms.classify", "classify", SERVE_TABLE, {},
     0.16 / 8 * 1e3),
    ("h2d_gbps.classify", "classify", SERVE_TABLE,
     {"serve.h2d_bytes": BYTES * UNITS}, BYTES / (0.064 / 8) * 1e-9),
]
NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name,kind,table,counters,want", CASES, ids=NAMES)
def test_reads_its_value(program, name, kind, table, counters, want):
    program(table, counters)
    got = metric_module(name).read(_record(kind))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,kind,table,counters,want", CASES, ids=NAMES)
def test_nothing_on_an_empty_table(program, name, kind, table, counters,
                                   want):
    program({}, {})
    assert metric_module(name).read(_record(kind)) is None


@pytest.mark.parametrize("name,kind,table,counters,want", CASES, ids=NAMES)
def test_nothing_on_a_count_mismatch(program, name, kind, table, counters,
                                     want):
    program(table, counters)
    assert metric_module(name).read(_record(kind, units=UNITS + 1)) is None


@pytest.mark.parametrize("name,kind,table,counters,want", CASES, ids=NAMES)
def test_nothing_without_the_span_module(program, monkeypatch, name, kind,
                                         table, counters, want):
    """A program without ``utils/tracing.py`` (the parent of these
    readers) reads nothing and raises nothing."""
    import multimodal_plankton_recognition_torch.utils as utils

    program(table, counters)
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, tracing.__name__, None)
    assert metric_module(name).read(_record(kind)) is None


@pytest.mark.parametrize("name,kind,table,counters,want", CASES, ids=NAMES)
def test_nothing_in_the_other_kind_or_without_a_trace(
        program, name, kind, table, counters, want):
    program(table, counters)
    other = "classify" if kind == "train" else "train"
    assert metric_module(name).read(_record(other)) is None
    untraced = _record(kind)
    untraced.trace = None
    assert metric_module(name).read(untraced) is None


def test_device_readers_need_device_time(program):
    program(TRAIN_TABLE)
    assert metric_module("forward_device_ms.train").read(
        _record("train", forward_s=0.0)) is None
    program(SERVE_TABLE, {"serve.h2d_bytes": BYTES * UNITS})
    assert metric_module("h2d_gbps.classify").read(
        _record("classify", h2d_s=0.0)) is None
