"""The port's spans and counters (``utils/tracing.py``) on the CPU: nothing
recorded without a profiler; under one, the train step's and the served
call's spans nested in order in the profiler's Chrome trace, their table
and the bytes counter; no bit of a train step changed by recording; the
exported program's graph untouched; the functions the benchmark's taps
rebind by name still plain functions."""

import contextlib
import copy
import inspect
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.models import attention as \
    model_attention
from multimodal_plankton_recognition_torch.models import dropout as \
    model_dropout
from multimodal_plankton_recognition_torch.models.build import build_for_kind
from multimodal_plankton_recognition_torch.models.image import vit
from multimodal_plankton_recognition_torch.ops import attention
from multimodal_plankton_recognition_torch.retrieval import export as ex
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_optimizer)
from multimodal_plankton_recognition_torch.utils import tracing
from torch_threads import one_thread  # noqa: F401  (autouse)

TS = 32
STEP = ("train.load", "train.forward", "train.backward", "train.update")
SERVE = ("serve.copy_in", "serve.program", "serve.copy_out")


def _card(dropout=0.0):
    return config.ModelCard.from_dict({
        "bs": 4, "dim_embedding": 16, "target_size": TS,
        "image_encoder_args": {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": dropout,
            "backbone_kwargs": {"img_size": TS, "depth": 1, "embed_dim": 48,
                                "num_heads": 3}},
        "profile_encoder_args": {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 32,
            "num_head": 2, "num_layers": 1, "target_size": TS,
            "dim_feedforward": 48, "fused_attention": True,
            "dropout": dropout},
        "coordination_args": {"method": "clip"},
        "trainer_args": {"precision": "32"}})


def _batch(card, b=4, seed=0):
    """Host arrays of the card's input spec: normal floats, no padding."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, dtype) in ex.batch_spec(card, "multi").items():
        shape = tuple(b if d is None else d for d in shape)
        if dtype == "float32":
            out[key] = rng.normal(size=shape).astype(np.float32)
        elif dtype == "bool":
            out[key] = np.zeros(shape, dtype=bool)
        else:
            out[key] = rng.integers(1, 30, size=shape).astype(np.int32)
    return out


def _stepper(card):
    """(state, train_step) of the card's model from seed 0's weights."""
    torch.manual_seed(0)
    model = build_for_kind(card, "multi")
    tx = make_optimizer(card.optim_args, 1)
    state = create_train_state(model, copy.deepcopy(model.state_dict()), tx)
    return state, make_multi_steps(model, tx, buckets=2)[0]


def _trained(card, steps, profiled):
    """(losses, masters) of ``steps`` train steps, under a CPU profiler
    or not."""
    state, train_step = _stepper(card)
    batches = [{k: torch.from_numpy(v) for k, v in _batch(card, seed=s)
                .items()} for s in (1, 2)]
    losses = []
    with profile(activities=[ProfilerActivity.CPU]) if profiled \
            else contextlib.nullcontext():
        for i in range(steps):
            state, loss = train_step(state, batches[i % 2], 7)
            losses.append(loss)
    return losses, {n: p.detach().clone() for n, p in state.params.items()}


def _ranges(prof, tmp_path):
    """{name: [(start, end)]} of the ``plankton::`` ranges on the host in
    the profiler's exported Chrome trace, in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = {}
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        if e.get("ph") == "X" and e["name"].startswith(tracing.PREFIX):
            out.setdefault(e["name"][len(tracing.PREFIX):], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_nothing_recorded_without_a_profiler():
    tracing.reset()
    with tracing.span("a"):
        tracing.count("b", 3)
    assert tracing.table() == {} and tracing.counters() == {}
    # one shared no-op context: no generator, no string
    assert tracing.span("a") is tracing.span("c")


def test_span_self_time_is_total_less_children():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
                with tracing.span("inner"):
                    pass
        tracing.count("n", 5)
        tracing.count("n", 2)
    table = tracing.table()
    assert table["outer"]["count"] == 2 and table["inner"]["count"] == 4
    assert table["inner"]["self_s"] == table["inner"]["total_s"]
    assert table["outer"]["self_s"] == pytest.approx(
        table["outer"]["total_s"] - table["inner"]["total_s"], abs=1e-12)
    assert tracing.counters() == {"n": 7}
    tracing.reset()
    assert tracing.table() == {} and tracing.counters() == {}


def test_train_step_spans_nest_in_order(tmp_path):
    card = _card()
    tracing.reset()
    state, train_step = _stepper(card)
    batch = {k: torch.from_numpy(v) for k, v in _batch(card).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch, 0)
    ranges = _ranges(prof, tmp_path)
    (step,) = ranges["train.step"]
    phases = [ranges[name] for name in STEP]
    assert all(len(p) == 1 and _inside(p[0], step) for p in phases)
    starts_ends = [x for (p,) in phases for x in p]
    assert starts_ends == sorted(starts_ends)  # in order, not overlapping
    table = tracing.table()
    assert {n: r["count"] for n, r in table.items()} == dict.fromkeys(
        ("train.step", *STEP), 1)
    children = sum(table[n]["total_s"] for n in STEP)
    assert table["train.step"]["self_s"] == pytest.approx(
        table["train.step"]["total_s"] - children, abs=1e-12)
    assert table["train.step"]["self_s"] >= 0
    tracing.reset()


def test_recording_changes_no_bit_of_a_step():
    card = _card(dropout=0.2)
    losses_on, params_on = _trained(card, 3, profiled=True)
    losses_off, params_off = _trained(card, 3, profiled=False)
    tracing.reset()
    assert all(torch.equal(a, b) for a, b in zip(losses_on, losses_off))
    assert params_on.keys() == params_off.keys()
    assert all(torch.equal(params_on[n], params_off[n]) for n in params_on)


def _program(card):
    torch.manual_seed(0)
    model = build_for_kind(ex._strip_fused(card), "multi").eval()
    rng = np.random.default_rng(3)
    gallery = rng.normal(size=(2, 6, 16)).astype(np.float32)
    return ex.export_retrieval_inference(
        model, card, gallery[0], gallery[1], np.array([0, 1, 2, 0, 1, 2]),
        n_classes=3, k=3, platforms=("cpu",), batch_size=4)["cpu"]


def _nodes(program):
    return [(n.op, str(n.target)) for n in program.graph.nodes]


@pytest.fixture(scope="module")
def program():
    return _program(_card())


def test_serving_call_spans_and_bytes(program, tmp_path):
    card = _card()
    spec = {k: {"shape": list(s), "dtype": d}
            for k, (s, d) in ex.batch_spec(card, "multi").items()}
    serving = ex.ServingModel(program, {"input_spec": spec},
                              torch.device("cpu"))
    batch = _batch(card)
    plain = serving.call(batch)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = serving.call(batch)
    assert out.keys() == plain.keys()
    assert all(np.array_equal(out[k], plain[k]) for k in out)
    ranges = _ranges(prof, tmp_path)
    (call,) = ranges["serve.call"]
    phases = [ranges[name] for name in SERVE]
    assert all(len(p) == 1 and _inside(p[0], call) for p in phases)
    starts_ends = [x for (p,) in phases for x in p]
    assert starts_ends == sorted(starts_ends)
    table = tracing.table()
    assert {n: r["count"] for n, r in table.items()} == dict.fromkeys(
        ("serve.call", *SERVE), 1)
    assert tracing.counters() == {
        "serve.h2d_bytes": sum(a.nbytes for a in batch.values())}
    tracing.reset()


def test_exported_graph_holds_no_span(program):
    """Exported while a profiler records or not, the program's graph has
    the same nodes, and none of them is a profiler op."""
    card = _card()
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = _program(card)
    tracing.reset()
    assert _nodes(recorded) == _nodes(program)
    assert not [t for _, t in _nodes(program)
                if "profiler" in t or "record_function" in t]


def test_tapped_functions_are_plain():
    """The benchmark's taps rebind ``mha_qkv`` and ``dropout`` by name in
    the modules that import them: both stay plain module functions, the
    same objects there."""
    for fn, home, users in (
            (attention.mha_qkv, attention, (model_attention,)),
            (model_dropout.dropout, model_dropout, (vit,))):
        assert inspect.isfunction(fn)
        assert fn.__module__ == home.__name__
        assert all(getattr(m, fn.__name__) is fn for m in users)
