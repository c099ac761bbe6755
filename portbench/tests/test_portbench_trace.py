"""The trace's reduction on a hand-made Chrome trace, and the command's
refusals on a machine without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness.manifest import ROOT
from portbench.harness.trace import WINDOW, reduce_trace


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _trace():
    """A window 0-100 us; on the main thread (1) an attention forward
    range launching kernel k1 (correlation 1), a copy; on the autograd
    thread (2) a backward node launching k2 (correlation 2); an
    unrelated kernel k3 (correlation 3); an idle gap 60-90 us while the
    host sits in ``aten::item``."""
    return [
        _x(WINDOW, "user_annotation", 0, 100),
        _x("_MhaQkv", "cpu_op", 1, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
        _x("_MhaQkvBackward", "cpu_op", 10, 5, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 11, 1, tid=2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 1, correlation=3),
        _x("aten::item", "cpu_op", 55, 40),
        _x("k1", "kernel", 5, 10, tid=7, correlation=1),
        _x("k2", "kernel", 15, 20, tid=7, correlation=2),
        _x("k3", "kernel", 35, 25, tid=7, correlation=3),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 90, 20, tid=8),
    ]


def test_reduce_trace():
    t = reduce_trace(_trace(), ("_MhaQkv", "_MhaQkvBackward", "_Mha"))
    assert t.window_s == pytest.approx(100e-6)
    # busy 5-60 and 90-100 (the copy clipped to the window)
    assert t.busy_s == pytest.approx(65e-6)
    assert t.kernels == 3
    assert t.h2d_s == pytest.approx(10e-6)
    assert t.range_s == pytest.approx({"_MhaQkv": 10e-6,
                                       "_MhaQkvBackward": 20e-6,
                                       "_Mha": 0.0})
    assert t.device_ops[0] == ("k3", pytest.approx(25e-6))
    gaps = dict(t.idle_gaps)
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(35e-6)


def test_trace_without_window_is_refused():
    with pytest.raises(ValueError):
        reduce_trace(_trace()[1:])


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vit_t16_tf2_clip.train_b512", "--seed", str(2 ** 33 + 5),
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result."""
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and ``portbench/``
    the command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
