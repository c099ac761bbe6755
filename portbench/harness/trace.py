"""A profiled sub-window reduced to what the per-layer metrics read.

``profile_window(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and
CUDA activities) inside a ``portbench::window`` range that ends in a
synchronize, exports the Chrome trace to a temporary file in ``TMPDIR``,
reads it and deletes it. ``reduce_trace`` turns its events into a
``Trace``:

* device operations (kernels, copies, sets) clipped to the window; busy
  seconds, the union of their intervals; the kernels' count;
* device seconds by named host range: a kernel belongs to a range when
  the host call that launched it (its CUDA runtime or driver call, by
  correlation id) lies inside an event of that name on the same thread,
  which is how the kernels of an autograd node's backward, run on the
  engine's thread, are found;
* the breakdown: the device operations that took most time, and the
  idle gaps summed by the innermost host operation on the window's thread
  that was running at each gap's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

WINDOW = "portbench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    h2d_s: float
    range_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _merge(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _launch_places(events) -> Dict[int, Tuple[object, float]]:
    """correlation id -> (thread, timestamp) of the host call that
    launched it."""
    out = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                out[corr] = (e.get("tid"), e["ts"])
    return out


def reduce_trace(events: Sequence[Dict], ranges: Sequence[str] = ()
                 ) -> Trace:
    """The ``Trace`` of Chrome trace ``events`` (times in microseconds);
    ``ranges``: host event names whose kernels' device time to sum."""
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X"]
    if not marks:
        raise ValueError(f"trace has no {WINDOW!r} range")
    mark = max(marks, key=lambda e: e["dur"])
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                device.append((e, a, b))
    busy = _merge((a, b) for _, a, b in device)
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = defaultdict(float)
    for e, a, b in device:
        by_name[e["name"]] += b - a
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # device time of the kernels launched inside each named range
    spans: Dict[str, Dict[object, List[Tuple[float, float]]]] = {
        r: defaultdict(list) for r in ranges}
    for e in events:
        if e.get("name") in spans and e.get("ph") == "X":
            spans[e["name"]][e.get("tid")].append(
                (e["ts"], e["ts"] + e["dur"]))
    for r in spans:
        for tid in spans[r]:
            spans[r][tid] = _merge(spans[r][tid])
    places = _launch_places(events)
    range_us: Dict[str, float] = defaultdict(float)
    for e, a, b in device:
        if e.get("cat") != "kernel":
            continue
        place = places.get((e.get("args") or {}).get("correlation"))
        if place is None:
            continue
        tid, ts = place
        for r in spans:
            iv = spans[r].get(tid, [])
            i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                range_us[r] += b - a

    # idle gaps, named by what the window's thread was running
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("tid") == mark.get("tid") and e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "user_annotation",
                                        "python_function", *LAUNCH_CATS)
                   and e is not mark))
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        name = "python (no op)"
        # the latest-starting host event that still runs at mid is the
        # innermost one
        j = bisect.bisect_right(starts, mid) - 1
        for i in range(j, max(j - 4096, -1), -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        idle[name] += b - a
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]

    h2d = sum(b - a for e, a, b in device
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"])
    return Trace(
        window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
        kernels=sum(1 for e, _, _ in device if e.get("cat") == "kernel"),
        h2d_s=h2d * 1e-6,
        range_s={r: range_us.get(r, 0.0) * 1e-6 for r in ranges},
        device_ops=[(n, s * 1e-6) for n, s in device_ops],
        idle_gaps=[(n, s * 1e-6) for n, s in idle_gaps])


def profile_window(fn: Callable[[], None], ranges: Sequence[str] = (),
                   cuda: bool = True) -> Trace:
    """``fn`` under ``torch.profiler`` inside the window range, ended by a
    synchronize, reduced to a ``Trace`` (``cuda`` False: the host's side
    alone, for tests on the CPU)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce_trace(events, ranges)
