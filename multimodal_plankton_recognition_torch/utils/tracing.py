"""Spans and counters inside the port, recorded while a ``torch.profiler``
records and not otherwise.

``span(name)`` opens ``torch.profiler.record_function("plankton::<name>")``,
so the range lands in the profiler's Chrome trace beside the kernels it
launches and on their clock, and adds its host duration to a table;
``count(name, n)`` adds ``n`` to a counter. With no profiler recording
neither does anything: ``span`` returns a shared no-op context after one
flag check, and makes no generator and no string.

``table()`` gives, per span name, its count, total host seconds and self
seconds (total less the time its child spans on the same thread cover);
``counters()`` the counters; ``reset()`` empties both. The table holds
only what ran while a profiler recorded, so its times carry the
profiler's slowdown of the host.
"""

from __future__ import annotations

import contextlib
import threading
from time import perf_counter_ns
from typing import Dict, Iterator

import torch

PREFIX = "plankton::"

_recording = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
#: span name -> [count, total ns, ns covered by its child spans]
_spans: Dict[str, list] = {}
_counters: Dict[str, int] = {}


def span(name: str):
    """A context: the range ``plankton::<name>`` and a row of the table
    while a profiler records, else nothing."""
    if not _recording():
        return _NOOP
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str) -> Iterator[None]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(0)
    t0 = perf_counter_ns()
    try:
        with torch.profiler.record_function(PREFIX + name):
            yield
    finally:
        dt = perf_counter_ns() - t0
        children = stack.pop()
        if stack:
            stack[-1] += dt
        with _lock:
            row = _spans.setdefault(name, [0, 0, 0])
            row[0] += 1
            row[1] += dt
            row[2] += children


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def table() -> Dict[str, Dict[str, float]]:
    """{span name: {"count", "total_s", "self_s"}} of what was recorded."""
    with _lock:
        return {name: {"count": c, "total_s": t * 1e-9,
                       "self_s": (t - kids) * 1e-9}
                for name, (c, t, kids) in _spans.items()}


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
