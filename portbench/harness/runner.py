"""One run of one cell: the driver's set-up, window and check, then the
result line.

``execute`` takes a resolved cell (``manifest.resolve``) and a device;
``run_cell`` is the command's path, which first refuses to run without
as many CUDA cards as the cell asks for. The result is the last line of
standard output, the compared numbers beside their limits the last lines
of standard error.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

from .compare import judge
from .manifest import ROOT, Cell, driver, load_manifest, metric_module, \
    resolve
from .trace import Trace

#: top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "multimodal_plankton_recognition_tpu")


@dataclasses.dataclass
class Record:
    """What the per-layer metrics read of one run: the cell's card, the
    units (train steps or served calls) of the unprofiled phase with their
    wall time and each train step's dispatch time on the host, the
    profiled sub-window's ``Trace`` (``--trace 1`` only), the mean live
    keys of the profiles and the gallery's rows."""

    kind: str
    card: Dict
    batch: int
    buckets: int
    units: int
    wall_s: float
    dispatch_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None
    trace_units: int = 0
    profile_keys: Optional[float] = None
    gallery_rows: int = 0


@dataclasses.dataclass
class RunOutput:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    record: Record
    #: seconds from the process's start at the end of each set-up phase
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def device_info(device, count: int) -> Dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count}
    return {"platform": device.type, "kind": device.type, "count": count}


def assemble(cell: Cell, out: RunOutput, trace: bool, device
             ) -> Tuple[Dict, List[str]]:
    """(result line, check lines)."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_module(m["name"]).read(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = out.memory_peak_bytes
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    t = out.record.trace
    if trace and t is not None:
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    limits = cell.limits["numbers"]
    bad = judge(out.numbers, limits)
    result["correct"] = not bad and out.failed == 0
    checks = {n: {"value": _finite(out.numbers.get(n)),
                  "limit": limits[n]["limit"]} for n in limits}
    result["checks"] = checks
    lines = ["setup phases (s from start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.phases.items())]
    lines += [f"check {n}: {out.numbers.get(n)!r} (limit {c['limit']!r})"
             + (" FAILED" if n in bad else "") for n, c in checks.items()]
    lines.append(f"check failed_units: {out.failed} (limit 0)")
    return result, lines


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float) -> Tuple[int, Optional[Dict], List[str]]:
    """(exit code, result or None, check lines) of one run. A traced run
    sums the device time of the host ranges its per-layer metrics name
    (a reader's ``RANGES``)."""
    ranges = sorted({r for m in cell.per_layer
                     for r in getattr(metric_module(m["name"]), "RANGES", ())})
    out = driver(cell.traffic["driver"]).run(
        cell, seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
        ranges=ranges)
    found = banned_modules()
    if found:
        return 3, None, [f"refused: the run imported {', '.join(found)}"]
    result, lines = assemble(cell, out, trace, device)
    return 0, result, lines


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float) -> int:
    import torch

    cell = resolve(workload, load_manifest(ROOT), ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"refused: {workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    code, result, lines = execute(cell, seed, seconds, trace,
                                  torch.device("cuda", 0), t0)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    if result is None:
        return code
    print(json.dumps(result, allow_nan=False), flush=True)
    return code


def _finite(x: Optional[float]) -> Optional[float]:
    """``x``, or None where it is missing or not finite (JSON has no
    infinity)."""
    return x if x is not None and math.isfinite(x) else None
