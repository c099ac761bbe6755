"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Its configuration is the file the manifest gives; its traffic mix is
``portbench/traffic/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``; its correctness limits are
``portbench/limits/<cell>.json``; each per-layer metric is read by
``portbench/metrics/<metric>.py``. A later cell or metric adds files and
entries and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
MANIFEST = "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / MANIFEST) as f:
        return json.load(f)


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str, moves_ok=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_ok is None or metric["moves"] in moves_ok


def resolve(workload: str, manifest: Dict, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with every file it needs read."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {MANIFEST} "
                       f"(workloads: {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    bench = root / "portbench"
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(bench / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver(name: str):
    """The module of ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_module(name: str):
    """The module of ``portbench/metrics/<name>.py``: ``read(record)``
    and, where it reads device time by host range, ``RANGES`` (a metric's
    name may hold dots, so the file is loaded by its path)."""
    path = PORTBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
