"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from portbench.harness.manifest import (
    PORTBENCH, ROOT, driver, load_manifest, metric_module, resolve)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    assert 2 + 14 * 24 * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    """Each cell's configuration, traffic mix, driver, limits and metric
    readers are found by name; it reports set-up, another end-to-end
    metric and a per-layer one."""
    c = resolve(cell, MANIFEST)
    assert c.config["name"] == next(w["config"] for w in MANIFEST[
        "workloads"] if w["name"] == cell)
    assert hasattr(driver(c.traffic["driver"]), "run")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(metric_module(m["name"]).read)
    assert c.limits["numbers"]


def test_config_files_hold_the_cards():
    """Each configuration file is its card as run, with ``reduced``
    naming every top-level key changed from the shipped card."""
    import yaml

    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        shipped = yaml.safe_load((ROOT / cfg["card_file"]).read_text())
        changed = {k for k in set(shipped) | set(cfg["card"])
                   if shipped.get(k) != cfg["card"].get(k)}
        assert changed == set(cfg["reduced"]) == set(c["reduced"])


def test_every_file_belongs_to_a_name():
    """No orphans: every traffic, limits and metric file is named by the
    manifest."""
    traffic = {w["traffic"] for w in MANIFEST["workloads"]}
    assert {p.stem for p in (PORTBENCH / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (PORTBENCH / "limits").glob("*.json")} \
        == set(CELLS)
    metrics = {m["name"] for m in MANIFEST["per_layer"]}
    assert {p.name[:-3] for p in (PORTBENCH / "metrics").glob("*.py")} \
        == metrics
