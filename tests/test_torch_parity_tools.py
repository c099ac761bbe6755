"""The port's dataset-packing CLI and its real-data parity harness
(``scripts/pack_dataset_torch.py``, ``scripts/parity_real_torch.py``)
against the JAX package's, on the CPU:

* ``pack_dataset_torch.py`` writes a cache byte for byte the one the JAX
  package's ``pack_split`` writes for the same CSV, and prints
  ``scripts/pack_dataset.py``'s lines (a missing split skipped);
* ``parity_real_torch.py``: the reference tables equal the JAX
  harness's and appear in BASELINE.md, folds beyond the split count
  refused before any IO, ``_diff``'s classification (JAX's
  ``tests/test_parity_real.py``, ported); a prepared card is JAX's with
  the converted weights wired in; the folds come from
  ``scripts/split_kfold.py`` with JAX's arguments unless the caller wrote
  them; ``--dry-run`` end to end on the CPU from folds written without
  scikit-learn (``chip_smoke.write_folds``, as on the card): every stage,
  the report and its 8 setups.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

from multimodal_plankton_recognition_tpu.data.packed import (
    pack_split as jax_pack_split,
)
from multimodal_plankton_recognition_torch.data.packed import cache_dir
from multimodal_plankton_recognition_torch.data.synthetic import (
    make_synthetic_dataset,
)

from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SETUPS = {"I - I", "I - P", "I - I+P", "P - I", "P - P", "P - I+P",
          "I+P - I", "I+P - P"}


def _script(name, where=REPO / "scripts"):
    spec = importlib.util.spec_from_file_location(name, where / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def test_pack_cli_writes_the_jax_cache(tmp_path, capsys):
    split = make_synthetic_dataset(tmp_path / "data", n_classes=3,
                                   n_per_class=4, seed=5)
    _script("pack_dataset_torch").main(
        ["-d", str(split), "-t", "32", "--splits", "train.csv", "test.csv",
         "nope.csv"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    for line, name in zip(lines, ("train", "test")):
        csv_path, out = split / f"{name}.csv", cache_dir(split / f"{name}.csv",
                                                         32)
        assert re.fullmatch(rf"packed {re.escape(str(csv_path))} -> "
                            rf"{re.escape(str(out))} \(\d+\.\d MB, "
                            rf"\d+\.\ds\)", line), line
        want = jax_pack_split(csv_path, 32, out_dir=tmp_path / f"jax_{name}")
        files = sorted(p.name for p in out.iterdir())
        assert files == sorted(p.name for p in want.iterdir())
        assert "meta.json" in files and "images.npy" in files
        for f in files:
            assert (out / f).read_bytes() == (want / f).read_bytes(), f
    assert lines[2] == f"skip {split / 'nope.csv'}: not found"


def test_expected_tables_match_baseline_and_jax():
    port, jax_harness = _script("parity_real_torch"), _script("parity_real")
    text = (REPO / "BASELINE.md").read_text()
    for model, acc in port.CELL12_FUSED_ACC.items():
        assert f"{acc:.2f}" in text, (model, acc)
    for model, row in port.CELL22_CROSS_ACC.items():
        assert set(row) == SETUPS, model
        for setup, acc in row.items():
            assert f"{acc:.2f}" in text, (model, setup, acc)
    for name in port.ALL_CARDS:
        assert (REPO / "model_cards" / "multi" / f"{name}.yaml").exists()
    assert set(port.FLAGSHIP_CARDS) <= set(port.ALL_CARDS)
    for table in ("CELL12_FUSED_ACC", "CELL22_CROSS_ACC", "FLAGSHIP_CARDS",
                  "ALL_CARDS", "DRY_CARD"):
        assert getattr(port, table) == getattr(jax_harness, table), table


def test_folds_validated_before_training(monkeypatch):
    """--folds beyond --n-folds dies at argument time (exit 2), before
    any IO: --data points nowhere."""
    port = _script("parity_real_torch")
    with pytest.raises(SystemExit) as e:
        port.main(["--data", "/nonexistent", "--folds", "6"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        port.main(["--data", "/nonexistent", "--folds", "0"])
    assert e.value.code == 2


def test_diff_tolerance_classification():
    port = _script("parity_real_torch")
    failures = []
    ok = port._diff(96.0, 96.2, tol=2.0, label="x", failures=failures)
    assert ok["within_tolerance"] and not failures
    bad = port._diff(90.0, 96.2, tol=2.0, label="y", failures=failures)
    assert not bad["within_tolerance"]
    assert len(failures) == 1 and "y" in failures[0]
    assert bad["delta_pct"] == -6.2


def test_prepared_card_is_jax_s(tmp_path):
    """The shipped card with the converted weights wired in and the
    epochs cut, as JAX's harness prepares it (JSON here, YAML there)."""
    import yaml

    port, jax_harness = _script("parity_real_torch"), _script("parity_real")
    weights = tmp_path / "vit.npz"
    args = type("Args", (), {"weights_vit": str(weights), "weights_b0": None,
                             "max_epochs": 3})
    for name in port.FLAGSHIP_CARDS:
        got = json.loads(port._prepare_card(name, args, tmp_path).read_text())
        want = yaml.safe_load(
            jax_harness._prepare_card(name, args, tmp_path).read_text())
        assert got == want
        assert got["trainer_args"]["max_epochs"] == 3
        assert got["image_encoder_args"].get("pretrained_path") == (
            str(weights.resolve()) if name.startswith("vit") else None)


def test_folds_come_from_split_kfold(tmp_path, monkeypatch):
    port = _script("parity_real_torch")
    (tmp_path / "annotations.csv").write_text("image,profile,class\n")
    calls = []
    monkeypatch.setattr(port.subprocess, "run",
                        lambda argv, check: calls.append(argv))
    args = type("Args", (), {"data": str(tmp_path), "split_name": "fold",
                             "n_folds": 5})
    assert port._ensure_dataset(args) == tmp_path
    assert calls == [[sys.executable,
                      str(REPO / "scripts" / "split_kfold.py"), "-d",
                      str(tmp_path), "-k", "5", "-n", "fold", "-s", "0"]]
    (tmp_path / "fold1").mkdir()
    (tmp_path / "fold1" / "train.csv").write_text("")
    port._ensure_dataset(args)
    assert len(calls) == 1  # the caller's folds are taken as they are


def test_dry_run_end_to_end(tmp_path, monkeypatch, capsys):
    port = _script("parity_real_torch")
    work = tmp_path / "work"
    make_synthetic_dataset(work / "data", **port.DRY_DATA)
    _script("chip_smoke", REPO).write_folds(work / "data", 2, 0)
    monkeypatch.setattr(port.subprocess, "run", None)  # no split_kfold
    report = port.main(["--dry-run", "--device", "cpu", "--workdir",
                        str(work), "-o", str(tmp_path / "report.json")])
    out = capsys.readouterr().out
    assert "DRY-RUN PLUMBING OK" in out
    assert out.count("== train dry_flagship fold") == 2
    assert json.loads((tmp_path / "report.json").read_text()) == report
    assert set(report) == {"args", "fused_gallery", "cross_modal",
                           "failures"}
    assert report["failures"] == []
    fused = report["fused_gallery"]["dry_flagship"]
    assert set(fused) == {"acc_pct", "std_pct"} and 0 <= fused["acc_pct"] <= 100
    cross = report["cross_modal"]["dry_flagship"]
    assert set(cross) == SETUPS
    assert all(set(c) == {"acc_pct", "std_pct"} for c in cross.values())
    assert report["args"]["device"] == "cpu"
    assert report["args"]["folds"] == "2"
    for k in (1, 2):
        run = work / "logs" / f"fold{k}" / f"dry_flagship_data_fold{k}"
        assert (run / "version_0" / "checkpoints").is_dir(), run
