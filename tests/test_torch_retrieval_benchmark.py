"""The port's gallery-retrieval benchmark (``retrieval/benchmark.py``) and
its CLIs (``scripts/benchmark_*_torch.py``, ``scripts/results_torch.py``)
against the JAX package's.

On one seeded embeddings pickle (continuous random embeddings, so no two
distances tie) ``run_suite`` gives JAX's results in all four modes at the
same seed, class name for class name (the port's kNN on the CPU), with
the same skip lines; the threshold error and one-process sharded
retrieval (the default's results); the
CLIs write the pickles JAX's CLIs write, the results CLI prints what
JAX's prints, and each package's ``accuracy_table`` reads the other's
pickle."""

import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.retrieval import (
    benchmark as jax_bench, results as jax_R,
)
from multimodal_plankton_recognition_torch.retrieval import (
    benchmark as bench, results as R,
)
from multimodal_plankton_recognition_torch.utils import LabelVocab

REPO = Path(__file__).resolve().parent.parent
DIM = 16
# per class, the pool of the flat layout: genus_3 and genus_5 fall under
# the default threshold of 20, and the smallest kept class (22) makes raw
# and cross skip n = 22 (n >= n_cap). A fold of the nested layout holds
# the first five, genus_3's 12 train rows keep n = 12 in the folds modes
# and skip n = 16 (n > n_cap)
COUNTS = {"genus_0": 41, "genus_1": 33, "genus_2": 27, "genus_3": 16,
          "genus_4": 22, "genus_5": 9}
NESTED_COUNTS = {c: n for c, n in COUNTS.items() if c != "genus_5"}
MODES = ("raw", "folds", "cross", "cross_folds")
FOLD_N = {"raw": (4, 8, 22), "cross": (2, 8, 22), "folds": (4, 12, 16),
          "cross_folds": (2, 12, 16)}
KEPT_N = {"raw": {4, 8}, "cross": {2, 8}, "folds": {4, 12},
          "cross_folds": {2, 12}}
SKIPPED = {"raw": "skip n=22: smallest class has 22 samples",
           "folds": "skip n=16: smallest class has 12 samples"}
SKIPPED.update(cross=SKIPPED["raw"], cross_folds=SKIPPED["folds"])
CROSS_SETUPS = ("I - I", "I - P", "I - I+P", "P - I", "P - P", "P - I+P",
                "I+P - I", "I+P - P")
FOLD_K = {"raw": (1, 3, 9, 51), "folds": (1, 3, 9, 51),
          "cross": (1, 3, 9), "cross_folds": (1, 3, 9)}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pool(rs, counts):
    names = np.concatenate([[c] * n for c, n in counts.items()])
    rs.shuffle(names)
    n = len(names)
    image = rs.randn(n, DIM).astype(np.float32)
    profile = rs.randn(n, DIM).astype(np.float32)
    return {"image": image / np.linalg.norm(image, axis=1, keepdims=True),
            "profile": profile / np.linalg.norm(profile, axis=1,
                                                keepdims=True),
            "label": names}


@pytest.fixture(scope="module")
def embeddings():
    """{flat, nested}: one model with one flat fold, and one model with
    two train/test folds (the test split a quarter of each class). The
    stored classes lack genus_4 and add genus_9: the vocabulary is their
    union with every label."""
    rs = np.random.RandomState(0)
    classes = np.array(["genus_0", "genus_1", "genus_2", "genus_3",
                        "genus_5", "genus_9"])
    flat = {"vit_clip": {1: dict(_pool(rs, COUNTS), classes=classes)}}
    nested = {"b0_siglip": {}}
    for fold in (1, 2):
        pool = _pool(rs, NESTED_COUNTS)
        test = np.zeros(len(pool["label"]), bool)
        for c in NESTED_COUNTS:
            idx = np.flatnonzero(pool["label"] == c)
            test[idx[:len(idx) // 4]] = True
        nested["b0_siglip"][fold] = {
            split: {k: v[mask] for k, v in pool.items()}
            for split, mask in (("train", ~test), ("test", test))}
        nested["b0_siglip"][fold]["classes"] = classes
    return {"flat": flat, "nested": nested}


def _data(embeddings, mode):
    return embeddings["flat" if mode in ("raw", "cross") else "nested"]


def assert_results_equal(got, want, path="results"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            assert_results_equal(got[key], want[key], f"{path}[{key!r}]")
    else:
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("mode", MODES)
def test_run_suite_equals_jax(mode, embeddings, capsys):
    data = _data(embeddings, mode)
    kwargs = dict(mode=mode, N=FOLD_N[mode], K=FOLD_K[mode], repeats=2,
                  seed=3, progress=True)
    want = jax_bench.run_suite(data, **kwargs)
    printed = capsys.readouterr().out
    got = bench.run_suite(data, device="cpu", **kwargs)
    assert capsys.readouterr().out == printed
    assert_results_equal(got, want)
    # the skip rules: raw and cross skip n at the smallest kept class,
    # the folds modes only above the smallest train class
    for model in got.values():
        for fold in model.values():
            assert set(fold) == KEPT_N[mode]
    assert SKIPPED[mode] in printed.splitlines()
    first = next(iter(next(iter(got.values())).values()))
    rec = first[min(first)][0]
    for k in FOLD_K[mode]:
        pred = rec["pred"][k]
        if mode.startswith("cross"):
            assert sorted(pred) == sorted(CROSS_SETUPS)
            pred = pred["I+P - P"]
        assert pred.shape == rec["true"].shape
        # the classes under the threshold are never raw or cross queries
        if mode in ("raw", "cross"):
            assert not {"genus_3", "genus_5"} & set(rec["true"])


def test_helpers_equal_jax(embeddings):
    pool = embeddings["flat"]["vit_clip"][1]
    vocab = LabelVocab(pool["label"])
    labels = vocab.transform(pool["label"])
    for seed in (0, 1):
        got = bench.sample_per_class(labels, 5,
                                     np.random.default_rng(seed))
        want = jax_bench.sample_per_class(labels, 5,
                                          np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    assert bench.max_samplable_n(labels) == jax_bench.max_samplable_n(labels)
    data = (pool["image"], pool["profile"], pool["label"])
    for th in (10, 20, 30):
        for g, w in zip(bench.threshold(data, vocab, th),
                        jax_bench.threshold(data, vocab, th)):
            np.testing.assert_array_equal(g, w)


def test_threshold_drops_every_class_raises(embeddings):
    pool = embeddings["flat"]["vit_clip"][1]
    data = (pool["image"], pool["profile"], pool["label"])
    vocab = LabelVocab(pool["label"])
    for mod in (bench, jax_bench):
        with pytest.raises(ValueError, match="drops every class"):
            mod.threshold(data, vocab, 100)


def test_sharded_raises_naming_module_7(embeddings):
    """Queue 1 module 7 is ported: ``sharded=True`` no longer raises, and
    on one process (a one-rank gallery) gives the default's results;
    ``set_sharded_retrieval`` toggles it."""
    kwargs = dict(mode="raw", N=(4,), K=(1,), repeats=1, device="cpu")
    want = bench.run_suite(embeddings["flat"], **kwargs)
    try:
        assert_results_equal(bench.run_suite(embeddings["flat"],
                                             sharded=True, **kwargs), want)
        bench.set_sharded_retrieval(True)
        assert bench._SHARDED
    finally:
        bench.set_sharded_retrieval(False)
    assert not bench._SHARDED


def test_default_device_is_the_card(embeddings, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.run_suite(embeddings["flat"], "raw", (4,), (1,), 1)


@pytest.fixture(scope="module")
def cli_results(embeddings, tmp_path_factory):
    """Each mode's JAX CLI and port CLI (``--device cpu``) on the same
    pickle at 1 repeat, seed 1."""
    tmp = tmp_path_factory.mktemp("bench_cli")
    out = {}
    for mode in MODES:
        emb = tmp / f"{mode}_emb.pkl"
        with open(emb, "wb") as f:
            pickle.dump(_data(embeddings, mode), f)
        common = ["-e", str(emb), "--repeats", "1", "--seed", "1"]
        jax_out, port_out = tmp / f"{mode}_jax.pkl", tmp / f"{mode}_port.pkl"
        argv = sys.argv
        try:
            sys.argv = [f"benchmark_{mode}.py", *common, "-o", str(jax_out)]
            _script(f"benchmark_{mode}").main()
        finally:
            sys.argv = argv
        returned = _script(f"benchmark_{mode}_torch").main(
            [*common, "-o", str(port_out), "--device", "cpu"])
        with open(jax_out, "rb") as f:
            want = pickle.load(f)
        with open(port_out, "rb") as f:
            got = pickle.load(f)
        assert_results_equal(returned, got)
        out[mode] = {"jax": want, "port": got, "jax_path": jax_out,
                     "port_path": port_out}
    return out


@pytest.mark.parametrize("mode", MODES)
def test_cli_writes_the_jax_pickle(mode, cli_results):
    assert_results_equal(cli_results[mode]["port"],
                         cli_results[mode]["jax"])
    script = _script(f"benchmark_{mode}_torch")
    jax_script = _script(f"benchmark_{mode}")
    assert (script.N, script.K, script.REPEATS) \
        == (jax_script.N, jax_script.K, jax_script.REPEATS)
    assert getattr(script, "TH", None) == getattr(jax_script, "TH", None)


@pytest.mark.parametrize("mode", ["raw", "cross"])
def test_each_package_reads_the_others_pickle(mode, cli_results):
    setup = "I+P - I" if mode == "cross" else None
    for path in (cli_results[mode]["port_path"],
                 cli_results[mode]["jax_path"]):
        with open(path, "rb") as f:
            results = pickle.load(f)
        assert jax_R.accuracy_table(results, 1, setup) \
            == R.accuracy_table(results, 1, setup)


@pytest.mark.parametrize("command", [
    ["table", "-k", "3"],
    ["table", "-k", "1", "--setup", "I - P"],
    ["cross", "-n", "8", "-k", "3"],
    ["report", "-n", "4", "-k", "1"],
    ["report", "-n", "8", "-k", "9", "--setup", "P - P", "--latex"],
], ids=["table", "table-setup", "cross", "report", "report-latex"])
def test_results_cli_prints_as_jax(command, cli_results, capsys):
    mode = "cross" if "--setup" in command or command[0] == "cross" \
        else "raw"
    path = str(cli_results[mode]["port_path"])
    argv = sys.argv
    try:
        sys.argv = ["results.py", *command, "-r", path]
        _script("results").main()
    finally:
        sys.argv = argv
    want = capsys.readouterr().out
    _script("results_torch").main([*command, "-r", path])
    assert capsys.readouterr().out == want and want


def test_results_cli_figures(cli_results, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    path = str(cli_results["cross"]["port_path"])
    cli = _script("results_torch")
    cli.main(["curves", "-r", path, "-k", "3", "--setup", "I - I",
              "-o", str(tmp_path / "curves.png")])
    cli.main(["cm", "-r", path, "-n", "8", "-k", "1", "--setup", "I+P - P",
              "-o", str(tmp_path / "cm.png")])
    assert (tmp_path / "curves.png").stat().st_size > 0
    assert (tmp_path / "cm.png").stat().st_size > 0
    assert capsys.readouterr().out.count("wrote") == 2
