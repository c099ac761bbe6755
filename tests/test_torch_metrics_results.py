"""The port's evaluation metrics (``train/metrics.py``) and result-pickle
analysis (``retrieval/results.py``) against the JAX package's, on the same
seeded inputs: the metrics and every table equal, the reports equal
string for string (text and LaTeX), and the figures the same pixels."""

import numpy as np
import pytest

from multimodal_plankton_recognition_tpu.retrieval import results as jax_R
from multimodal_plankton_recognition_tpu.train import metrics as jax_metrics
from multimodal_plankton_recognition_torch.retrieval import results as R
from multimodal_plankton_recognition_torch.train import metrics

CROSS_SETUPS = ("I - I", "I - P", "I - I+P", "P - I", "P - P", "P - I+P",
                "I+P - I", "I+P - P")


def _labels(seed, n=200, classes=7):
    rs = np.random.RandomState(seed)
    true = rs.randint(0, classes, n)
    pred = np.where(rs.rand(n) < 0.6, true, rs.randint(0, classes, n))
    return pred, true


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    pred, true = _labels(seed)
    # a class that is never predicted and one that never occurs: the
    # zero-division branches
    pred[pred == 3] = 4
    true[true == 5] = 6
    assert metrics.accuracy(pred, true) == jax_metrics.accuracy(pred, true)
    np.testing.assert_array_equal(metrics.confusion_matrix(pred, true, 8),
                                  jax_metrics.confusion_matrix(pred, true, 8))
    got = metrics.precision_recall_f1(pred, true, 8)
    want = jax_metrics.precision_recall_f1(pred, true, 8)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert type(got[key]) is type(want[key]), key


def _names(ids):
    return np.array([f"genus_{i}" for i in ids])


def _results(cross: bool, seed: int = 0):
    """A seeded results pickle in the benchmark schema: 2 models, 2 folds,
    n in (4, 16), 3 repeats, k in (1, 3)."""
    rs = np.random.RandomState(seed)
    out = {}
    for model in ("vit_clip", "b0_siglip"):
        out[model] = {}
        for fold in (1, 2):
            out[model][fold] = {}
            for n in (4, 16):
                runs = {}
                for run in range(3):
                    true = rs.randint(0, 6, 60)
                    rec = {"true": _names(true), "pred": {}}
                    for k in (1, 3):
                        def guess():
                            return _names(np.where(rs.rand(60) < 0.5, true,
                                                   rs.randint(0, 7, 60)))
                        rec["pred"][k] = ({s: guess() for s in CROSS_SETUPS}
                                          if cross else guess())
                    runs[run] = rec
                out[model][fold][n] = runs
    return out


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("setup", [None, "I+P - P"])
def test_accuracy_table_equals_jax(k, setup):
    results = _results(cross=setup is not None)
    assert R.accuracy_table(results, k, setup) \
        == jax_R.accuracy_table(results, k, setup)


def test_accuracy_table_asks_for_a_setup_on_cross_results():
    with pytest.raises(ValueError, match="pass a setup key"):
        R.accuracy_table(_results(cross=True), 1)


@pytest.mark.parametrize("n,k", [(4, 1), (16, 3)])
def test_cross_modal_table_equals_jax(n, k):
    results = _results(cross=True, seed=1)
    assert R.cross_modal_table(results, n, k) \
        == jax_R.cross_modal_table(results, n, k)


@pytest.mark.parametrize("latex", [False, True], ids=["text", "latex"])
@pytest.mark.parametrize("setup", [None, "P - I+P"])
def test_classification_report_equals_jax(latex, setup):
    results = _results(cross=setup is not None, seed=2)
    for model in results:
        got = R.classification_report(results, model, 16, 3, setup, latex)
        want = jax_R.classification_report(results, model, 16, 3, setup,
                                           latex)
        assert got == want


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_figures_render_as_jax(tmp_path):
    pytest.importorskip("matplotlib")
    raw, cross = _results(cross=False), _results(cross=True)
    for pkg, mod in (("port", R), ("jax", jax_R)):
        mod.accuracy_vs_n_figure(raw, 3, tmp_path / f"{pkg}_curves.png")
        mod.confusion_figure(cross, "vit_clip", 16, 1,
                             tmp_path / f"{pkg}_cm.png", setup="I - I")
    for name in ("curves", "cm"):
        got, want = (_png(tmp_path / f"{pkg}_{name}.png")
                     for pkg in ("port", "jax"))
        assert got.shape == want.shape and got.size > 0
        np.testing.assert_array_equal(got, want)


def test_render_confusion_matrix_equals_jax():
    pytest.importorskip("matplotlib")
    pred, true = _labels(3, classes=5)
    cm = metrics.confusion_matrix(pred, true, 5)
    names = [f"c{i}" for i in range(5)]
    got = metrics.render_confusion_matrix(cm, names)
    assert got.dtype == np.uint8 and got.shape[0] == 3
    np.testing.assert_array_equal(
        got, jax_metrics.render_confusion_matrix(cm, names))
