"""Result-pickle analysis (``retrieval/results.py`` of the JAX package,
which is numpy: copied as it is): accuracy tables, the cross-modal
table, classification reports (text and LaTeX) and figures, for
``scripts/results_torch.py``. The figures import matplotlib (and PIL)
when called."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..train.metrics import confusion_matrix, precision_recall_f1
from ..utils import LabelVocab


def _iter_runs(results: Dict, model: str, fold=None):
    folds = results[model].keys() if fold is None else [fold]
    for f in folds:
        for n, subresults in results[model][f].items():
            for run, rec in subresults.items():
                yield f, n, run, rec


def accuracy_table(results: Dict, k: int,
                   setup: Optional[str] = None) -> Dict:
    """Mean +/- std accuracy and macro-P/R/F1 per (model, n) over
    folds x repeats (reference: experiments.ipynb cell 12 layout)."""
    table: Dict = {}
    for model in results:
        per_n: Dict[int, Dict[str, list]] = {}
        for fold, n, run, rec in _iter_runs(results, model):
            pred = rec["pred"][k]
            if isinstance(pred, dict):
                if setup is None:
                    raise ValueError(
                        "cross-modal results pickle: pass a setup key "
                        f"(one of {sorted(pred)})")
                pred = pred[setup]
            true = rec["true"]
            vocab = LabelVocab(np.concatenate([np.unique(true),
                                               np.unique(pred)]))
            p = vocab.transform(list(pred))
            t = vocab.transform(list(true))
            m = precision_recall_f1(p, t, len(vocab))
            d = per_n.setdefault(n, {"acc": [], "precision": [],
                                     "recall": [], "f1": []})
            d["acc"].append(m["accuracy"])
            d["precision"].append(m["macro_precision"])
            d["recall"].append(m["macro_recall"])
            d["f1"].append(m["macro_f1"])
        table[model] = {
            n: {key: (float(np.mean(vals)), float(np.std(vals)))
                for key, vals in metrics.items()}
            for n, metrics in per_n.items()
        }
    return table


def cross_modal_table(results: Dict, n: int, k: int) -> Dict:
    """Accuracy per (model, setup) at fixed n, k — the 8-setup matrix
    (reference: experiments.ipynb cell 22)."""
    table: Dict = {}
    for model in results:
        per_setup: Dict[str, list] = {}
        for fold, nn, run, rec in _iter_runs(results, model):
            if nn != n:
                continue
            for setup, pred in rec["pred"][k].items():
                acc = float(np.mean(np.asarray(pred) == np.asarray(rec["true"])))
                per_setup.setdefault(setup, []).append(acc)
        table[model] = {s: (float(np.mean(v)), float(np.std(v)))
                        for s, v in per_setup.items()}
    return table


def classification_report(results: Dict, model: str, n: int, k: int,
                          setup: Optional[str] = None,
                          latex: bool = False) -> str:
    """Pooled per-class P/R/F1 report over all folds/repeats at (n, k)
    (reference: experiments.ipynb cells 18/24 LaTeX reports)."""
    preds, trues = [], []
    for fold, nn, run, rec in _iter_runs(results, model):
        if nn != n:
            continue
        pred = rec["pred"][k]
        if setup is not None:
            pred = pred[setup]
        preds.append(np.asarray(pred))
        trues.append(np.asarray(rec["true"]))
    pred = np.concatenate(preds)
    true = np.concatenate(trues)
    vocab = LabelVocab(np.concatenate([np.unique(true), np.unique(pred)]))
    m = precision_recall_f1(vocab.transform(list(pred)),
                            vocab.transform(list(true)), len(vocab))

    lines = []
    if latex:
        lines.append(r"\begin{tabular}{lrrrr}")
        lines.append(r"class & precision & recall & f1 & support \\ \hline")
        for i, name in enumerate(vocab.to_list()):
            lines.append(f"{name} & {m['precision'][i]:.4f} & "
                         f"{m['recall'][i]:.4f} & {m['f1'][i]:.4f} & "
                         f"{m['support'][i]} \\\\")
        lines.append(r"\hline")
        lines.append(f"macro & {m['macro_precision']:.4f} & "
                     f"{m['macro_recall']:.4f} & {m['macro_f1']:.4f} & "
                     f"{int(m['support'].sum())} \\\\")
        lines.append(f"weighted & {m['weighted_precision']:.4f} & "
                     f"{m['weighted_recall']:.4f} & {m['weighted_f1']:.4f} & "
                     f"{int(m['support'].sum())} \\\\")
        lines.append(r"\end{tabular}")
    else:
        w = max(len(n) for n in vocab.to_list()) + 2
        lines.append(f"{'':{w}} precision  recall  f1      support")
        for i, name in enumerate(vocab.to_list()):
            lines.append(f"{name:{w}} {m['precision'][i]:.4f}     "
                         f"{m['recall'][i]:.4f}  {m['f1'][i]:.4f}  "
                         f"{m['support'][i]}")
        lines.append(f"{'accuracy':{w}} {m['accuracy']:.4f}")
        lines.append(f"{'macro f1':{w}} {m['macro_f1']:.4f}")
        lines.append(f"{'weighted f1':{w}} {m['weighted_f1']:.4f}")
    return "\n".join(lines)


def accuracy_vs_n_figure(results: Dict, k: int, out_path: Path,
                         setup: Optional[str] = None) -> None:
    """Accuracy as a function of gallery size n, one curve per model
    (reference: experiments.ipynb cell 14)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = accuracy_table(results, k, setup)
    fig, ax = plt.subplots(figsize=(7, 5))
    for model, per_n in table.items():
        ns = sorted(per_n)
        means = [per_n[n]["acc"][0] for n in ns]
        stds = [per_n[n]["acc"][1] for n in ns]
        ax.errorbar(ns, means, yerr=stds, marker="o", capsize=3, label=model)
    ax.set_xscale("log", base=2)
    ax.set_xlabel("gallery size n per class")
    ax.set_ylabel(f"accuracy (k={k})")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight", dpi=150)
    plt.close(fig)


def confusion_figure(results: Dict, model: str, n: int, k: int,
                     out_path: Path, setup: Optional[str] = None) -> None:
    """Pooled confusion matrix figure (reference: experiments.ipynb cell 16)."""
    from ..train.metrics import render_confusion_matrix
    from PIL import Image

    preds, trues = [], []
    for fold, nn, run, rec in _iter_runs(results, model):
        if nn != n:
            continue
        pred = rec["pred"][k]
        if setup is not None:
            pred = pred[setup]
        preds.append(np.asarray(pred))
        trues.append(np.asarray(rec["true"]))
    pred = np.concatenate(preds)
    true = np.concatenate(trues)
    vocab = LabelVocab(np.concatenate([np.unique(true), np.unique(pred)]))
    cm = confusion_matrix(vocab.transform(list(pred)),
                          vocab.transform(list(true)), len(vocab))
    img = render_confusion_matrix(cm, vocab.to_list())
    Image.fromarray(np.transpose(img, (1, 2, 0))).save(out_path)
