"""Evaluation metrics (``train/metrics.py`` of the JAX package, which is
numpy: copied as it is): accuracy, the confusion matrix, per-class
precision / recall / F1 with their macro and weighted means, and the
rendered confusion matrix of the classifier drivers' ``test_cm`` image.
``render_confusion_matrix`` imports matplotlib and PIL when called."""

from __future__ import annotations

import io
from typing import Dict, Sequence

import numpy as np


def accuracy(pred: np.ndarray, true: np.ndarray) -> float:
    return float((np.asarray(pred) == np.asarray(true)).mean())


def confusion_matrix(pred: np.ndarray, true: np.ndarray,
                     n_classes: int) -> np.ndarray:
    """(true, pred) counts, int64 (n_classes, n_classes)."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(true, np.int64), np.asarray(pred, np.int64)), 1)
    return cm


def precision_recall_f1(pred: np.ndarray, true: np.ndarray,
                        n_classes: int) -> Dict[str, np.ndarray]:
    """Per-class precision/recall/F1 plus macro and weighted aggregates
    (sklearn ``classification_report`` equivalents, zero_division=0)."""
    cm = confusion_matrix(pred, true, n_classes)
    tp = np.diag(cm).astype(float)
    pred_pos = cm.sum(axis=0).astype(float)
    actual_pos = cm.sum(axis=1).astype(float)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(actual_pos > 0, tp / actual_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    support = actual_pos
    weights = support / max(support.sum(), 1)
    return {
        "precision": precision, "recall": recall, "f1": f1,
        "support": support.astype(int),
        "macro_precision": float(precision.mean()),
        "macro_recall": float(recall.mean()),
        "macro_f1": float(f1.mean()),
        "weighted_precision": float((precision * weights).sum()),
        "weighted_recall": float((recall * weights).sum()),
        "weighted_f1": float((f1 * weights).sum()),
        "accuracy": float(tp.sum() / max(cm.sum(), 1)),
    }


def render_confusion_matrix(cm: np.ndarray,
                            class_names: Sequence[str]) -> np.ndarray:
    """The matrix drawn as a (C, H, W) uint8 image for TensorBoard."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(cm, cmap="Blues")
    n = len(class_names)
    ax.set_xticks(range(n), class_names, rotation=90)
    ax.set_yticks(range(n), class_names, rotation=0)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    thresh = cm.max() / 2 if cm.max() > 0 else 0.5
    if n <= 40:
        for i in range(n):
            for j in range(n):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        fontsize=6,
                        color="white" if cm[i, j] > thresh else "black")
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    img = np.asarray(Image.open(buf).convert("RGB"))
    return np.transpose(img, (2, 0, 1))
