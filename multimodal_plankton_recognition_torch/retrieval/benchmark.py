"""Gallery-retrieval benchmark (``retrieval/benchmark.py`` of the JAX
package): the shared core of the four benchmark CLIs
(``scripts/benchmark_{raw,folds,cross,cross_folds}_torch.py``), with the
JAX package's result-pickle schema:

  results[model][fold][n][run] = {
      'true': names array,
      'pred': {k: names array}                      # raw / folds
      'pred': {k: {setup: names array}}             # cross / cross_folds
  }

Setup keys of the cross variants: 'I - I', 'I - P', 'I - I+P', 'P - I',
'P - P', 'P - I+P', 'I+P - I', 'I+P - P' (gallery - query modality).

Retrieval is the port's exact kNN (``ops.knn.ANNClassifier``) on
``device``: the card unless the caller passes another; without a card
the default raises. The control flow is JAX's, so one seed draws the same
galleries: one ``numpy.random.Generator`` drawn in model, fold, n, repeat
order. ``sharded=True`` / ``set_sharded_retrieval(True)`` row-shard each
gallery over the data ranks of the process group (``parallel.knn``; one
rank without one): the predictions are the same, and every rank must
run the suite alike.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.knn import ANNClassifier, require_device
from ..utils import LabelVocab


def sample_per_class(y: np.ndarray, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """n random indices per class, classes in sorted order."""
    idx = []
    orig = np.arange(len(y))
    for label in np.unique(y):
        pool = orig[y == label]
        idx.extend(rng.choice(pool, size=n, replace=False))
    return np.array(idx, dtype=np.int64)


def max_samplable_n(y: np.ndarray) -> int:
    """Largest per-class gallery size the data supports."""
    _, counts = np.unique(y, return_counts=True)
    return int(counts.min()) if len(counts) else 0


def threshold(data: Tuple[np.ndarray, np.ndarray, np.ndarray], coder,
              th: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop classes with fewer than ``th`` samples."""
    images, profiles, names = data
    label = coder.transform(names)
    uniqs, counts = np.unique(label, return_counts=True)
    keep = np.isin(label, uniqs[counts >= th])
    if not keep.any():
        raise ValueError(
            f"threshold={th} drops every class (largest class has "
            f"{counts.max() if len(counts) else 0} samples); lower the "
            f"threshold or provide more data")
    return images[keep], profiles[keep], names[keep]


_ANN_KWARGS = dict(n_neighbors=32, metric="euclidean", diversify_prob=0.0,
                   pruning_degree_multiplier=3.0, low_memory=False,
                   random_state=0)

#: when True, galleries are row-sharded over the data ranks
#: (parallel/knn.py): the same predictions, a rank's share of the memory
_SHARDED = False


def set_sharded_retrieval(enabled: bool = True) -> None:
    """Toggle gallery sharding for every classifier built after it (the
    benchmark CLIs' ``--sharded``)."""
    global _SHARDED
    _SHARDED = enabled


def _make_classifier(X: np.ndarray, y: np.ndarray,
                     device: torch.device | str) -> ANNClassifier:
    return ANNClassifier(X, y, device, sharded=_SHARDED, **_ANN_KWARGS)


def _fused_run(image_train, profile_train, label_train, X_test, coder,
               label_test, K: Sequence[int], device) -> Dict:
    """One repeat of the fused-gallery protocol: gallery = stacked
    image+profile embeddings with tiled labels, queried with both test
    modalities."""
    X_train = np.concatenate((image_train, profile_train))
    y_train = np.tile(label_train, (2,))
    predictor = _make_classifier(X_train, y_train, device)
    preds = predictor.predict_many(*X_test, ks=tuple(K), epsilon=0.3)
    out = {k: coder.inverse_transform(p) for k, p in preds.items()}
    return {"pred": out, "true": coder.inverse_transform(label_test)}


def benchmark_raw(data, coder, n: int, repeats: int, K: Sequence[int],
                  rng: np.random.Generator,
                  device: torch.device | str = "cuda") -> Dict:
    """Gallery and queries sampled from the same pool."""
    images, profiles, names = data
    labels = coder.transform(names)
    idx_full = np.arange(len(labels))
    results = {}
    for run in range(repeats):
        idx_train = sample_per_class(labels, n, rng)
        idx_test = np.setdiff1d(idx_full, idx_train)
        results[run] = _fused_run(
            images[idx_train], profiles[idx_train], labels[idx_train],
            (images[idx_test], profiles[idx_test]), coder,
            labels[idx_test], K, device)
    return results


def benchmark_folds(train, test, coder, n: int, repeats: int,
                    K: Sequence[int], rng: np.random.Generator,
                    device: torch.device | str = "cuda") -> Dict:
    """Gallery sampled from the train split, queries = the full test
    split."""
    image_train, profile_train, name_train = train
    image_test, profile_test, name_test = test
    label_train = coder.transform(name_train)
    label_test = coder.transform(name_test)
    results = {}
    for run in range(repeats):
        idx = sample_per_class(label_train, n, rng)
        results[run] = _fused_run(
            image_train[idx], profile_train[idx], label_train[idx],
            (image_test, profile_test), coder, label_test, K, device)
    return results


def _cross_run(image_g, profile_g, label_g, image_q, profile_q, label_q,
               coder, K: Sequence[int], device) -> Dict:
    """One repeat of the 8-setup cross-modal matrix."""
    preds: Dict[int, Dict[str, np.ndarray]] = {k: {} for k in K}

    def _predict(predictor, keys, query_sets):
        for key, X in zip(keys, query_sets):
            many = predictor.predict_many(*X, ks=tuple(K), epsilon=0.3)
            for k, pred in many.items():
                preds[k][key] = coder.inverse_transform(pred)

    p_img = _make_classifier(image_g, label_g, device)
    _predict(p_img, ("I - I", "I - P", "I - I+P"),
             ((image_q,), (profile_q,), (image_q, profile_q)))

    p_prof = _make_classifier(profile_g, label_g, device)
    _predict(p_prof, ("P - I", "P - P", "P - I+P"),
             ((image_q,), (profile_q,), (image_q, profile_q)))

    p_both = _make_classifier(np.concatenate((image_g, profile_g)),
                              np.tile(label_g, (2,)), device)
    _predict(p_both, ("I+P - I", "I+P - P"), ((image_q,), (profile_q,)))

    return {"pred": preds, "true": coder.inverse_transform(label_q)}


def benchmark_cross(data, coder, n: int, repeats: int, K: Sequence[int],
                    rng: np.random.Generator,
                    device: torch.device | str = "cuda") -> Dict:
    images, profiles, names = data
    labels = coder.transform(names)
    idx_full = np.arange(len(labels))
    results = {}
    for run in range(repeats):
        idx_g = sample_per_class(labels, n, rng)
        idx_q = np.setdiff1d(idx_full, idx_g)
        results[run] = _cross_run(
            images[idx_g], profiles[idx_g], labels[idx_g],
            images[idx_q], profiles[idx_q], labels[idx_q], coder, K, device)
    return results


def benchmark_cross_folds(train, test, coder, n: int, repeats: int,
                          K: Sequence[int], rng: np.random.Generator,
                          device: torch.device | str = "cuda") -> Dict:
    image_train, profile_train, name_train = train
    image_test, profile_test, name_test = test
    label_train = coder.transform(name_train)
    label_test = coder.transform(name_test)
    results = {}
    for run in range(repeats):
        idx = sample_per_class(label_train, n, rng)
        results[run] = _cross_run(
            image_train[idx], profile_train[idx], label_train[idx],
            image_test, profile_test, label_test, coder, K, device)
    return results


def run_suite(embeddings: Dict, mode: str, N: Sequence[int],
              K: Sequence[int], repeats: int, th: int = 20,
              seed: int = 0, progress: bool = False,
              sharded: bool = False,
              device: torch.device | str = "cuda") -> Dict:
    """A full benchmark over an embeddings pickle in ``mode`` ('raw',
    'folds', 'cross' or 'cross_folds'), for every model and fold: raw and
    cross threshold each fold's pool at ``th`` and skip n at or above its
    smallest class; folds and cross_folds skip n above the train split's
    smallest class."""
    set_sharded_retrieval(sharded)
    device = require_device(device)
    key_ = next(iter(embeddings))
    first_fold = next(iter(embeddings[key_].values()))
    # vocabulary = stored checkpoint classes UNION every label present in the
    # embeddings, so classes the training split excluded (e.g. below split.py
    # minsize) are thresholded away instead of crashing coder.transform
    names = [np.asarray(first_fold["classes"])]
    for data in embeddings.values():
        for fold in data.values():
            if "label" in fold:
                names.append(np.unique(fold["label"]))
            else:
                for split in ("train", "test"):
                    names.append(np.unique(fold[split]["label"]))
    coder = LabelVocab(np.concatenate(names))
    rng = np.random.default_rng(seed)
    results: Dict = {name: {} for name in embeddings}
    for name, data in embeddings.items():
        for fold in data.keys():
            results[name][fold] = {}
            foo = data[fold]
            if mode in ("raw", "cross"):
                bar = threshold((foo["image"], foo["profile"], foo["label"]),
                                coder, th)
                fn = benchmark_raw if mode == "raw" else benchmark_cross
                n_cap = max_samplable_n(coder.transform(bar[2]))
                for n in N:
                    if n >= n_cap:  # need >=1 held-out query per class
                        print(f"skip n={n}: smallest class has {n_cap} samples")
                        continue
                    results[name][fold][n] = fn(bar, coder, n, repeats, K,
                                                rng, device)
            else:
                train = (foo["train"]["image"], foo["train"]["profile"],
                         foo["train"]["label"])
                test = (foo["test"]["image"], foo["test"]["profile"],
                        foo["test"]["label"])
                fn = benchmark_folds if mode == "folds" \
                    else benchmark_cross_folds
                n_cap = max_samplable_n(coder.transform(train[2]))
                for n in N:
                    if n > n_cap:
                        print(f"skip n={n}: smallest class has {n_cap} samples")
                        continue
                    results[name][fold][n] = fn(train, test, coder, n,
                                                repeats, K, rng, device)
            if progress:
                print(f"done: {name} fold {fold}")
    return results
