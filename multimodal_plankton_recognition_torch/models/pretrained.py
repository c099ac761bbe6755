"""Pretrained weights from npz files (the port's own copy of
``models/pretrained.py`` of the JAX package).

An npz holds arrays keyed by ``/``-joined Flax paths (``flatten_params``),
optionally under a collection prefix: ``params/<path>`` merges into the
parameters, ``batch_stats/<path>`` into the BatchNorm running statistics,
and a bare key counts as a parameter. ``scripts/convert_timm_torch.py``
(``models/convert_timm.py``) writes such files from timm weights,
``save_params_npz`` from a tree.

``load_pretrained_npz`` merges one into a Flax-layout tree exactly as the
JAX function does: a key with a known path and shape is loaded (cast to
the tree's dtype); an unknown one, one of another shape, and a
``batch_stats/`` key when no statistics are given are skipped, or raise
``KeyError`` under ``strict``. ``missing`` counts the tree's leaves left
as they were. ``load_pretrained_into`` does it for a port model: its
state dict goes to the Flax layout (``convert.to_flax``), takes the merge,
and comes back through ``convert.from_flax``, so the counts are JAX's for
the same npz and the same model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import from_flax, to_flax

def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = v
    return out


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_params_npz(params: Dict[str, Any], path: str | Path) -> None:
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    np.savez(path, **flat)


def load_pretrained_npz(params: Dict[str, Any], path: str | Path,
                        strict: bool = False, batch_stats=None):
    """Merge the npz at ``path`` into the tree ``params`` (and
    ``batch_stats``, when given) by path. Returns ``(params, stats)``, or
    ``(params, batch_stats, stats)`` when ``batch_stats`` is given;
    ``stats``: ``loaded``, ``skipped``, ``missing``."""
    flat = flatten_params(params)
    flat_bs = flatten_params(batch_stats or {})
    npz = np.load(path)
    loaded = skipped = 0
    for key in npz.files:
        target, k = flat, key
        if key.startswith("params/"):
            k = key[len("params/"):]
        elif key.startswith("batch_stats/"):
            target, k = flat_bs, key[len("batch_stats/"):]
            if batch_stats is None:  # the caller tracks no statistics
                skipped += 1
                continue
        if k in target and target[k].shape == npz[key].shape:
            target[k] = npz[key].astype(np.asarray(target[k]).dtype)
            loaded += 1
        else:
            if strict:
                raise KeyError(
                    f"npz key {key!r} "
                    + ("missing from model"
                       if k not in target else
                       f"shape {npz[key].shape} != {target[k].shape}"))
            skipped += 1
    missing = len(flat) + len(flat_bs) - loaded
    stats = {"loaded": loaded, "skipped": skipped, "missing": missing}
    if batch_stats is not None:
        return unflatten_params(flat), unflatten_params(flat_bs), stats
    return unflatten_params(flat), stats


def load_pretrained_into(model: nn.Module, path: str | Path,
                         strict: bool = False
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """(state dict, stats): ``model``'s state dict (f32) with the npz at
    ``path`` merged in, as the JAX train driver merges it into its
    ``TrainState`` (the statistics given, empty for a model without
    BatchNorm, so its ``batch_stats/`` keys are skipped). ``model`` is
    left as it is."""
    variables = to_flax(model)
    params, batch_stats, stats = load_pretrained_npz(
        variables["params"], path, strict,
        batch_stats=variables.get("batch_stats", {}))
    merged = {"params": params}
    if "batch_stats" in variables:
        merged["batch_stats"] = batch_stats
    return from_flax(merged), stats
