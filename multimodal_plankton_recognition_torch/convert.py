"""Weight bridge: a Flax variable tree of the JAX package -> a state dict
of the port.

The tree comes as nested mappings of numpy arrays: ``{"params": ...}``,
plus ``{"batch_stats": ...}`` for a model with BatchNorm. Leaf rules:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise (k, k, 1, C) ->
  (C, 1, k, k)); Conv1d ``kernel`` (K, I, O) -> ``weight`` (O, I, K);
* BatchNorm ``batch_stats`` ``mean`` / ``var`` -> the buffers
  ``running_mean`` / ``running_var``;
* attention ``query``/``key``/``value`` (E, H, D) kernels and (H, D) biases
  -> one packed ``qkv`` Linear, q|k|v concatenated into (3E, E) and (3E,);
  ``out`` (H, D, E) -> (E, E);
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* ``bias``, ``cls_token``, ``pos_embed``, ``logit_scale``, ``logit_bias``
  keep their names;
* the ArcFace ``coordination/weight`` keeps its name and layout: it is
  (out_features, in_features) in both trees, not a Dense kernel.

Module names carry over (``block_3`` -> ``blocks.3``, ``layer_1`` ->
``layers.1``), except that the JAX ``ImageEncoder`` is named after its
backbone in the Flax tree (``vit_tiny_patch16_224``) and ``image_encoder``
here. The same rules carry the contrastive model's tree and the
supervised classifiers' (the encoder and the ``fc`` Dense head). A leaf no rule maps raises; ``load_flax`` loads strictly, so a port
parameter or buffer left unset raises too.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.image.registry import IMAGE_BACKBONES

_SAME_NAME = ("bias", "cls_token", "pos_embed", "logit_scale",
              "logit_bias")
_RENAMED = {"scale": "weight", "embedding": "weight"}
_ATTN_PARTS = ("query", "key", "value", "out")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value, np.float32)


def _join(*names: str) -> str:
    return ".".join(n for n in names if n)


def _module_name(path: Tuple[str, ...]) -> str:
    parts = list(path)
    if parts and parts[0] in IMAGE_BACKBONES:
        parts[0] = "image_encoder"
    return ".".join(re.sub(r"^(block|layer)_(\d+)$", r"\1s.\2", p)
                    for p in parts)


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    name = path[-1]
    if name == "kernel" and arr.ndim == 2:
        return "weight", arr.T
    if name == "kernel" and arr.ndim == 3:
        return "weight", arr.transpose(2, 1, 0)
    if name == "kernel" and arr.ndim == 4:
        return "weight", arr.transpose(3, 2, 0, 1)
    if name in _SAME_NAME or path[-2:] == ("coordination", "weight"):
        return name, arr
    if name in _RENAMED:
        return _RENAMED[name], arr
    raise KeyError(f"no conversion rule for Flax leaf {'/'.join(path)} "
                   f"{arr.shape}")


def _attention(prefix: Tuple[str, ...], parts: Dict[str, Dict[str, np.ndarray]]):
    if sorted(parts) != sorted(_ATTN_PARTS) or any(
            sorted(p) != ["bias", "kernel"] for p in parts.values()):
        raise KeyError(f"attention {'/'.join(prefix)} must hold query, key, "
                       f"value and out kernels and biases, got "
                       f"{ {k: sorted(v) for k, v in parts.items()} }")
    e_in = parts["query"]["kernel"].shape[0]
    w = np.concatenate([parts[p]["kernel"].reshape(e_in, -1)
                        for p in ("query", "key", "value")], axis=1)
    b = np.concatenate([parts[p]["bias"].reshape(-1)
                        for p in ("query", "key", "value")])
    wo = parts["out"]["kernel"]
    base = _module_name(prefix)
    return {_join(base, "qkv.weight"): w.T, _join(base, "qkv.bias"): b,
            _join(base, "out.weight"): wo.reshape(-1, wo.shape[-1]).T,
            _join(base, "out.bias"): parts["out"]["bias"]}


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (f32 tensors) for the port's counterpart of the Flax
    module whose variables these are: its parameters and, from
    ``batch_stats``, its BatchNorm buffers."""
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra or "params" not in variables:
        raise KeyError(f"expected only a 'params' collection and an optional "
                       f"'batch_stats' one, got {sorted(variables)}")
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables.get("batch_stats", {})):
        if path[-1] not in _STATS:
            raise KeyError(f"no conversion rule for Flax batch_stats leaf "
                           f"{'/'.join(path)} {arr.shape}")
        out[_join(_module_name(path[:-1]), _STATS[path[-1]])] = arr
    attn: Dict[Tuple[str, ...], Dict[str, Dict[str, np.ndarray]]] = {}
    for path, arr in _flatten(variables["params"]):
        if len(path) >= 2 and path[-2] in _ATTN_PARTS:
            attn.setdefault(path[:-2], {}).setdefault(path[-2], {})[
                path[-1]] = arr
            continue
        name, value = _leaf(path, arr)
        out[_join(_module_name(path[:-1]), name)] = value
    for prefix, parts in attn.items():
        out.update(_attention(prefix, parts))
    return {k: torch.tensor(v) for k, v in out.items()}


def load_flax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load converted Flax variables into ``module`` strictly (every port
    parameter set, every converted leaf used), casting to its dtype."""
    module.load_state_dict(from_flax(variables), strict=True)
    return module
