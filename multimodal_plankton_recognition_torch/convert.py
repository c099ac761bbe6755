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
  (out_features, in_features) in both trees, not a Dense kernel;
* an LSTM cell ``OptimizedLSTMCell_{i}`` (its input kernels ``ii``,
  ``if``, ``ig``, ``io``, (in, H), and its recurrent kernels and biases
  ``hi``, ``hf``, ``hg``, ``ho``, (H, H) and (H,)) -> the port's layer
  ``layers.{i}``: the gates stacked i|f|g|o into ``weight_ih`` (4H, in),
  ``weight_hh`` (4H, H) and the one ``bias`` (4H,) (the port keeps no
  second bias).

Module names carry over (``block_3`` -> ``blocks.3``, ``layer_1`` ->
``layers.1``), except that the JAX ``ImageEncoder`` is named after its
backbone in the Flax tree (``vit_tiny_patch16_224``) and ``image_encoder``
here. The same rules carry the contrastive model's tree and the
supervised classifiers' (the encoder and the ``fc`` Dense head). A leaf no rule maps raises; ``load_flax`` loads strictly, so a port
parameter or buffer left unset raises too.

``to_flax`` is the inverse: the Flax variable tree (numpy, f32) of a port
model's parameters and statistics, by the same rules backwards, so
``from_flax(to_flax(model))`` is the model's state dict. It is what npz
weights keyed by Flax paths merge into (``models/pretrained.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.attention import FusedSelfAttention
from .models.batchnorm import BatchNorm, GroupNorm
from .models.image.encoder import ImageEncoder
from .models.image.registry import IMAGE_BACKBONES
from .models.profile.lstm import LSTMLayer

_SAME_NAME = ("bias", "cls_token", "pos_embed", "logit_scale",
              "logit_bias")
_RENAMED = {"scale": "weight", "embedding": "weight"}
_ATTN_PARTS = ("query", "key", "value", "out")
_STATS = {"mean": "running_mean", "var": "running_var"}
_GATES = "ifgo"
_LSTM_PARTS = tuple("i" + g for g in _GATES) + tuple("h" + g for g in _GATES)
_LSTM_CELL = re.compile(r"^OptimizedLSTMCell_(\d+)$")


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


def _lstm(prefix: Tuple[str, ...], parts: Dict[str, Dict[str, np.ndarray]]):
    want = {**{"i" + g: ["kernel"] for g in _GATES},
            **{"h" + g: ["bias", "kernel"] for g in _GATES}}
    if {k: sorted(v) for k, v in parts.items()} != want:
        raise KeyError(f"LSTM cell {'/'.join(prefix)} must hold the kernels "
                       f"of ii, if, ig, io and the kernels and biases of hi, "
                       f"hf, hg, ho, got "
                       f"{ {k: sorted(v) for k, v in parts.items()} }")
    index = _LSTM_CELL.match(prefix[-1]).group(1)
    base = _join(_module_name(prefix[:-1]), "layers", index)
    return {
        _join(base, "weight_ih"): np.concatenate(
            [parts["i" + g]["kernel"] for g in _GATES], axis=1).T,
        _join(base, "weight_hh"): np.concatenate(
            [parts["h" + g]["kernel"] for g in _GATES], axis=1).T,
        _join(base, "bias"): np.concatenate(
            [parts["h" + g]["bias"] for g in _GATES])}


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
    cells: Dict[Tuple[str, ...], Dict[str, Dict[str, np.ndarray]]] = {}
    for path, arr in _flatten(variables["params"]):
        if len(path) >= 3 and path[-2] in _LSTM_PARTS \
                and _LSTM_CELL.match(path[-3]):
            cells.setdefault(path[:-2], {}).setdefault(path[-2], {})[
                path[-1]] = arr
            continue
        if len(path) >= 2 and path[-2] in _ATTN_PARTS:
            attn.setdefault(path[:-2], {}).setdefault(path[-2], {})[
                path[-1]] = arr
            continue
        name, value = _leaf(path, arr)
        out[_join(_module_name(path[:-1]), name)] = value
    for prefix, parts in attn.items():
        out.update(_attention(prefix, parts))
    for prefix, parts in cells.items():
        out.update(_lstm(prefix, parts))
    return {k: torch.tensor(v) for k, v in out.items()}


def load_flax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load converted Flax variables into ``module`` strictly (every port
    parameter set, every converted leaf used), casting to its dtype."""
    module.load_state_dict(from_flax(variables), strict=True)
    return module


def _flax_path(model: nn.Module, name: str) -> Tuple[str, ...]:
    """The Flax path of the port module ``name`` of ``model``: the image
    encoder named after its backbone, ``blocks.3`` -> ``block_3``,
    ``layers.1`` -> ``layer_1``, or ``OptimizedLSTMCell_1`` for an LSTM
    layer."""
    parts = name.split(".") if name else []
    out = []
    for i, part in enumerate(parts):
        sub = model.get_submodule(".".join(parts[:i + 1]))
        if isinstance(sub, ImageEncoder) and i == 0:
            out.append(sub.backbone_name)
        elif part.isdigit() and parts[i - 1] in ("blocks", "layers"):
            out[-1] = (f"OptimizedLSTMCell_{part}"
                       if isinstance(sub, LSTMLayer)
                       else f"{parts[i - 1][:-1]}_{part}")
        else:
            out.append(part)
    return tuple(out)


def _kernel(weight: np.ndarray) -> np.ndarray:
    """A Linear or conv ``weight`` back to its Flax ``kernel``."""
    if weight.ndim == 2:
        return weight.T
    if weight.ndim == 3:
        return weight.transpose(2, 1, 0)
    return weight.transpose(2, 3, 1, 0)


def _module_leaves(m: nn.Module, p: Dict[str, np.ndarray]):
    """(Flax sub-path, value) of the parameters ``p`` of one port
    module."""
    if isinstance(m, FusedSelfAttention):
        e = m.out.in_features
        h = m.num_heads
        w = p["qkv.weight"].T.reshape(e, 3, h, e // h)
        b = p["qkv.bias"].reshape(3, h, e // h)
        for j, part in enumerate(("query", "key", "value")):
            yield (part, "kernel"), w[:, j]
            yield (part, "bias"), b[j]
        yield ("out", "kernel"), p["out.weight"].T.reshape(h, e // h, e)
        yield ("out", "bias"), p["out.bias"]
    elif isinstance(m, LSTMLayer):
        for name, gates in (("weight_ih", "i"), ("weight_hh", "h")):
            for g, w in zip(_GATES, np.split(p[name], 4)):
                yield (gates + g, "kernel"), w.T
        for g, b in zip(_GATES, np.split(p["bias"], 4)):
            yield ("h" + g, "bias"), b
    elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        yield ("kernel",), _kernel(p["weight"])
        if "bias" in p:
            yield ("bias",), p["bias"]
    elif isinstance(m, nn.Embedding):
        yield ("embedding",), p["weight"]
    elif isinstance(m, (nn.LayerNorm, BatchNorm, GroupNorm)):
        yield ("scale",), p["weight"]
        yield ("bias",), p["bias"]
    else:
        for name, value in p.items():
            if "." not in name:
                yield (name,), value


def to_flax(model: nn.Module) -> Dict[str, Dict]:
    """The Flax variables (nested dicts of f32 numpy arrays: ``params``,
    and ``batch_stats`` where the model has BatchNorm) whose
    ``from_flax`` is ``model``'s state dict."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, value):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(value, np.float32)

    inside = set()  # the qkv / out Linears of an attention module
    for name, m in model.named_modules():
        if name in inside:
            continue
        p = {n: t.detach().float().cpu().numpy()
             for n, t in m.named_parameters(recurse=False)}
        if isinstance(m, FusedSelfAttention):
            inside.update(_join(name, c) for c in ("qkv", "out"))
            p = {n: t.detach().float().cpu().numpy()
                 for n, t in m.named_parameters()}
        if not p:
            continue
        base = _flax_path(model, name)
        for sub, value in _module_leaves(m, p):
            put(params, base + sub, value)
        if isinstance(m, BatchNorm):
            put(stats, base + ("mean",), m.running_mean.float().cpu())
            put(stats, base + ("var",), m.running_var.float().cpu())
    return {"params": params, **({"batch_stats": stats} if stats else {})}
