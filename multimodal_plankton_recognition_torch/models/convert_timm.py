"""timm / torch state dict -> npz of Flax paths (``models/convert_timm.py``
of the JAX package, with the port's own copy of what it needs).

The reference trains from ImageNet-initialised backbones: it hard-codes
``pretrained=True`` into ``timm.create_model`` (reference:
src/image_encoder.py:16-17). This module maps a timm state dict (read
from a ``.safetensors`` or ``torch.save`` file) onto the ``/``-joined
Flax parameter paths of the backbones, and writes the npz that
``models.pretrained.load_pretrained_into`` merges into a port model at
train time (``pretrained: true`` with a ``pretrained_path``).

Each architecture has a *spec*: a list of ``(kind, torch_key, flax_path)``
rules, so the mapping is testable without timm: ``synthesize_state_dict``
makes a state dict of the inverse shapes, derived from the port's own
backbone through ``convert.to_flax``.

Layout transforms (torch -> Flax):
  conv    (Co, Ci, H, W)  -> kernel (H, W, Ci, Co)
  dwconv  (C, 1, H, W)    -> kernel (H, W, 1, C)
  dense   (O, I)          -> kernel (I, O)
  bn      weight / bias -> scale / bias (params); running_mean / var ->
          mean / var (``batch_stats/`` in the npz)
  ln      weight / bias -> scale / bias
  qkv     fused (3D, D) -> separate query / key / value kernels (D, h, hd)
  attn_out (D, D) -> (h, hd, D)
  the stem convolutions adapt their input channels as timm's
  ``adapt_input_conv`` does: RGB kernels summed over Ci for one channel.

``read_torch_file`` reads ``.safetensors`` itself (an 8-byte
little-endian header length, a JSON header of dtype, shape and offsets,
then the raw little-endian buffers), so no ``safetensors`` package is
needed; a bf16 tensor of either format comes back as f32, exactly.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .image.efficientnet import B0_STAGES
from .pretrained import flatten_params

Spec = Tuple  # (kind, torch_key, flax_path[, heads])


# ---------------------------------------------------------------- specs

def _spec_efficientnet(depth_mult: float) -> List[Spec]:
    specs: List[Spec] = [
        ("conv_in", "conv_stem.weight", "stem_conv/kernel"),
        ("bn", "bn1", "stem_bn"),
    ]
    for si, (expand, _ch, repeats, _stride, _k) in enumerate(B0_STAGES):
        for b in range(int(math.ceil(depth_mult * repeats))):
            t = f"blocks.{si}.{b}."
            f = f"stage{si + 1}_block{b}/"
            if expand == 1:  # timm DepthwiseSeparableConv (stage 0)
                specs += [
                    ("dwconv", t + "conv_dw.weight", f + "dw_conv/kernel"),
                    ("bn", t + "bn1", f + "dw_bn"),
                    ("convb", t + "se.conv_reduce", f + "se/reduce"),
                    ("convb", t + "se.conv_expand", f + "se/expand"),
                    ("conv", t + "conv_pw.weight", f + "project_conv/kernel"),
                    ("bn", t + "bn2", f + "project_bn"),
                ]
            else:  # timm InvertedResidual
                specs += [
                    ("conv", t + "conv_pw.weight", f + "expand_conv/kernel"),
                    ("bn", t + "bn1", f + "expand_bn"),
                    ("dwconv", t + "conv_dw.weight", f + "dw_conv/kernel"),
                    ("bn", t + "bn2", f + "dw_bn"),
                    ("convb", t + "se.conv_reduce", f + "se/reduce"),
                    ("convb", t + "se.conv_expand", f + "se/expand"),
                    ("conv", t + "conv_pwl.weight", f + "project_conv/kernel"),
                    ("bn", t + "bn3", f + "project_bn"),
                ]
    specs += [
        ("conv", "conv_head.weight", "head_conv/kernel"),
        ("bn", "bn2", "head_bn"),
    ]
    return specs


def _spec_vit(depth: int, num_heads: int) -> List[Spec]:
    specs: List[Spec] = [
        ("raw", "cls_token", "cls_token"),
        ("raw", "pos_embed", "pos_embed"),
        ("conv_in", "patch_embed.proj.weight", "patch_embed/kernel"),
        ("raw", "patch_embed.proj.bias", "patch_embed/bias"),
    ]
    for i in range(depth):
        t = f"blocks.{i}."
        f = f"block_{i}/"
        specs += [
            ("ln", t + "norm1", f + "ln1"),
            ("qkv", t + "attn.qkv", f + "attn", num_heads),
            ("attn_out", t + "attn.proj", f + "attn/out", num_heads),
            ("ln", t + "norm2", f + "ln2"),
            ("dense", t + "mlp.fc1", f + "mlp1"),
            ("dense", t + "mlp.fc2", f + "mlp2"),
        ]
    specs.append(("ln", "norm", "ln_final"))
    return specs


def _spec_resnet(stage_sizes: Sequence[int], bottleneck: bool) -> List[Spec]:
    specs: List[Spec] = [
        ("conv_in", "conv1.weight", "stem_conv/kernel"),
        ("bn", "bn1", "stem_bn"),
    ]
    expansion = 4 if bottleneck else 1
    in_ch = 64
    for stage, repeats in enumerate(stage_sizes):
        width = 64 * (2 ** stage)
        for b in range(repeats):
            t = f"layer{stage + 1}.{b}."
            f = f"stage{stage + 1}_block{b}/"
            for c in range(1, (3 if bottleneck else 2) + 1):
                specs += [
                    ("conv", t + f"conv{c}.weight", f + f"conv{c}/kernel"),
                    ("bn", t + f"bn{c}", f + f"bn{c}"),
                ]
            stride = 2 if (stage > 0 and b == 0) else 1
            if b == 0 and (stride != 1 or in_ch != width * expansion):
                specs += [
                    ("conv", t + "downsample.0.weight", f + "proj_conv/kernel"),
                    ("bn", t + "downsample.1", f + "proj_bn"),
                ]
            in_ch = width * expansion
    return specs


def _spec_densenet(block_config: Sequence[int]) -> List[Spec]:
    specs: List[Spec] = [
        ("conv_in", "features.conv0.weight", "stem_conv/kernel"),
        ("bn", "features.norm0", "stem_bn"),
    ]
    for bi, n_layers in enumerate(block_config):
        for li in range(n_layers):
            t = f"features.denseblock{bi + 1}.denselayer{li + 1}."
            f = f"block{bi + 1}_layer{li}/"
            specs += [
                ("bn", t + "norm1", f + "bn1"),
                ("conv", t + "conv1.weight", f + "conv1/kernel"),
                ("bn", t + "norm2", f + "bn2"),
                ("conv", t + "conv2.weight", f + "conv2/kernel"),
            ]
        if bi != len(block_config) - 1:
            specs += [
                ("bn", f"features.transition{bi + 1}.norm",
                 f"trans{bi + 1}_bn"),
                ("conv", f"features.transition{bi + 1}.conv.weight",
                 f"trans{bi + 1}_conv/kernel"),
            ]
    specs.append(("bn", "features.norm5", "final_bn"))
    return specs


ARCH_SPECS = {
    "efficientnet_b0": lambda: _spec_efficientnet(1.0),
    "efficientnet_b1": lambda: _spec_efficientnet(1.1),
    "vit_tiny_patch16_224": lambda: _spec_vit(12, 3),
    "vit_small_patch16_224": lambda: _spec_vit(12, 6),
    "vit_small_patch32_224": lambda: _spec_vit(12, 6),
    "resnet18": lambda: _spec_resnet((2, 2, 2, 2), False),
    "resnet50": lambda: _spec_resnet((3, 4, 6, 3), True),
    "densenet121": lambda: _spec_densenet((6, 12, 24, 16)),
    "densenet169": lambda: _spec_densenet((6, 12, 32, 32)),
}


# ----------------------------------------------------------- transforms

def _adapt_in_chans(w: np.ndarray, in_chans: int) -> np.ndarray:
    """timm's ``adapt_input_conv``: torch (Co, Ci, H, W) -> ``in_chans``
    input channels."""
    src = w.shape[1]
    if src == in_chans:
        return w
    if in_chans == 1:
        return w.sum(axis=1, keepdims=True)
    if src == 1:
        return np.repeat(w, in_chans, axis=1) / in_chans
    raise ValueError(f"cannot adapt conv in_chans {src} -> {in_chans}")


def convert_state_dict(arch: str, sd: Dict[str, np.ndarray],
                       in_chans: int = 1
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray], List[str]]:
    """(params, batch_stats, missing) of the torch state dict ``sd``, each
    keyed by ``/``-joined Flax paths; ``missing`` lists the spec's torch
    keys absent from ``sd``. Keys no spec names (the classifier heads
    ``classifier.*``, ``fc.*``, ``head.*``) are ignored."""
    if arch not in ARCH_SPECS:
        raise ValueError(f"no converter spec for {arch!r}; "
                         f"known: {sorted(ARCH_SPECS)}")
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    missing: List[str] = []

    def take(key):
        if key not in sd:
            missing.append(key)
            return None
        return sd[key]

    def weight_bias(tkey, fpath, name, layout):
        w, b = take(tkey + ".weight"), take(tkey + ".bias")
        if w is not None:
            params[f"{fpath}/{name}"] = layout(w)
        if b is not None:
            params[fpath + "/bias"] = b

    for spec in ARCH_SPECS[arch]():
        kind, tkey, fpath = spec[:3]
        if kind in ("conv", "conv_in", "dwconv"):
            w = take(tkey)
            if w is None:
                continue
            if kind == "conv_in":
                w = _adapt_in_chans(w, in_chans)
            params[fpath] = w.transpose(2, 3, 1, 0)
        elif kind == "convb":  # a 1x1 convolution with a bias (SE)
            weight_bias(tkey, fpath, "kernel",
                        lambda w: w.transpose(2, 3, 1, 0))
        elif kind == "dense":
            weight_bias(tkey, fpath, "kernel", lambda w: w.T)
        elif kind == "ln":
            weight_bias(tkey, fpath, "scale", lambda w: w)
        elif kind == "bn":
            for suf, out in (("weight", "/scale"), ("bias", "/bias")):
                v = take(f"{tkey}.{suf}")
                if v is not None:
                    params[fpath + out] = v
            for suf, out in (("running_mean", "/mean"),
                             ("running_var", "/var")):
                v = take(f"{tkey}.{suf}")
                if v is not None:
                    stats[fpath + out] = v
        elif kind == "raw":
            v = take(tkey)
            if v is not None:
                params[fpath] = v
        elif kind == "qkv":
            heads = spec[3]
            w, b = take(tkey + ".weight"), take(tkey + ".bias")
            if w is not None:
                d = w.shape[1]
                hd = d // heads
                for i, name in enumerate(("query", "key", "value")):
                    wi = w[i * d:(i + 1) * d]          # (D_out, D_in)
                    params[f"{fpath}/{name}/kernel"] = \
                        wi.T.reshape(d, heads, hd)
                    if b is not None:
                        params[f"{fpath}/{name}/bias"] = \
                            b[i * d:(i + 1) * d].reshape(heads, hd)
        elif kind == "attn_out":
            heads = spec[3]
            w, b = take(tkey + ".weight"), take(tkey + ".bias")
            if w is not None:
                d_out, d_in = w.shape
                params[fpath + "/kernel"] = \
                    w.T.reshape(heads, d_in // heads, d_out)
            if b is not None:
                params[fpath + "/bias"] = b
        else:  # pragma: no cover
            raise ValueError(f"unknown spec kind {kind!r}")
    return params, stats, missing


# ------------------------------------------------------------- file I/O

#: safetensors dtype -> numpy dtype (little-endian); BF16 is read as
#: uint16 bits and widened to f32
_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
    "BOOL": "?",
}


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 values (their uint16 bits) as f32: the bits in the high half,
    which is exact."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """The tensors of a ``.safetensors`` file, in its header's order, as
    numpy arrays (bf16 as f32)."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which is not read here")
        begin, end = info["data_offsets"]
        arr = np.frombuffer(body[begin:end],
                            dtype=_SAFETENSORS_DTYPES[info["dtype"]])
        arr = arr.reshape(info["shape"])
        if info["dtype"] == "BF16":
            arr = _bf16_bits_to_f32(arr)
        out[name] = arr.astype(arr.dtype.newbyteorder("="))
    return out


def write_safetensors(tensors: Dict[str, np.ndarray],
                      path: str | Path) -> None:
    """Write numpy arrays (f32, f16, integers) as a ``.safetensors`` file:
    what ``read_safetensors`` and the ``safetensors`` package read."""
    names = {np.dtype(v).str.lstrip("<|="): k
             for k, v in _SAFETENSORS_DTYPES.items() if k != "BF16"}
    header, chunks, offset = {}, [], 0
    for name, value in tensors.items():
        arr = np.ascontiguousarray(value)
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": names[arr.dtype.str.lstrip("<|=")],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in chunks:
            f.write(raw)


def read_torch_file(path: str | Path) -> Dict[str, np.ndarray]:
    """A torch ``state_dict`` file as numpy arrays: ``.safetensors``, or a
    ``torch.save`` file (a state dict, or a dict holding one under
    ``state_dict``); bf16 tensors as f32."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[k] = np.asarray(v)
    return out


def convert_to_npz(arch: str, src_path: str | Path, out_path: str | Path,
                   in_chans: int = 1,
                   prefix: str = "image_encoder/backbone") -> Dict[str, int]:
    """Convert ``src_path`` (timm weights of ``arch``) into the npz that
    ``models.pretrained`` merges: keys ``params/<prefix>/<path>`` and
    ``batch_stats/<prefix>/<path>``. As in the JAX package, the default
    prefix names no path of a model tree, which calls the image encoder
    after its backbone (``<arch>/backbone``): pass that prefix to load."""
    sd = read_torch_file(src_path)
    params, stats, missing = convert_state_dict(arch, sd, in_chans=in_chans)
    if missing:
        raise KeyError(f"{len(missing)} expected torch keys absent from "
                       f"{src_path}: {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}")
    pre = (prefix + "/") if prefix else ""
    out = {f"params/{pre}{k}": v for k, v in params.items()}
    out.update({f"batch_stats/{pre}{k}": v for k, v in stats.items()})
    np.savez(out_path, **out)
    return {"params": len(params), "batch_stats": len(stats)}


# ---------------------------------------------------- tests and the smoke

def backbone_variables(arch: str, in_chans: int = 1
                       ) -> Tuple[Dict, Dict]:
    """(params, batch_stats) Flax trees of the port's ``arch`` backbone
    (``convert.to_flax`` of a freshly built one)."""
    from ..convert import to_flax
    from .image.registry import create_backbone

    variables = to_flax(create_backbone(arch, in_chans=in_chans))
    return variables["params"], variables.get("batch_stats", {})


def to_state_dict(arch: str, flax_params: Dict,
                  flax_stats: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """The timm-layout state dict whose ``convert_state_dict`` (at the
    trees' own input channels) is ``flax_params`` / ``flax_stats``: the
    inverse of each layout transform, keys in ``synthesize_state_dict``'s
    order, arrays contiguous."""
    fp = flatten_params(flax_params)
    fs = flatten_params(flax_stats or {})
    sd: Dict[str, np.ndarray] = {}

    def put(key, value):
        sd[key] = np.ascontiguousarray(value)

    for spec in ARCH_SPECS[arch]():
        kind, tkey, fpath = spec[:3]
        if kind in ("conv", "conv_in", "dwconv"):
            put(tkey, fp[fpath].transpose(3, 2, 0, 1))
        elif kind == "convb":
            put(tkey + ".weight", fp[fpath + "/kernel"].transpose(3, 2, 0, 1))
            put(tkey + ".bias", fp[fpath + "/bias"])
        elif kind == "dense":
            put(tkey + ".weight", fp[fpath + "/kernel"].T)
            put(tkey + ".bias", fp[fpath + "/bias"])
        elif kind == "bn":
            put(tkey + ".weight", fp[fpath + "/scale"])
            put(tkey + ".bias", fp[fpath + "/bias"])
            put(tkey + ".running_mean", fs[fpath + "/mean"])
            put(tkey + ".running_var", fs[fpath + "/var"])
        elif kind == "ln":
            put(tkey + ".weight", fp[fpath + "/scale"])
            put(tkey + ".bias", fp[fpath + "/bias"])
        elif kind == "raw":
            put(tkey, fp[fpath])
        elif kind == "qkv":
            parts = ("query", "key", "value")
            d = fp[f"{fpath}/query/kernel"].shape[0]
            put(tkey + ".weight", np.concatenate(
                [fp[f"{fpath}/{p}/kernel"].reshape(d, d).T for p in parts]))
            put(tkey + ".bias", np.concatenate(
                [fp[f"{fpath}/{p}/bias"].reshape(-1) for p in parts]))
        elif kind == "attn_out":
            h, hd, d = fp[fpath + "/kernel"].shape
            put(tkey + ".weight", fp[fpath + "/kernel"].reshape(h * hd, d).T)
            put(tkey + ".bias", fp[fpath + "/bias"])
    return sd


def synthesize_state_dict(arch: str, flax_params: Optional[Dict] = None,
                          flax_stats: Optional[Dict] = None,
                          src_in_chans: int = 3,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """A random timm-layout state dict of exactly the keys the ``arch``
    spec takes, f32 from ``default_rng(seed)`` in spec order, its shapes
    the inverse of the Flax trees given, or, by default, of the port's
    own backbone (``backbone_variables``). It lets the mapping be checked
    without timm."""
    if flax_params is None:
        flax_params, flax_stats = backbone_variables(arch)
    fp = flatten_params(flax_params)
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def rand(shape):
        return rng.standard_normal(shape).astype(np.float32)

    for spec in ARCH_SPECS[arch]():
        kind, tkey, fpath = spec[:3]
        if kind in ("conv", "conv_in", "dwconv"):
            h, w, ci, co = fp[fpath].shape
            if kind == "conv_in":
                ci = src_in_chans
            sd[tkey] = rand((co, ci, h, w))
        elif kind == "convb":
            h, w, ci, co = fp[fpath + "/kernel"].shape
            sd[tkey + ".weight"] = rand((co, ci, h, w))
            sd[tkey + ".bias"] = rand((co,))
        elif kind == "dense":
            i, o = fp[fpath + "/kernel"].shape
            sd[tkey + ".weight"] = rand((o, i))
            sd[tkey + ".bias"] = rand((o,))
        elif kind == "bn":
            n = fp[fpath + "/scale"].shape[0]
            sd[tkey + ".weight"] = rand((n,))
            sd[tkey + ".bias"] = rand((n,))
            sd[tkey + ".running_mean"] = rand((n,))
            sd[tkey + ".running_var"] = np.abs(rand((n,))) + 0.5
        elif kind == "ln":
            n = fp[fpath + "/scale"].shape[0]
            sd[tkey + ".weight"] = rand((n,))
            sd[tkey + ".bias"] = rand((n,))
        elif kind == "raw":
            sd[tkey] = rand(fp[fpath].shape)
        elif kind == "qkv":
            d = fp[fpath + "/query/kernel"].shape[0]
            sd[tkey + ".weight"] = rand((3 * d, d))
            sd[tkey + ".bias"] = rand((3 * d,))
        elif kind == "attn_out":
            h, hd, d = fp[fpath + "/kernel"].shape
            sd[tkey + ".weight"] = rand((d, h * hd))
            sd[tkey + ".bias"] = rand((d,))
    return sd
