"""Weights made from the seed, on the device, in one draw.

The plain reference names every leaf and its init (``reference/
encoders.py`` ``init_spec``); one ``torch.randn`` on the device's
generator gives all of them, each leaf its slice scaled to its (mean,
std). Both sides get the same float32 tensors: the program through its
train state or module, the reference through ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.multi import MultiModel
from .inputs import device_generator

WEIGHT_STREAM = 1


def make_weights(card: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every parameter and
    buffer of the card's model, drawn from ``seed``."""
    with torch.device("meta"):
        ref = MultiModel(card)
    shapes = {**{n: p.shape for n, p in ref.named_parameters()},
              **{n: b.shape for n, b in ref.named_buffers()}}
    spec = ref.init_spec()
    total = sum(s.numel() for s in shapes.values())
    flat = torch.randn(total, generator=device_generator(
        device, seed, WEIGHT_STREAM), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        mean, std = spec[name]
        n = shape.numel()
        out[name] = (flat[at:at + n] * std + mean).reshape(shape)
        at += n
    return out
