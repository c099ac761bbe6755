"""Seeded random initialisation with the distributions of the JAX
package's Flax initialisers (what its ``model.init`` draws), shared by
the train driver and the flagships.

* Dense and conv kernels (the classifiers' ``fc`` heads too):
  ``lecun_normal``, a normal truncated to ±2
  standard deviations and rescaled so that its standard deviation is
  1/sqrt(fan_in); fan_in is the kernel's input width times its receptive
  field (k·k for a depthwise kernel). The packed q|k|v projection of the
  kernel attention route is three (E, H, D) kernels in the Flax tree,
  whose fan_in Flax counts as E·H; flax's own attention
  (``fused_attention: false``) counts E. Biases are zero.
* The LSTM cells (``OptimizedLSTMCell``): each gate's input kernel
  ``lecun_normal``, each gate's (H, H) recurrent kernel orthogonal
  (``nn.initializers.orthogonal``), the biases zero; the port stacks the
  four gates of each (``models/profile/lstm.py``).
* Embedding tables (``nn.Embed``): a normal of std 1/sqrt(features).
* The ViT's position table: N(0, 0.02); its CLS token: zero.
* LayerNorm, BatchNorm and GroupNorm: unit scales, zero biases.
* The coordination head: ``logit_scale`` 1, ``logit_bias`` −10, the
  ArcFace class ``weight`` Xavier-uniform.

The draws come from a CPU ``torch.Generator``, parameter by parameter in
module order, so a seed gives the same weights on any device; they follow
Flax's distributions, not its bits.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .attention import FusedSelfAttention
from .batchnorm import BatchNorm, GroupNorm
from .image.vit import ViT
from .multi import CoordinationHead
from .profile.lstm import LSTMLayer

#: the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def _set_(t: torch.Tensor, value: torch.Tensor) -> None:
    t.copy_(value.to(t.dtype))


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    _set_(t, nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std,
                                   -2.0 * std, 2.0 * std,
                                   generator=generator))


def _normal_(t: torch.Tensor, std: float,
             generator: torch.Generator) -> None:
    _set_(t, torch.randn(t.shape, generator=generator) * std)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from ``generator`` (or set it to
    its constant) as the module docstring lists; running statistics stay
    as built (mean 0, variance 1). Raises ``KeyError`` for a parameter no
    rule covers. Returns ``model``."""
    fan_in = {id(m.qkv): m.qkv.in_features * m.num_heads
              for m in model.modules()
              if isinstance(m, FusedSelfAttention) and m.fused}
    done = set()
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            _lecun_normal_(m.weight, fan_in.get(id(m), m.weight[0].numel()),
                           generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LSTMLayer):
            for w_ih, w_hh in zip(m.weight_ih.chunk(4), m.weight_hh.chunk(4)):
                _lecun_normal_(w_ih, w_ih.shape[1], generator)
                _set_(w_hh, nn.init.orthogonal_(torch.empty(w_hh.shape),
                                                generator=generator))
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, 1.0 / math.sqrt(m.embedding_dim), generator)
        elif isinstance(m, (nn.LayerNorm, BatchNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ViT):
            _normal_(m.pos_embed, 0.02, generator)
            m.cls_token.zero_()
        elif isinstance(m, CoordinationHead):
            if hasattr(m, "logit_scale"):
                m.logit_scale.fill_(1.0)
            if hasattr(m, "logit_bias"):
                m.logit_bias.fill_(-10.0)
            if hasattr(m, "weight") and m.weight.numel():
                _set_(m.weight, nn.init.xavier_uniform_(
                    torch.empty(m.weight.shape), generator=generator))
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    missed = [n for n, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise KeyError(f"no initialiser for parameters {missed}")
    return model
