"""Transformer encoder over pulse-shape profiles
(``models/profile/transformer.py`` of the JAX package).

A bias-free expansion of the 6 pulse channels, a learned position table of
``target_size + 2`` rows whose last row is the padding row (used as the
converted weights give it: no ``padding_idx``), post-LN encoder layers
(torch ``nn.TransformerEncoderLayer`` order, LayerNorm eps 1e-6), the CLS
output at token 0, and the metadata scalar ``profile_len / tokens`` — the
divisor is the token count (``target_size + 1`` with the CLS row), cast to
the model dtype first, as in the JAX module.

Train-mode dropout at the JAX placements (``transformer.py:70, :92, :94,
:153``): the attention output, the feed-forward hidden and output, and the
final feature; plus the attention probabilities inside the attention
kernel; with ``fused_ffn`` the feed-forward hidden drops inside the fused
FFN kernels (``models/ffn.py``; the parameters stay ``ff1`` / ``ff2``).
Not ported: the remat-MLP probe.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import LN_EPS
from ..attention import FusedSelfAttention
from ..dense import Dense
from ..dropout import dropout
from ..ffn import apply_fused_ffn

_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "relu": F.relu,
}


class _EncoderLayer(nn.Module):
    """Post-LN block: x = LN(x + MHA(x)); x = LN(x + FF(x))."""

    def __init__(self, dim_hidden: int, num_head: int, dim_feedforward: int,
                 dropout: float, activation: str,
                 fused_attention: bool, fused_ffn: bool) -> None:
        super().__init__()
        self.dropout = dropout
        self.activation = activation
        self.fused_ffn = fused_ffn
        self.attn = FusedSelfAttention(dim_hidden, num_head,
                                       fused=fused_attention,
                                       dropout_rate=dropout)
        self.ln1 = nn.LayerNorm(dim_hidden, eps=LN_EPS)
        self.ff1 = Dense(dim_hidden, dim_feedforward)
        self.ff2 = Dense(dim_feedforward, dim_hidden)
        self.ln2 = nn.LayerNorm(dim_hidden, eps=LN_EPS)
        self.act = _ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.ln1(x + self._drop(self.attn(x, padding_mask)))
        if self.fused_ffn:
            h = apply_fused_ffn(x, self.ff1, self.ff2, self.activation,
                                self.dropout, self.training)
        else:
            h = self.ff2(self._drop(self.act(self.ff1(x))))
        return self.ln2(x + self._drop(h))

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.dropout, self.training)


class ProfileTransformer(nn.Module):
    kind = "transformer"  # the card's kind; picks the tokenizer

    def __init__(self, dim_in: int = 6, dim_hidden: int = 128,
                 target_size: int = 224, num_head: int = 4,
                 num_layers: int = 6, dim_feedforward: int = 2024,
                 dropout: float = 0.1, activation: str = "gelu",
                 metadata: bool = True,
                 fused_attention: bool = False,
                 fused_ffn: bool = False) -> None:
        """Card keys of the JAX module."""
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of "
                             f"{sorted(_ACTIVATIONS)}, got {activation!r}")
        self.dim_hidden = dim_hidden
        self.metadata = metadata
        self.dropout = dropout
        self.expand = Dense(dim_in, dim_hidden, bias=False)
        self.position = nn.Embedding(target_size + 2, dim_hidden)
        self.layers = nn.ModuleList(
            _EncoderLayer(dim_hidden, num_head, dim_feedforward, dropout,
                          activation, fused_attention, fused_ffn)
            for _ in range(num_layers))

    @property
    def dim_out(self) -> int:
        return self.dim_hidden + int(self.metadata)

    def forward(self, profile: torch.Tensor, time: torch.Tensor,
                padding_mask: torch.Tensor,
                profile_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.expand(profile.to(self.expand.weight.dtype))
        x = x + self.position(time)
        for layer in self.layers:
            x = layer(x, padding_mask)
        x = x[:, 0]  # CLS position
        if self.metadata:
            md = profile_len.to(x.dtype) / profile.shape[1]
            x = torch.cat([x, md.reshape(x.shape[0], -1)], dim=1)
        return dropout(x, self.dropout, self.training)
