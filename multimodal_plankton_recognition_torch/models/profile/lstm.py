"""Stacked-LSTM profile encoder (``models/profile/lstm.py`` of the JAX
package): a bias-free expansion of the pulse channels to ``dim_hidden``,
``num_layers`` LSTM layers (Flax's ``OptimizedLSTMCell`` under ``nn.RNN``,
a zero initial carry), dropout between layers (not after the last), the
hidden state at each row's ``last_idx``, the metadata scalar and dropout.

Each layer is the recurrence of the Flax cell, in plain PyTorch: gates in
the order i, f, g, o from z = h·W_h + b + x·W_i, with sigmoid, sigmoid,
tanh and sigmoid; c' = f·c + i·g and h' = o·tanh(c'). The input products
do not depend on the recurrence, so they run as one GEMM over every time
step; the recurrent product runs once a step.

The precision follows the Flax cell's in a bf16 model: the carry (c, h) is
f32 (``initialize_carry`` takes the parameter dtype); h and x are cast to
bf16 for the two products, each rounded to bf16, then the bias and the
two sums, and the gate activations, all bf16. c' = f·c + i·g and h' come
out f32 (a bf16 gate times the f32 carry), so the encoder's output and
the metadata division are f32 in a bf16 model too; the next layer casts
its f32 input to bf16 for its product.

Parameters (per layer i, ``layers.i``): ``weight_ih`` (4H, in) and
``weight_hh`` (4H, H), the gates' kernels stacked i|f|g|o, and one
``bias`` (4H,), the recurrent kernels' biases (the Flax input kernels
have none). ``convert.py`` maps the Flax cells to them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..dense import Dense
from ..dropout import dropout


class LSTMLayer(nn.Module):
    """One layer of ``OptimizedLSTMCell`` over a (B, T, in) sequence."""

    def __init__(self, dim_in: int, dim_hidden: int) -> None:
        super().__init__()
        self.dim_hidden = dim_hidden
        # PyTorch's nn.LSTM default, U(-1/sqrt(H), 1/sqrt(H)), until
        # models.initializers (Flax's) or a state dict sets them
        bound = dim_hidden ** -0.5
        self.weight_ih = nn.Parameter(
            torch.empty(4 * dim_hidden, dim_in).uniform_(-bound, bound))
        self.weight_hh = nn.Parameter(
            torch.empty(4 * dim_hidden, dim_hidden).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(4 * dim_hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, in), any float dtype; returns h for every step,
        (B, T, H) f32."""
        dt = self.weight_ih.dtype
        b, steps = x.shape[:2]
        hidden = self.dim_hidden
        xw = x.to(dt) @ self.weight_ih.t()       # (B, T, 4H), one GEMM
        w_hh = self.weight_hh.t()
        c = torch.zeros(b, hidden, dtype=torch.float32, device=x.device)
        h = torch.zeros_like(c)
        out = []
        for t in range(steps):
            z = (h.to(dt) @ w_hh + self.bias) + xw[:, t]
            # one sigmoid over the four gates (g's is not used): fewer
            # launches a step, the same values
            i, f, _, o = torch.sigmoid(z).chunk(4, dim=1)
            g = torch.tanh(z[:, 2 * hidden:3 * hidden])
            c = f * c + i * g
            h = o * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class ProfileLSTM(nn.Module):
    kind = "lstm"  # the card's kind; picks the tokenizer

    def __init__(self, dim_in: int = 6, dim_hidden: int = 128,
                 num_layers: int = 2, dropout: float = 0.1,
                 metadata: bool = True) -> None:
        """Card keys of the JAX module."""
        super().__init__()
        self.dim_hidden = dim_hidden
        self.metadata = metadata
        self.dropout = dropout
        self.expand = Dense(dim_in, dim_hidden, bias=False)
        self.layers = nn.ModuleList(LSTMLayer(dim_hidden, dim_hidden)
                                    for _ in range(num_layers))

    @property
    def dim_out(self) -> int:
        return self.dim_hidden + int(self.metadata)

    def forward(self, profile: torch.Tensor, last_idx: torch.Tensor,
                profile_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``profile`` (B, T, dim_in), ``last_idx`` (B,) the last valid
        step of each row; returns (B, dim_out) f32."""
        x = self.expand(profile.to(self.expand.weight.dtype))
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = dropout(x, self.dropout, self.training)
        x = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
        if self.metadata:
            md = profile_len.to(x.dtype) / profile.shape[1]
            x = torch.cat([x, md.reshape(x.shape[0], -1)], dim=1)
        return dropout(x, self.dropout, self.training)
