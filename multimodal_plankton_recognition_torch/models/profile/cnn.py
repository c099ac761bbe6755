"""1-D ResNet profile encoder (``models/profile/cnn.py`` of the JAX
package): a stem Conv1d(k3, s2) + norm + ReLU + MaxPool(3, 2, 1), four
stages of basic residual blocks (channels doubling, stride 2 from the
second stage), a global max over time, the metadata scalar and dropout.

The public layout is channel-last (B, L, 6), as in the JAX module; inside,
the convolutions run on (B, C, L). The max pool pads with −inf, so padding
never wins. The metadata scalar is ``profile_len`` cast to the model dtype
first, then divided by the profile length L (224 at a card's target size,
where the transformer divides by its 225 tokens). ``norm`` is ``batch``
(Flax BatchNorm) or ``group`` (Flax GroupNorm, groups of 8). Train-mode
dropout on the final feature draws from the step's generator
(``models/dropout.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..batchnorm import BatchNorm, GroupNorm
from ..dropout import dropout


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "group":
        return GroupNorm(channels, group_size=8)
    if kind == "batch":
        return BatchNorm(channels)
    raise ValueError(f"norm must be 'batch' or 'group', got {kind!r}")


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class _BasicBlock1D(nn.Module):
    """conv(k3, s) + norm + ReLU → conv(k3, 1) + norm, plus the identity
    (or a strided 1×1 projection + norm), then ReLU."""

    def __init__(self, cin: int, channels: int, stride: int,
                 use_projection: bool, norm: str) -> None:
        super().__init__()
        self.conv1 = _conv(cin, channels, 3, stride)
        self.bn1 = _norm(norm, channels)
        self.conv2 = _conv(channels, channels, 3, 1)
        self.bn2 = _norm(norm, channels)
        if use_projection:
            self.proj_conv = _conv(cin, channels, 1, stride)
            self.proj_bn = _norm(norm, channels)
        self.use_projection = use_projection

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.proj_bn(self.proj_conv(x)) if self.use_projection \
            else x
        return F.relu(y + identity)


class ProfileCNN(nn.Module):
    kind = "cnn"  # the card's kind; picks the tokenizer

    def __init__(self, dim_in: int = 6, blocks: Sequence[int] = (2, 2, 2, 2),
                 groups: int = 1, base_channels: int = 32,
                 dropout: float = 0.1, metadata: bool = True,
                 norm: str = "batch") -> None:
        """Card keys of the JAX module; ``groups`` is accepted for card
        parity (the JAX module does not use it either)."""
        super().__init__()
        self.base_channels = base_channels
        self.metadata = metadata
        self.dropout = dropout
        self.stem_conv = _conv(dim_in, base_channels, 3, 2)
        self.stem_bn = _norm(norm, base_channels)
        cin = base_channels
        for stage, repeats in enumerate(blocks):
            channels = base_channels * 2 ** stage
            for b in range(repeats):
                stride = 2 if stage and b == 0 else 1
                proj = b == 0 and (stride != 1 or cin != channels)
                self.add_module(f"stage{stage + 1}_block{b}", _BasicBlock1D(
                    cin, channels, stride, proj, norm))
                cin = channels

    @property
    def dim_out(self) -> int:
        return self.base_channels * 8 + int(self.metadata)

    def forward(self, profile: torch.Tensor,
                profile_len: Optional[torch.Tensor] = None,
                **tokens) -> torch.Tensor:
        """``profile`` (B, L, D) channel-last; returns (B, dim_out)."""
        x = profile.to(self.stem_conv.weight.dtype).transpose(1, 2)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool1d(x, 3, 2, padding=1)  # pads with -inf
        for name, block in self.named_children():
            if name.startswith("stage"):
                x = block(x)
        x = x.amax(dim=2)
        if self.metadata:
            md = profile_len.to(x.dtype) / profile.shape[1]
            x = torch.cat([x, md.reshape(x.shape[0], -1)], dim=1)
        return dropout(x, self.dropout, self.training)
