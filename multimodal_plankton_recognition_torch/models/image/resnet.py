"""2-D ResNet backbones, resnet18 and resnet50 (``models/image/resnet.py``
of the JAX package): a 7×7 stride-2 stem conv + BN + ReLU, a 3×3 stride-2
max pool (padding 1, padded with −inf as flax's ``max_pool``), four stages
of basic (resnet18) or bottleneck (resnet50, 4× expansion) residual
blocks, channels 64·2^stage, stride 2 at the first block of every stage
but the first, and the spatial mean.

Images come in the JAX layout (B, H, W, C); inside, the convolutions run
on NCHW tensors in ``channels_last`` memory. BatchNorm is Flax's
(``models/batchnorm.py``). The module names are the Flax tree's
(``stem_conv``, ``stage2_block0.proj_bn`` ...), so ``convert.py`` maps it
one to one. A block projects its identity (a strided 1×1 conv + BN) where
its stride or width changes, so resnet50's ``stage1_block0`` projects at
stride 1 (64 → 256 channels). The spatial mean sums in f32 and rounds once
to the compute dtype, as ``jnp.mean`` of a bf16 array does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..batchnorm import BatchNorm
from .efficientnet import _spatial_mean


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class _BasicBlock(nn.Module):
    """conv 3×3 (stride) + BN + ReLU → conv 3×3 + BN, plus the identity or
    its projection, then ReLU."""

    def __init__(self, cin: int, channels: int, stride: int,
                 use_projection: bool) -> None:
        super().__init__()
        self.conv1 = _conv(cin, channels, 3, stride)
        self.bn1 = BatchNorm(channels)
        self.conv2 = _conv(channels, channels, 3)
        self.bn2 = BatchNorm(channels)
        self.use_projection = use_projection
        if use_projection:
            self.proj_conv = _conv(cin, channels, 1, stride)
            self.proj_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.proj_bn(self.proj_conv(x)) if self.use_projection \
            else x
        return F.relu(y + identity)


class _Bottleneck(nn.Module):
    """conv 1×1 + BN + ReLU → conv 3×3 (stride) + BN + ReLU → conv 1×1 to
    4× the width + BN, plus the identity or its projection, then ReLU."""

    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int,
                 use_projection: bool) -> None:
        super().__init__()
        out = channels * self.expansion
        self.conv1 = _conv(cin, channels, 1)
        self.bn1 = BatchNorm(channels)
        self.conv2 = _conv(channels, channels, 3, stride)
        self.bn2 = BatchNorm(channels)
        self.conv3 = _conv(channels, out, 1)
        self.bn3 = BatchNorm(out)
        self.use_projection = use_projection
        if use_projection:
            self.proj_conv = _conv(cin, out, 1, stride)
            self.proj_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.proj_bn(self.proj_conv(x)) if self.use_projection \
            else x
        return F.relu(y + identity)


def stem(module: nn.Module, image: torch.Tensor) -> torch.Tensor:
    """The ResNet / DenseNet stem of ``module`` (its ``stem_conv`` and
    ``stem_bn``) on a (B, H, W, C) image: conv + BN + ReLU + max pool, as
    an NCHW tensor in ``channels_last`` memory."""
    x = image.to(module.stem_conv.weight.dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.relu(module.stem_bn(module.stem_conv(x)))
    return F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False, in_chans: int = 1) -> None:
        """The JAX module's fields (``stage_sizes``, ``bottleneck``,
        ``in_chans``)."""
        super().__init__()
        self.bottleneck = bottleneck
        self.stem_conv = _conv(in_chans, 64, 7, 2)
        self.stem_bn = BatchNorm(64)
        block = _Bottleneck if bottleneck else _BasicBlock
        expansion = 4 if bottleneck else 1
        cin = 64
        self.block_names = []
        for stage, repeats in enumerate(stage_sizes):
            width = 64 * 2 ** stage
            for b in range(repeats):
                stride = 2 if stage > 0 and b == 0 else 1
                proj = b == 0 and (stride != 1 or cin != width * expansion)
                name = f"stage{stage + 1}_block{b}"
                self.add_module(name, block(cin, width, stride, proj))
                self.block_names.append(name)
                cin = width * expansion

    @property
    def num_features(self) -> int:
        return 512 * (4 if self.bottleneck else 1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (B, H, W, C) channel-last; returns (B, num_features)."""
        x = stem(self, image)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return _spatial_mean(x)


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True, **kw)
