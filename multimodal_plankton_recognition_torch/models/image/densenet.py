"""DenseNet backbones, densenet121 and densenet169
(``models/image/densenet.py`` of the JAX package): the ResNet stem
(7×7 stride-2 conv + BN + ReLU + 3×3 stride-2 max pool), dense blocks of
BN-ReLU-conv 1×1 (``bn_size · growth`` wide) - BN-ReLU-conv 3×3
(``growth`` wide) layers, each concatenating its output to its input,
transitions of BN-ReLU-conv 1×1 to half the channels and a 2×2 stride-2
average pool between blocks, then a final BN + ReLU and the spatial mean.

Images come in the JAX layout (B, H, W, C); inside, the convolutions run
on NCHW tensors in ``channels_last`` memory, so the concatenations are
along dim 1. BatchNorm is Flax's (``models/batchnorm.py``); the module
names are the Flax tree's (``block2_layer5.conv1``, ``trans1_bn``,
``final_bn`` ...). The 2×2 average pool is flax's ``avg_pool`` as XLA
runs it: the window's four values summed in row-major order in the
tensor's dtype (in bf16 each partial sum rounds; ``avg_pool2d`` would
round once), then divided by 4, over the even rows and columns. The
spatial mean sums in f32 and rounds once.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..batchnorm import BatchNorm
from .efficientnet import _spatial_mean
from .resnet import stem


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (2, 2), strides=(2, 2))`` on NCHW: ((x00 + x01)
    + x10) + x11, each sum in x's dtype, then / 4."""
    h, w = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
    return (((x[:, :, 0:h:2, 0:w:2] + x[:, :, 0:h:2, 1:w:2])
             + x[:, :, 1:h:2, 0:w:2]) + x[:, :, 1:h:2, 1:w:2]) / 4


class _DenseLayer(nn.Module):
    """BN + ReLU + conv 1×1 → BN + ReLU + conv 3×3; returns [x, y] on the
    channels."""

    def __init__(self, cin: int, growth: int, bn_size: int) -> None:
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = nn.Conv2d(cin, bn_size * growth, 1, bias=False)
        self.bn2 = BatchNorm(bn_size * growth)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, padding=1,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, bn_size: int = 4,
                 in_chans: int = 1) -> None:
        """The JAX module's fields (``block_config``, ``growth``,
        ``bn_size``, ``in_chans``)."""
        super().__init__()
        self.stem_conv = nn.Conv2d(in_chans, 64, 7, stride=2, padding=3,
                                   bias=False)
        self.stem_bn = BatchNorm(64)
        ch = 64
        self.layer_names = []
        last = len(block_config) - 1
        for bi, n_layers in enumerate(block_config):
            names = []
            for li in range(n_layers):
                name = f"block{bi + 1}_layer{li}"
                self.add_module(name, _DenseLayer(ch, growth, bn_size))
                names.append(name)
                ch += growth
            trans = None
            if bi != last:
                trans = f"trans{bi + 1}"
                self.add_module(f"{trans}_bn", BatchNorm(ch))
                self.add_module(f"{trans}_conv",
                                nn.Conv2d(ch, ch // 2, 1, bias=False))
                ch //= 2
            self.layer_names.append((names, trans))
        self.final_bn = BatchNorm(ch)
        self._num_features = ch

    @property
    def num_features(self) -> int:
        return self._num_features

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (B, H, W, C) channel-last; returns (B, num_features)."""
        x = stem(self, image)
        for names, trans in self.layer_names:
            for name in names:
                x = getattr(self, name)(x)
            if trans is not None:
                x = F.relu(getattr(self, f"{trans}_bn")(x))
                x = _avg_pool_2x2(getattr(self, f"{trans}_conv")(x))
        return _spatial_mean(F.relu(self.final_bn(x)))


def densenet121(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 24, 16), **kw)


def densenet169(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 32, 32), **kw)
