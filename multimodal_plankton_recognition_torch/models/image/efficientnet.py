"""EfficientNet backbones, B0 and B1 (``models/image/efficientnet.py`` of the
JAX package): a stride-2 stem conv + BN + SiLU, MBConv blocks (1×1 expand
+ BN + SiLU, depthwise k×k + BN + SiLU, squeeze-excite, 1×1 project + BN,
the residual where shape allows), a 1×1 head conv to 1280 + BN + SiLU, and
the spatial mean.

Images come in the JAX layout (B, H, W, C); inside, the convolutions run
on NCHW tensors in ``channels_last`` memory, so a block's input is an NHWC
array without a copy. BatchNorm is Flax's (``models/batchnorm.py``). The
module names are the Flax tree's (``stem_conv``, ``stage2_block1.expand_bn``,
``se.reduce`` ...), so ``convert.py`` maps it one to one.

``fused`` (the card's ``fused_mbconv``) declares the same modules and only
picks the route of a block: in train mode, at stride 1, the block core
runs ``ops.mbconv.mbconv_core`` (kernels 13-16 on the card) on x rounded to
bf16, in either model dtype, and BN3 + the residual run here in the model
dtype from its statistics, as the JAX fused block does; eval mode,
stride-2 blocks and ``fused=False`` take the plain composition (cuDNN
convolutions on the card). The spatial means (SE and
head) sum in f32 and round once to the compute dtype, as ``jnp.mean`` of a
bf16 array does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.mbconv import mbconv_core
from ..batchnorm import BatchNorm

# (expand_ratio, channels, repeats, stride, kernel) per stage: the B0 table
B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of an NCHW tensor, summed in f32."""
    return x.float().mean((2, 3)).to(x.dtype)


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1,
          groups: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=bias)


class _SqueezeExcite(nn.Module):
    """x · sigmoid(expand(SiLU(reduce(mean_hw x)))), 1×1 convs with bias."""

    def __init__(self, channels: int, reduced: int) -> None:
        super().__init__()
        self.reduce = _conv(channels, reduced, bias=True)
        self.expand = _conv(reduced, channels, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = _spatial_mean(x)[:, :, None, None]
        return x * torch.sigmoid(self.expand(F.silu(self.reduce(s))))


class _MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int,
                 stride: int, kernel: int, se_ratio: float,
                 fused: bool = False) -> None:
        super().__init__()
        mid = in_ch * expand_ratio
        self.stride, self.kernel, self.fused = stride, kernel, fused
        self.residual = stride == 1 and in_ch == out_ch
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand_conv = _conv(in_ch, mid)
            self.expand_bn = BatchNorm(mid)
        self.dw_conv = _conv(mid, mid, kernel, stride, groups=mid)
        self.dw_bn = BatchNorm(mid)
        # the SE width is a share of the block's input channels
        self.se = _SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
        self.project_conv = _conv(mid, out_ch)
        self.project_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.training and self.stride == 1:
            y = self._fused(x)
        else:
            y = x
            if self.has_expand:
                y = F.silu(self.expand_bn(self.expand_conv(y)))
            y = F.silu(self.dw_bn(self.dw_conv(y)))
            y = self.project_bn(self.project_conv(self.se(y)))
        return y + x if self.residual else y

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """The block core through ``mbconv_core`` on NHWC views of the
        weights and of x (both rounded to bf16 inside it), then BN3 in f32
        from its batch statistics, cast to x's dtype (the JAX block's
        ``_bn``), updating the three running statistics (f32)."""
        mid, k = self.dw_conv.out_channels, self.kernel
        se = self.se
        wexp = g1 = b1 = None
        if self.has_expand:
            wexp = self.expand_conv.weight.reshape(mid, -1).t()
            g1, b1 = self.expand_bn.weight, self.expand_bn.bias
        y3, m1, v1, m2, v2, m3, v3 = mbconv_core(
            x.permute(0, 2, 3, 1), wexp, g1, b1,
            self.dw_conv.weight.reshape(mid, k, k).permute(1, 2, 0),
            self.dw_bn.weight, self.dw_bn.bias,
            se.reduce.weight.reshape(-1, mid).t(), se.reduce.bias,
            se.expand.weight.reshape(mid, -1).t(), se.expand.bias,
            self.project_conv.weight.reshape(-1, mid).t(), k)
        if self.has_expand:
            self.expand_bn.update_stats(m1, v1)
        self.dw_bn.update_stats(m2, v2)
        bn3 = self.project_bn
        bn3.update_stats(m3, v3)
        out = ((y3.float() - m3) * torch.rsqrt(v3 + bn3.eps) * bn3.weight
               + bn3.bias).to(x.dtype)
        return out.permute(0, 3, 1, 2)


class EfficientNet(nn.Module):
    def __init__(self, depth_mult: float = 1.0, in_chans: int = 1,
                 se_ratio: float = 0.25, fused: bool = False) -> None:
        super().__init__()
        self.stem_conv = _conv(in_chans, 32, 3, 2)
        self.stem_bn = BatchNorm(32)
        blocks = []
        in_ch = 32
        for si, (expand, ch, repeats, stride, k) in enumerate(B0_STAGES):
            for b in range(int(math.ceil(depth_mult * repeats))):
                blocks.append((f"stage{si + 1}_block{b}", _MBConv(
                    in_ch, ch, expand, stride if b == 0 else 1, k, se_ratio,
                    fused)))
                in_ch = ch
        for name, block in blocks:
            self.add_module(name, block)
        self.block_names = [name for name, _ in blocks]
        self.head_conv = _conv(in_ch, 1280)
        self.head_bn = BatchNorm(1280)

    @property
    def num_features(self) -> int:
        return 1280

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (B, H, W, C) channel-last; returns (B, 1280)."""
        x = image.to(self.stem_conv.weight.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return _spatial_mean(x)


def efficientnet_b0(**kw) -> EfficientNet:
    return EfficientNet(depth_mult=1.0, **kw)


def efficientnet_b1(**kw) -> EfficientNet:
    return EfficientNet(depth_mult=1.1, **kw)
