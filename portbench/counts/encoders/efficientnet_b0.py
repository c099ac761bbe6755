"""EfficientNet-B0 (arXiv:1905.11946; timm ``efficientnet_b0``): the stem
(3 × 3, stride 2, 32), per MBConv its expansion, depthwise, squeeze-excite
and projection, then the 1 × 1 head to 1,280."""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.layers import conv_out

#: (expansion, channels, repeats, first stride, kernel) a stage
STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
          (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
          (6, 320, 1, 1, 3))


def flops(args: Dict, size: int) -> int:
    h = conv_out(size, 3, 2)
    total = 2 * h * h * 9 * args.get("in_chans", 1) * 32
    cin = 32
    for expand, ch, repeats, stride, k in STAGES:
        for b in range(repeats):
            s = stride if b == 0 else 1
            mid = cin * expand
            if expand != 1:
                total += 2 * h * h * cin * mid
            h = conv_out(h, k, s)
            se = max(1, int(cin * 0.25))
            total += 2 * h * h * k * k * mid + 4 * mid * se \
                + 2 * h * h * mid * ch
            cin = ch
    return total + 2 * h * h * cin * 1280


def width(args: Dict) -> int:
    return 1280


def attention(args: Dict, size: int, batch: int, keys=None) -> List:
    return []
