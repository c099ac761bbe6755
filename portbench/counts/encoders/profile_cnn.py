"""The profile CNN: a 1-D ResNet of basic blocks (stem k 3 stride 2, a
max pool, then ``blocks`` blocks a stage of ``base_channels`` × 2^stage),
a global max over time."""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.layers import conv_out


def flops(args: Dict, size: int) -> int:
    base = args.get("base_channels", 32)
    length = conv_out(size, 3, 2)
    total = 2 * length * 3 * args.get("dim_in", 6) * base
    length = conv_out(length, 3, 2)  # the max pool
    cin = base
    for stage, repeats in enumerate(args.get("blocks", (2, 2, 2, 2))):
        ch = base * 2 ** stage
        for b in range(repeats):
            stride = 2 if stage and b == 0 else 1
            out = conv_out(length, 3, stride)
            total += 2 * out * 3 * cin * ch + 2 * out * 3 * ch * ch
            if b == 0 and (stride != 1 or cin != ch):
                total += 2 * out * cin * ch
            length, cin = out, ch
    return total


def width(args: Dict) -> int:
    stages = len(args.get("blocks", (2, 2, 2, 2)))
    return args.get("base_channels", 32) * 2 ** (stages - 1)


def attention(args: Dict, size: int, batch: int, keys=None) -> List:
    return []
