"""Operations of the layers the encoders' counts share, 2 a
multiply-add."""

from __future__ import annotations


def transformer_block(tokens: int, e: int, hidden: int) -> int:
    """One transformer block over one sample's tokens: q|k|v, q kᵀ, P v,
    the out projection and the two feed-forward layers."""
    return 2 * tokens * e * 3 * e + 4 * tokens * tokens * e \
        + 2 * tokens * e * e + 4 * tokens * e * hidden


def conv_out(size: int, k: int, stride: int) -> int:
    """Output length of a convolution padded k // 2."""
    return (size + 2 * (k // 2) - k) // stride + 1
