"""The precision of the reference's products.

The reference computes in float32 with TF32 off. ``Precision`` rounds the
two operands of every product (matmul, linear, convolution, the attention
products, the contrastive similarities) before it runs:

* ``F32`` leaves them alone: the reference;
* ``FP8`` rounds them to float8 e4m3 with one scale per tensor (its
  largest magnitude onto 448), and, in the backward, the gradient that
  reaches each operand to float8 e5m2 the same way: the control, the
  step below the configurations' bfloat16 that a later change could be
  tempted by. Accumulation stays float32, as on the tensor cores.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """``op(x)``: ``x`` as an operand of a product."""

    name = "f32"

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8Precision(Precision):
    name = "fp8"

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x)


F32 = Precision()
FP8 = Fp8Precision()


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """Full float32 products on the card inside the block: TF32 off for
    matmuls and cuDNN, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
