"""int8 serving quantisation: per-channel weights, dynamic activations
(``ops/quant.py`` of the JAX package).

Quantisation is an inference-time transform: the building blocks below,
and a context manager, ``quantized_dense``, under which every
counterpart of a flax ``nn.Dense`` (``models.dense.Dense``: the ViT's
``mlp1`` / ``mlp2`` on the unfused route, the profile transformer's
``expand``, ``ff1`` and ``ff2``, the LSTM's ``expand``, the two
projections, a classifier's ``fc``) runs the int8 path. Nothing else is
swapped: attention's ``qkv`` / ``out`` projections are plain
``nn.Linear`` (the JAX module's are not ``nn.Dense`` either), and the
fused FFN route reads its Linears' weights without calling them.

Scheme (the standard W8A8 dynamic recipe), with JAX's rounding points:

* weights: symmetric per-output-channel int8, scales from ``max|w|``;
* activations: symmetric per-tensor int8, scale from the runtime
  ``max|x|`` (dynamic: no calibration corpus);
* the product accumulated in int32, dequantised as ``y32 * (x_scale *
  w_scale)`` in f32, the bias added in f32.

Rounding is half to even on both sides (``torch.round``, as
``jnp.round``). On the card the int8 product is ``torch._int_mm``
(cuBLAS's int8 GEMM; JAX computes it with ``lax.dot_general`` outside
any Pallas kernel), which takes more than 16 rows and K and N in
multiples of 8: the operands are zero-padded to that, which changes no
sum. On the CPU the product is its plain version, an exact f64 matmul
(``int8_mm_reference``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-12
_QUANTIZED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "plankton_quantized_dense", default=False)


def quantize_per_channel(w: torch.Tensor, axis: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation of ``w`` reducing over ``axis``.

    For an (in, out) kernel (a Linear's ``weight.T``), ``axis=0`` gives one
    scale per output channel. Returns ``(w8, scale)`` with ``w ~= w8 *
    scale``.
    """
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w8, scale


def quantize_dynamic(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with a runtime scale. Returns (x8, scale)."""
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(), _EPS) / 127.0
    x8 = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return x8, scale


def int8_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 product: (M, K) int8 · (K, N) int8 ->
    (M, N) int32, on any device. Exact: the f64 product holds every
    partial sum (|sum| <= K 127² < 2**53), and the result fits int32 for K
    < 133,000."""
    return (a.double() @ b.double()).to(torch.int32)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 -> (M, N) int32: ``torch._int_mm`` on the
    card, the operands zero-padded to its shapes (M > 16, K and N
    multiples of 8); the plain version on the CPU."""
    if a.device.type == "cpu":
        return int8_mm_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no int8 product for device {a.device}")
    return _padded_int_mm(a, b)


def _padded_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` on operands zero-padded to the shapes it takes."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp, np_) != (m, k, n):
        a, b = _pad_to(a, mp, kp), _pad_to(b, kp, np_)
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor
                ) -> torch.Tensor:
    """``x @ dequant(w8)`` with the contraction in int8.

    ``x``: (..., in) float; ``w8``: (in, out) int8; ``w_scale``: (1, out).
    Returns f32 (..., out).
    """
    x8, x_scale = quantize_dynamic(x)
    lead = x8.shape[:-1]
    y32 = int8_mm(x8.reshape(-1, x8.shape[-1]), w8)
    y = y32.float() * (x_scale * w_scale)
    return y.reshape(*lead, w8.shape[-1])


def dense_int8(linear: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """int8 forward of a Linear: quantise its weight per output channel,
    run the int8 product, add the f32 bias, return in the module's dtype
    (JAX's rule for a Dense with a ``dtype``, which every Dense of the
    models has; the port's Linears hold that dtype)."""
    w8, w_scale = quantize_per_channel(linear.weight.t(), axis=0)
    y = int8_matmul(x, w8, w_scale)
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(linear.weight.dtype)


def quantizing() -> bool:
    """True inside ``quantized_dense``."""
    return _QUANTIZED.get()


@contextlib.contextmanager
def quantized_dense() -> Iterator[None]:
    """Context manager: every ``models.dense.Dense`` called inside runs the
    W8A8 int8 path. Inference-time only: gradients through the rounding
    are not defined."""
    token = _QUANTIZED.set(True)
    try:
        yield
    finally:
        _QUANTIZED.reset(token)
