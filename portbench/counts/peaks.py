"""Published peaks of one NVIDIA H100 SXM and the least time of a piece
of work on it.

Frozen copy of the port's card smoke run (``chip_smoke.py``
``HBM_BYTES_PER_S``, ``BF16_FLOPS``, ``F32_FLOPS`` and ``_bound``), whose
numbers are NVIDIA's H100 data sheet (SXM part, dense rates, at 700 W):
3.35 TB/s of HBM3, 989 TFLOP/s with bf16 operands on the tensor cores,
67 TFLOP/s of float32 on the CUDA cores. The least time is the larger of
the bytes (each input read once, each output written once) over the HBM
rate and the operations over their rates.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def least_time_s(nbytes: float, bf16_flops: float = 0.0,
                 f32_flops: float = 0.0) -> float:
    """Seconds the card needs at least: max(bytes / HBM rate, bf16
    operations / 989 TFLOP/s + f32 operations / 67 TFLOP/s)."""
    return max(nbytes / HBM_BYTES_PER_S,
               bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS)
