"""Multi-head self-attention on ONE packed (B, L, 3E) q|k|v operand.

Port of ``multimodal_plankton_recognition_tpu/ops/pallas/attention.py``
``mha_core_qkv`` (forward, eval mode): the TPU kernel
``_fwd_kernel_stacked_qkv`` becomes the hand-written Hopper kernel
``csrc/attention_fwd.cu``; ``mha_qkv_reference`` is its plain PyTorch
version with the same rounding points.

Layout: head h's q sits at columns ``h*D``, its k at ``E + h*D`` and its v
at ``2E + h*D`` of the last axis. ``bias_rows`` is a (B, L) f32 additive
key bias (−1e9 on padded keys) or ``None`` for no mask. Returns (B, L, E)
in the input dtype.

Not ported (TPU machinery): probability dropout in the kernel (train mode
comes with the backward), the lane-mask head mode, the block_b / bf16-softmax
probe knobs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build

__all__ = ["mha_qkv", "mha_qkv_reference", "SUPPORTED_HEAD_DIMS"]

#: head dims the CUDA kernel is instantiated for (csrc/attention_fwd.cu)
SUPPORTED_HEAD_DIMS = (8, 16, 24, 32, 48, 64)


def mha_qkv_reference(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
                      heads: int) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's numerics: f32 scores from
    the input-dtype operands, f32 softmax, probabilities rounded to the
    input dtype before P·V, P·V accumulated in f32 and rounded on return.
    In f32 every rounding is the identity (the JAX einsum path)."""
    b, l, e3 = qkv.shape
    e = e3 // 3
    d = e // heads
    x = qkv.float().reshape(b, l, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, L, D)
    z = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if bias_rows is not None:
        z = z + bias_rows.float()[:, None, None, :]
    z = torch.exp(z - z.amax(dim=-1, keepdim=True))
    p = (z / z.sum(dim=-1, keepdim=True)).to(qkv.dtype).float()
    o = p @ v
    return o.transpose(1, 2).reshape(b, l, e).to(qkv.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("attention_fwd")
    vp = ctypes.c_void_p
    lib.mha_qkv_fwd_bf16.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, vp]
    lib.mha_qkv_fwd_bf16.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
                     heads: int) -> int:
    """Validate what the kernel takes; return the head dim."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bf16 qkv, got "
                        f"{qkv.dtype} (f32 models use mha_qkv_reference)")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be (B, L, 3E) with E divisible by "
                         f"heads={heads}, got {tuple(qkv.shape)}")
    b, l, e3 = qkv.shape
    d = e3 // (3 * heads)
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 4:
        raise ValueError("qkv must be contiguous and 4-byte aligned")
    if b > 65535 or heads > 65535:
        raise ValueError(f"grid limit: B={b}, heads={heads} must be <= 65535")
    if bias_rows is not None:
        if (bias_rows.device != qkv.device
                or bias_rows.dtype != torch.float32
                or tuple(bias_rows.shape) != (b, l)
                or not bias_rows.is_contiguous()):
            raise ValueError(
                f"bias_rows must be a contiguous ({b}, {l}) f32 tensor on "
                f"{qkv.device}, got {tuple(bias_rows.shape)} "
                f"{bias_rows.dtype} on {bias_rows.device}")
    return d


def mha_qkv(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
            heads: int) -> torch.Tensor:
    """Attention over packed qkv: the CUDA kernel for a CUDA bf16 tensor,
    the plain version for a CPU tensor, an error otherwise (no fallback).
    ``mha_qkv.launches`` counts kernel launches."""
    if qkv.device.type == "cpu":
        return mha_qkv_reference(qkv, bias_rows, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    d = _check_cuda_args(qkv, bias_rows, heads)
    b, l, e3 = qkv.shape
    out = torch.empty((b, l, e3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mha_qkv_fwd_bf16(
            qkv.data_ptr(),
            None if bias_rows is None else bias_rows.data_ptr(),
            out.data_ptr(), b, l, heads, d, 1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
    mha_qkv.launches += 1
    return out


mha_qkv.launches = 0
