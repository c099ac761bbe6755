"""Fused transformer feed-forward, Dense(E→F) → tanh-GELU or ReLU →
dropout → Dense(F→E) with the (rows, F) hidden kept on chip, and its
backward.

Port of ``multimodal_plankton_recognition_tpu/ops/pallas/experimental/
ffn.py``: the TPU kernels ``_fwd_kernel`` (kernel 9) and ``_bwd_kernel``
(kernel 10) become the forward and the backward of ``csrc/ffn.cu``
(``ffn_fwd_rows_kernel``; ``ffn_bwd_rows_kernel`` and the shared Hopper
GEMM's weight gradients), both built on ``csrc/hopper_gemm.cuh``'s
``wgmma`` and TMA pieces.
``ffn_reference`` and ``ffn_bwd_reference`` are their plain PyTorch
versions, with the TPU kernels' rounding points (``ffn.py:101-185``,
``:272-281``):

* forward: ``h_pre = bf16(bf16(x)·bf16(w1) + b1)`` (f32 accumulation),
  ``h = bf16(act(h_pre))``, dropout on h scaled by ``1/(1-p)`` and rounded
  to bf16, ``y = h·bf16(w2) + b2`` in f32, cast once to x's dtype;
* backward: dy rounded to bf16; ``db2 = Σ dy``, ``dw2 = hᵀ·dy``;
  ``dh = dy·w2ᵀ`` in f32, masked; ``dpre = dh·act'(h_pre)``;
  ``db1 = Σ dpre``, ``dw1 = bf16(x)ᵀ·bf16(dpre)``, ``dx = bf16(dpre)·w1ᵀ``
  in x's dtype; the weight gradients in f32.

Layouts are the JAX package's: x (B, L, E), w1 (E, F), b1 (F,), w2 (F, E),
b2 (E,). ``ffn_core`` is the differentiable entry (a
``torch.autograd.Function``): the kernels for a CUDA tensor, the plain
versions for a CPU tensor, an error otherwise. ``ffn_fwd.launches`` and
``ffn_bwd.launches`` count kernel launches (one wrapper call each, whatever
number of passes it runs).

Dropout. The TPU kernel draws its mask from the TPU PRNG, seeded per grid
step, which has no counterpart here; the kernels and the plain versions
draw it instead from a counter-based hash of (seed, flattened row
``b*L + l``, hidden column) (``ffn_dropout_bits``, with the ``fmix32`` of
``csrc/dropout.cuh``), so the backward regenerates the forward's mask with
nothing stored, and kernel and plain version agree bit for bit on it. A
hidden unit is kept when its 32 bits are >= ``p * 2**32``.

Where no gradient will be taken, ``ffn_core`` calls the forward as the
registered op ``plankton::ffn_fwd`` (CUDA: kernel 9; CPU: the plain
version; a fake implementation for symbolic sizes), so that
``torch.export`` keeps kernel 9 as one node (``ops/attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build, hopper_gemm
from .attention import (_MASK32, _needs_grad, dropout_threshold, hash_bits,
                        keep_factor)

__all__ = ["ffn_core", "ffn_fwd", "ffn_bwd", "ffn_reference",
           "ffn_bwd_reference", "ffn_dropout_bits", "bwd_scratch",
           "ffn_fwd_op", "ACTIVATIONS", "SUPPORTED_WIDTHS"]

ACTIVATIONS = ("gelu", "relu")
#: model widths E the CUDA kernels are instantiated for (csrc/ffn.cu): the
#: ViTs' 192 and 384 and the profile transformers' 64, 128 and 192
SUPPORTED_WIDTHS = (64, 128, 192, 384)
#: the kernels' hidden chunks are 64 columns; F is zero-padded to this
F_ALIGN = 64
_C = 0.7978845608028654  # sqrt(2/pi), flax nn.gelu's tanh approximation
BF16 = torch.bfloat16


def _r(t: torch.Tensor) -> torch.Tensor:
    """Round through bf16, back to f32."""
    return t.to(BF16).float()


def _act(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.clamp_min(z, 0.0)
    u = _C * (z + 0.044715 * z * z * z)
    return 0.5 * z * (1.0 + torch.tanh(u))


def _dact(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return (z > 0.0).float()
    u = _C * (z + 0.044715 * z * z * z)
    t = torch.tanh(u)
    return 0.5 * (1.0 + t) \
        + 0.5 * z * (1.0 - t * t) * _C * (1.0 + 3 * 0.044715 * z * z)


def ffn_dropout_bits(seed: int, rows: int, features: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """The kernels' 32 random bits per hidden unit, (rows, F) int64: key
    the flattened row, counter the hidden column (``hash_bits``)."""
    return hash_bits(seed, rows, features, device)


def _hidden(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            activation: str, dropout_p: float, seed: int):
    """(x rounded, h_pre, the dropped bf16 hidden, the dropout factor or
    None) on flattened rows, all f32; shared by both plain versions."""
    xf = _r(x2.float())
    h_pre = _r(xf @ _r(w1.float()) + b1.float())
    h = _r(_act(h_pre, activation))
    factor = None
    if dropout_p > 0.0:
        factor = keep_factor(ffn_dropout_bits(seed, *h.shape, h.device),
                             dropout_p)
        h = _r(h * factor)
    return xf, h_pre, h, factor


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  activation: str = "gelu", dropout_p: float = 0.0,
                  seed: int = 0) -> torch.Tensor:
    """Plain version of kernel 9: y (B, L, E) in x's dtype."""
    e = x.shape[-1]
    _, _, h, _ = _hidden(x.reshape(-1, e), w1, b1, activation, dropout_p,
                         seed)
    y = h @ _r(w2.float()) + b2.float()
    return y.to(x.dtype).reshape(x.shape)


def ffn_bwd_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, dy: torch.Tensor,
                      activation: str = "gelu", dropout_p: float = 0.0,
                      seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """Plain version of kernel 10: (dx in x's dtype, dw1 (E, F), db1 (F,),
    dw2 (F, E), db2 (E,) in f32)."""
    e = x.shape[-1]
    xf, h_pre, h, factor = _hidden(x.reshape(-1, e), w1, b1, activation,
                                   dropout_p, seed)
    dyf = _r(dy.to(x.dtype).reshape(-1, e).float())
    dh = dyf @ _r(w2.float()).T
    if factor is not None:
        dh = dh * factor
    dpre = dh * _dact(h_pre, activation)
    dpre_r = _r(dpre)
    dx = dpre_r @ _r(w1.float()).T
    return (dx.to(x.dtype).reshape(x.shape), xf.T @ dpre_r, dpre.sum(0),
            h.T @ dyf, dyf.sum(0))


# ---------------------------------------------------------------------------
# the kernels: csrc/ffn.cu
# ---------------------------------------------------------------------------

_SCALARS = [ctypes.c_int] * 5 + [ctypes.c_uint, ctypes.c_uint,
                                 ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    """ffn_fwd(x, w1t, b1, w2, b2, y, rows, E, F, relu, y_f32, seed, thr,
    inv_keep, stream); ffn_bwd(x, w1t, b1, w2, dy, dx, dw1t, db1, dw2, db2,
    dpre, h, colpart, wpart, groups, rows, E, F, relu, dx_f32, seed, thr,
    inv_keep, stream). Both return a cudaError_t."""
    lib = build.load("ffn")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ffn_fwd.argtypes = [vp] * 6 + _SCALARS
    lib.ffn_fwd.restype = ci
    lib.ffn_bwd.argtypes = [vp] * 14 + [ci] + _SCALARS
    lib.ffn_bwd.restype = ci
    return lib


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no FFN kernel for device {x.device}")
    return False


def _rows(t: torch.Tensor, rows: int, e: int) -> torch.Tensor:
    """``t`` as contiguous (rows, E), 16-byte aligned (the kernels read 16
    bytes a thread)."""
    t = t.reshape(rows, e).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prep(x, w1, b1, w2, b2, activation, dropout_p):
    """Check what the kernels take; return (x as (rows, E), w1ᵀ and w2 as
    (Fp, E) bf16, b1 (Fp,) and b2 (E,) f32, the scalars): F zero-padded to
    ``F_ALIGN``, which adds hidden units of value 0 and gradient 0."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got "
                         f"{activation!r}")
    if x.dtype not in (BF16, torch.float32) or x.dim() != 3:
        raise TypeError(f"x must be (B, L, E) bf16 or f32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    e = x.shape[-1]
    f = w1.shape[1]
    if e not in SUPPORTED_WIDTHS:
        raise ValueError(f"width {e} not in {SUPPORTED_WIDTHS}")
    if (tuple(w1.shape) != (e, f) or tuple(w2.shape) != (f, e)
            or b1.numel() != f or b2.numel() != e):
        raise ValueError(f"weights must be w1 ({e}, F), b1 (F,), w2 (F, "
                         f"{e}), b2 ({e},), got {tuple(w1.shape)}, "
                         f"{tuple(b1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(b2.shape)}")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")
    rows = x.numel() // e
    if rows >= 2 ** 31 // max(e, f):
        raise ValueError(f"{rows} rows exceed the kernels' 32-bit indexing")
    fp = -(-f // F_ALIGN) * F_ALIGN

    def pad(t: torch.Tensor, dtype) -> torch.Tensor:
        t = t.detach().to(dtype)
        if fp == f:
            return t.contiguous()
        out = torch.zeros((fp,) + tuple(t.shape[1:]), dtype=dtype,
                          device=t.device)
        out[:f] = t
        return out

    scalars = (int(activation == "relu"), int(x.dtype == torch.float32))
    return (_rows(x, rows, e), pad(w1.t(), BF16),
            pad(b1.reshape(f), torch.float32), pad(w2, BF16),
            b2.detach().reshape(e).float().contiguous(), rows, e, f, fp,
            scalars, dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p))


def ffn_fwd(x, w1, b1, w2, b2, activation: str = "gelu",
            dropout_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Kernel 9 on CUDA, the plain version on the CPU: y (B, L, E) in x's
    dtype. ``ffn_fwd.launches`` counts launches."""
    if _on_cpu(x):
        return ffn_reference(x, w1, b1, w2, b2, activation, dropout_p, seed)
    (x2, w1t, b1p, w2p, b2f, rows, e, _, fp, (relu, y_f32), thr,
     inv_keep) = _prep(x, w1, b1, w2, b2, activation, dropout_p)
    # h_pre reads x rounded to bf16 (the TPU kernel's _bf): once here
    xb = x2 if x2.dtype == BF16 else x2.to(BF16)
    y = torch.empty_like(x2)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ffn_fwd(xb.data_ptr(), w1t.data_ptr(), b1p.data_ptr(),
                          w2p.data_ptr(), b2f.data_ptr(), y.data_ptr(), rows,
                          e, fp, relu, y_f32, seed & _MASK32, thr, inv_keep,
                          torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "ffn_fwd")
    ffn_fwd.launches += 1
    return y.reshape(x.shape)


def bwd_scratch(rows: int, e: int, fp: int, groups: int):
    """Kernel 10's scratch: ({name: (byte offset, bytes)}, total bytes),
    each part on a 256-byte boundary: bf16(dpre) and the dropped bf16 h
    (rows, Fp), which the weight gradients read; the per-64-row-tile f32
    column sums of dpre and dy (ceil(rows / 64), Fp + E), which give db1
    and db2; the weight gradients' f32 group partials (groups, Fp·E),
    shared by dw1ᵀ and dw2, which run one after the other."""
    tiles = -(-rows // 64)
    sizes = {"dpre": rows * fp * 2, "h": rows * fp * 2,
             "colpart": tiles * (fp + e) * 4, "wpart": groups * fp * e * 4}
    layout, offset = {}, 0
    for name, size in sizes.items():
        layout[name] = (offset, size)
        offset += -(-size // 256) * 256
    return layout, offset


def ffn_bwd(x, w1, b1, w2, b2, dy, activation: str = "gelu",
            dropout_p: float = 0.0, seed: int = 0
            ) -> Tuple[torch.Tensor, ...]:
    """Kernel 10 on CUDA, the plain version on the CPU: (dx in x's dtype,
    dw1 (E, F), db1 (F,), dw2 (F, E), db2 (E,) in f32).
    ``ffn_bwd.launches`` counts launches."""
    if _on_cpu(x):
        return ffn_bwd_reference(x, w1, b1, w2, b2, dy, activation,
                                 dropout_p, seed)
    (x2, w1t, b1p, w2p, _, rows, e, f, fp, (relu, x_f32), thr,
     inv_keep) = _prep(x, w1, b1, w2, b2, activation, dropout_p)
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    # both products round x and dy to bf16 (the TPU kernel's _bf): once here
    xb = x2 if x2.dtype == BF16 else x2.to(BF16)
    dyb = _rows(dy.to(x.dtype).to(BF16), rows, e)
    groups = hopper_gemm.wgrad_groups(rows, fp, e,
                                      hopper_gemm.sm_count(x.device))
    layout, total = bwd_scratch(rows, e, fp, groups)
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    part = {name: scratch.data_ptr() + offset
            for name, (offset, _) in layout.items()}
    f32 = functools.partial(torch.empty, dtype=torch.float32,
                            device=x.device)
    dx = torch.empty_like(x2)
    dw1t, db1, dw2, db2 = f32((fp, e)), f32(fp), f32((fp, e)), f32(e)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ffn_bwd(
            xb.data_ptr(), w1t.data_ptr(), b1p.data_ptr(), w2p.data_ptr(),
            dyb.data_ptr(), dx.data_ptr(), dw1t.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), part["dpre"], part["h"],
            part["colpart"], part["wpart"], groups, rows, e, fp, relu, x_f32,
            seed & _MASK32, thr, inv_keep,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "ffn_bwd")
    ffn_bwd.launches += 1
    return (dx.reshape(x.shape), dw1t[:f].t(), db1[:f], dw2[:f], db2)


ffn_fwd.launches = 0
ffn_bwd.launches = 0


class _FfnCore(torch.autograd.Function):
    """Forward: kernel 9; backward: kernel 10, recomputing the hidden and
    its dropout mask from x and the seed, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation, dropout_p, seed):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.args = (activation, dropout_p, seed)
        return ffn_fwd(x, w1, b1, w2, b2, activation, dropout_p, seed)

    @staticmethod
    def backward(ctx, dy) -> Tuple[Optional[torch.Tensor], ...]:
        x, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = ffn_bwd(x, w1, b1, w2, b2, dy, *ctx.args)
        return (dx, dw1.to(w1.dtype), db1.reshape(b1.shape).to(b1.dtype),
                dw2.to(w2.dtype), db2.reshape(b2.shape).to(b2.dtype), None,
                None, None)


def ffn_core(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, activation: str = "gelu",
             dropout_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Differentiable fused FFN over (B, L, E) with hidden dropout
    ``dropout_p`` (0 in eval mode) drawn from ``seed`` (the JAX
    ``ffn_core``): kernels 9 and 10 for a CUDA tensor, the plain versions
    for a CPU tensor, an error otherwise. Returns (B, L, E) in x's
    dtype."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got "
                         f"{activation!r}")
    dropout_threshold(dropout_p)  # validates p before any launch
    _on_cpu(x)  # raises on a device with neither kernel nor plain version
    if not _needs_grad(x, w1, b1, w2, b2):
        return ffn_fwd_op(x, w1, b1, w2, b2, activation, dropout_p, seed)
    return _FfnCore.apply(x, w1, b1, w2, b2, activation, dropout_p, seed)


@torch.library.custom_op("plankton::ffn_fwd", mutates_args=())
def ffn_fwd_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, activation: str,
               dropout_p: float, seed: int) -> torch.Tensor:
    """Kernel 9 as a registered op: the kernel on CUDA, the plain version
    on the CPU (``ffn_fwd``)."""
    return ffn_fwd(x, w1, b1, w2, b2, activation, dropout_p, seed)


@ffn_fwd_op.register_fake
def _(x, w1, b1, w2, b2, activation, dropout_p, seed):
    return torch.empty_like(x)
