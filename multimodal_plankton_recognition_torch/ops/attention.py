"""Multi-head self-attention with attention-probability dropout and its
backward, on ONE packed (B, L, 3E) q|k|v operand or on separate (B, L, E)
q, k and v.

Port of ``multimodal_plankton_recognition_tpu/ops/pallas/attention.py``:

* ``mha_qkv`` (``mha_core_qkv``): the TPU kernels
  ``_fwd_kernel_stacked_qkv`` and ``_bwd_kernel_stacked_qkv`` (kernels 1
  and 2) become the entry points ``mha_qkv_fwd_bf16`` and
  ``mha_qkv_bwd_bf16`` of ``csrc/attention_fwd.cu`` and
  ``csrc/attention_bwd.cu``;
* ``mha`` (``mha_core``, the module's unpacked route): ``_fwd_kernel`` /
  ``_fwd_kernel_stacked`` and ``_bwd_kernel`` / ``_bwd_kernel_stacked``
  (kernels 3 and 4) become ``mha_fwd_bf16`` and ``mha_bwd_bf16`` of the
  same sources, which share the device code of kernels 1 and 2 and read
  the three operands through a row stride of E instead of 3E.

``*_reference`` are their plain PyTorch versions with the same rounding
points; ``mha_qkv`` and ``mha`` are the differentiable entries (a
``torch.autograd.Function`` each): kernels on a CUDA tensor, plain
versions on a CPU tensor. Each wrapper counts its kernel's launches in
``.launches``.

Registered ops. Where no gradient will be taken (eval, ``no_grad``,
``inference_mode``, or no input that requires one), the wrappers call the
forwards as the registered ops ``plankton::mha_qkv_fwd`` (kernel 1) and
``plankton::mha_fwd`` (kernel 3): a CUDA implementation that launches
the kernel, a CPU implementation that runs the plain version, and a fake
implementation that gives the output's shape from symbolic sizes. So
``torch.export`` records each as one opaque node, and a program exported
on the card launches the kernel when it runs; the launch counts are kept
inside the CUDA implementation. The train path keeps its
``torch.autograd.Function``.

Layout: head h's q sits at columns ``h*D``, its k at ``E + h*D`` and its v
at ``2E + h*D`` of the packed last axis (at ``h*D`` of each separate
operand). ``bias_rows`` is a (B, L) f32 additive key bias (−1e9 on padded
keys) or ``None`` for no mask. Returns (B, L, E) in the input dtype. The
bias gets no gradient: the module builds it from the padding mask, and the
JAX module drops its cotangent too.

Head dims. The kernels are instantiated for every multiple of 8 up to
256, of 64 up to 512 and of 128 up to ``MAX_HEAD_DIM`` = 1,024
(``KERNEL_HEAD_DIMS``), in six libraries by range
(``build.ATTENTION_RANGES``); above 256 they read q's (or K's and V's)
fragments from device memory where they use them, with the same values
and rounding points. Another head dim up to 1,024 takes the padding route
(``pad_heads``): the operands are copied into heads of the next
instantiated head dim (``kernel_head_dim``: 20 → 24, 300 → 320, 600
→ 640), zero in
the new columns, which change no q·kᵀ and give zero output and gradient
columns; the scale stays ``1/sqrt(d)`` of the true d, the dropout bits are
those of (sample, head, row, key) as before, and the outputs are sliced
back (``unpad_heads``). A head dim above 1,024 is refused before any
launch: the wide library's instances stop there (the backward's
shared-memory chunk is down to 48 keys at 1,024), a bound of the port's
own; JAX's Pallas kernel is bound by its VMEM instead.

Lengths. ``MAX_LENGTH`` (65,535) keeps the dropout counter ``r*L + j``
within 32 bits; the kernels stream longer rows through shared memory.
JAX's kernel holds a head's (L, L) scores in VMEM, so it cannot take such
lengths either.

Dropout. The TPU kernel draws its mask from the TPU PRNG, which has no
counterpart here; both kernels and the plain versions draw it instead from
a counter-based hash of (seed, sample, head, query row, key)
(``dropout_bits``), so the forward and the backward regenerate the same
mask with nothing stored, and kernel and plain version agree bit for bit
on it. A probability is kept when its 32 hash bits are >= ``p * 2**32``,
then scaled by ``1 / (1 - p)`` before the bf16 rounding, as at
``attention.py:387-391``.

The JAX ``mha_core`` draws one PRNG stream per (sample, head) when
unstacked and one per sample when stacked; both are TPU bits, and here
both routes draw the same hashed bits as ``mha_qkv``. Not ported (TPU
machinery): the lane-mask head mode (``narrow=False``; the module never
takes it), the block_b / bf16-softmax probe knobs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build

__all__ = ["mha_qkv", "mha_qkv_bwd", "mha_qkv_reference",
           "mha_qkv_bwd_reference", "mha", "mha_bwd", "mha_reference",
           "mha_bwd_reference", "hash_bits", "dropout_bits",
           "dropout_threshold", "keep_factor", "MAX_HEAD_DIM",
           "KERNEL_HEAD_DIMS", "MAX_LENGTH", "mha_qkv_fwd_op", "mha_fwd_op",
           "kernel_head_dim", "pad_heads", "unpad_heads"]

#: the largest head dim the CUDA kernels take (csrc/attention_*.cuh)
MAX_HEAD_DIM = build.ATTENTION_RANGES[-1][1]
#: head dims the CUDA kernels are instantiated for, in the libraries of
#: build.ATTENTION_RANGES: every multiple of 8 up to 256, of 64 up to 512,
#: of 128 up to MAX_HEAD_DIM; the others up to it are padded to the next
KERNEL_HEAD_DIMS = tuple(d for lo, hi, step in build.ATTENTION_RANGES
                         for d in range(lo, hi + 1, step))
#: the longest sequence the kernels take: the dropout counter r*L + j of
#: csrc/dropout.cuh is 32 bits (the forward and the backward stream longer
#: rows through shared memory)
MAX_LENGTH = 65535

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the constant is
    split into 16-bit halves so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser (``fmix32`` in the kernels)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_bits(seed: int, keys: int, counters: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """``csrc/dropout.cuh``'s 32 bits for every (key, counter), (keys,
    counters) int64 in [0, 2**32): ``fmix32(k ^ fmix32(counter + 1))`` with
    ``k = fmix32(seed ^ fmix32(key + 1))``."""
    key = torch.arange(keys, dtype=torch.int64, device=device)
    key = _fmix32((seed & _MASK32) ^ _fmix32(key + 1))
    idx = torch.arange(counters, dtype=torch.int64, device=device)
    return _fmix32(key[:, None] ^ _fmix32(idx + 1)[None, :])


def dropout_bits(seed: int, batch: int, heads: int, length: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """The attention kernels' bits per probability, (B, H, L, L): key
    ``b*H + h``, counter ``r*L + j``."""
    return hash_bits(seed, batch * heads, length * length,
                     device).reshape(batch, heads, length, length)


def dropout_threshold(p: float) -> int:
    """Keep a probability when its bits are >= this (0 keeps all)."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    return min(round(p * 2.0 ** 32), _MASK32)


def keep_factor(bits: torch.Tensor, p: float) -> torch.Tensor:
    """keep * 1/(1-p) as f32, the factor the kernels apply: kept where the
    bits are >= ``dropout_threshold(p)``."""
    return (bits >= dropout_threshold(p)).float() * (1.0 / (1.0 - p))


def _keep_scale(seed: int, p: float, b: int, heads: int, l: int,
                device) -> torch.Tensor:
    """The factor of (B, H, L, L) attention probabilities."""
    return keep_factor(dropout_bits(seed, b, heads, l, device), p)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, l, e3 = qkv.shape
    d = e3 // (3 * heads)
    x = qkv.float().reshape(b, l, 3, heads, d)
    return [x[:, :, i].transpose(1, 2) for i in range(3)]  # (B, H, L, D)


def _scale(d: int, scale: Optional[float]) -> float:
    """The softmax's scale: 1/√d of the operands' head dim unless given
    (the padding route's plain composition passes the true head dim's)."""
    return 1.0 / math.sqrt(d) if scale is None else scale


def _softmax_f32(q, k, bias_rows, scale):
    z = (q @ k.transpose(-1, -2)) * scale
    if bias_rows is not None:
        z = z + bias_rows.float()[:, None, None, :]
    z = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return z / z.sum(dim=-1, keepdim=True)


def mha_qkv_reference(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
                      heads: int, dropout_p: float = 0.0,
                      seed: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's numerics: f32 scores from
    the input-dtype operands, f32 softmax, the dropout factor, probabilities
    rounded to the input dtype before P·V, P·V accumulated in f32 and
    rounded on return. In f32 every rounding is the identity (the JAX
    einsum path). Differentiable by autograd (the plain model path).
    ``scale``: the scores' scale, 1/√D of qkv's head dim by default."""
    b, l, e3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    p = _softmax_f32(q, k, bias_rows, _scale(q.shape[-1], scale))
    if dropout_p > 0.0:
        p = p * _keep_scale(seed, dropout_p, b, heads, l, qkv.device)
    o = p.to(qkv.dtype).float() @ v
    return o.transpose(1, 2).reshape(b, l, e3 // 3).to(qkv.dtype)


def mha_qkv_bwd_reference(qkv: torch.Tensor,
                          bias_rows: Optional[torch.Tensor],
                          dout: torch.Tensor, heads: int,
                          dropout_p: float = 0.0,
                          seed: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the backward kernel, after
    ``_bwd_kernel_stacked_qkv``: recomputed f32 softmax; dP = dO·Vᵀ in f32
    with the dropout factor; dZ = P∘(dP − Σ dP∘P); dS = dZ·scale and the
    dropped P rounded to the input dtype before the three products, which
    accumulate in f32. Returns the packed (B, L, 3E) dqkv in the input
    dtype. ``scale`` as ``mha_qkv_reference``'s."""
    b, l, e3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    d = q.shape[-1]
    scale = _scale(d, scale)
    do = dout.to(qkv.dtype).float().reshape(b, l, heads, d).transpose(1, 2)
    p = _softmax_f32(q, k, bias_rows, scale)
    dp = do @ v.transpose(-1, -2)
    pd = p
    if dropout_p > 0.0:
        factor = _keep_scale(seed, dropout_p, b, heads, l, qkv.device)
        pd, dp = p * factor, dp * factor
    dz = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (dz * scale).to(qkv.dtype).float()
    pd = pd.to(qkv.dtype).float()
    parts = (ds @ k, ds.transpose(-1, -2) @ q, pd.transpose(-1, -2) @ do)
    dqkv = torch.stack([t.transpose(1, 2) for t in parts], dim=2)
    return dqkv.reshape(b, l, e3).to(qkv.dtype)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias_rows: Optional[torch.Tensor], heads: int,
                  dropout_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain version of kernel 3: ``mha_qkv_reference`` on q|k|v, the
    same numerics and dropout bits (separate operands change no sum)."""
    return mha_qkv_reference(torch.cat([q, k, v], dim=-1), bias_rows, heads,
                             dropout_p, seed)


def mha_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias_rows: Optional[torch.Tensor], dout: torch.Tensor,
                      heads: int, dropout_p: float = 0.0, seed: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 4: (dq, dk, dv), each (B, L, E) in the input
    dtype, from ``mha_qkv_bwd_reference`` on q|k|v."""
    dqkv = mha_qkv_bwd_reference(torch.cat([q, k, v], dim=-1), bias_rows,
                                 dout, heads, dropout_p, seed)
    return tuple(dqkv.chunk(3, dim=-1))


_SCALARS = (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_uint,
                                  ctypes.c_uint, ctypes.c_float)


def _declare(fn, n_ptr: int) -> None:
    """``fn``(n_ptr pointers, B, L, H, D, scale, seed, thr, inv_keep,
    stream) -> cudaError_t."""
    fn.argtypes = [ctypes.c_void_p] * n_ptr + list(_SCALARS) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


@functools.cache
def _fwd_lib(d: int = 64) -> ctypes.CDLL:
    """The forward's library that holds head dim ``d`` of
    ``KERNEL_HEAD_DIMS``."""
    lib = build.load(build.attention_unit("fwd", d))
    _declare(lib.mha_qkv_fwd_bf16, 3)
    _declare(lib.mha_fwd_bf16, 5)
    return lib


@functools.cache
def _bwd_lib(d: int = 64) -> ctypes.CDLL:
    lib = build.load(build.attention_unit("bwd", d))
    _declare(lib.mha_qkv_bwd_bf16, 5)
    _declare(lib.mha_bwd_bf16, 9)
    return lib


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run for a true head dim ``d``: the least
    of ``KERNEL_HEAD_DIMS`` at or above it (the next multiple of 8 up to
    256, of 64 up to 512, of 128 above). Raises past ``MAX_HEAD_DIM``."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above the kernels' limit "
                         f"MAX_HEAD_DIM={MAX_HEAD_DIM} (the widest "
                         f"instance of csrc/attention_*.cuh)")
    return next(k for k in KERNEL_HEAD_DIMS if k >= d)


def pad_heads(x: torch.Tensor, parts: int, heads: int, d: int
              ) -> torch.Tensor:
    """``x`` (B, L, parts·heads·d) as (B, L, parts·heads·dk), dk =
    ``kernel_head_dim(d)``: each head's d columns first, zeros after."""
    dk = kernel_head_dim(d)
    if dk == d:
        return x
    b, l, _ = x.shape
    out = x.new_zeros((b, l, parts, heads, dk))
    out[..., :d] = x.reshape(b, l, parts, heads, d)
    return out.reshape(b, l, parts * heads * dk)


def unpad_heads(x: torch.Tensor, parts: int, heads: int, d: int
                ) -> torch.Tensor:
    """The inverse of ``pad_heads``: each head's first d columns, as a
    contiguous (B, L, parts·heads·d)."""
    dk = kernel_head_dim(d)
    if dk == d:
        return x
    b, l, _ = x.shape
    return x.reshape(b, l, parts, heads, dk)[..., :d].reshape(
        b, l, parts * heads * d)


def _check_cuda_args(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
                     heads: int, parts: int = 3) -> int:
    """Validate what the kernels take; return the head dim. ``parts``: 3
    for a packed q|k|v, 1 for one of separate q, k, v."""
    what = "qkv" if parts == 3 else "q, k and v"
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bf16 {what}, got "
                        f"{qkv.dtype} (f32 models use the plain version)")
    if qkv.dim() != 3 or qkv.shape[2] % (parts * heads):
        raise ValueError(f"{what} must be (B, L, {parts}E) with E divisible "
                         f"by heads={heads}, got {tuple(qkv.shape)}")
    b, l, e3 = qkv.shape
    d = e3 // (parts * heads)
    if d <= 0:
        raise ValueError(f"{what} has head dim {d}")
    kernel_head_dim(d)  # raises past MAX_HEAD_DIM
    # the kernels copy 16 bytes a thread: every row starts on a 16-byte
    # boundary when the base does and D is a multiple of 8; any other D
    # takes the padding route, whose copy is a fresh contiguous tensor
    if kernel_head_dim(d) == d and (not qkv.is_contiguous()
                                    or qkv.data_ptr() % 16):
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")
    if l > MAX_LENGTH:
        raise ValueError(f"sequence length {l} above the kernels' limit "
                         f"MAX_LENGTH={MAX_LENGTH}")
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


def _check_device(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {t.device}")
    return False


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels copy 16 bytes a
    thread with ``cp.async``): a fresh copy where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


#: the backward's largest shared-memory chunk (head dims up to 64; fewer
#: keys above): up to its own chunk's length its query-side kernel hands
#: the dropout mask to its key-side kernel (kChunk in
#: csrc/attention_bwd.cuh)
BWD_CHUNK = 256


def bwd_scratch(b: int, l: int, heads: int, dropout_p: float,
                device) -> torch.Tensor:
    """The backward's scratch, written by its query-side kernel and read by
    its key-side kernel (``csrc/attention_bwd.cuh``): (max, sum, 1/sum,
    delta) of every (sample, head, query row) as f32, then, with dropout
    and L <= ``BWD_CHUNK``, the keep bits of every 16 x 16 tile of
    probabilities (8 words a tile)."""
    words = 4 * b * heads * l
    if dropout_threshold(dropout_p) and l <= BWD_CHUNK:
        words += 8 * b * heads * (-(-l // 16)) ** 2
    return torch.empty(words, dtype=torch.float32, device=device)


def _launch_args(qkv, bias_rows, heads, dropout_p, seed, parts: int = 3):
    """(B, L, H, the kernels' head dim, the scale of the true head dim,
    seed, threshold, 1 / (1 - p)): what every entry point takes."""
    d = _check_cuda_args(qkv, bias_rows, heads, parts)
    b, l, _ = qkv.shape
    return (b, l, heads, kernel_head_dim(d), 1.0 / math.sqrt(d),
            seed & _MASK32, dropout_threshold(dropout_p),
            1.0 / (1.0 - dropout_p))


def _fwd(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor], heads: int,
         dropout_p: float, seed: int) -> torch.Tensor:
    """Forward kernel on CUDA, plain version on the CPU."""
    if _check_device(qkv):
        return mha_qkv_reference(qkv, bias_rows, heads, dropout_p, seed)
    args = _launch_args(qkv, bias_rows, heads, dropout_p, seed)
    b, l, e3 = qkv.shape
    d, dk = e3 // (3 * heads), args[3]
    qkv = pad_heads(qkv, 3, heads, d)
    out = torch.empty((b, l, heads * dk), dtype=qkv.dtype,
                      device=qkv.device)
    lib = _fwd_lib(dk)
    with torch.cuda.device(qkv.device):
        err = lib.mha_qkv_fwd_bf16(
            qkv.data_ptr(),
            None if bias_rows is None else bias_rows.data_ptr(),
            out.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "attention_fwd")
    mha_qkv.launches += 1
    return unpad_heads(out, 1, heads, d)


def mha_qkv_bwd(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
                dout: torch.Tensor, heads: int, dropout_p: float = 0.0,
                seed: int = 0) -> torch.Tensor:
    """Packed dqkv: the backward kernel on CUDA, the plain version on the
    CPU, an error otherwise. ``mha_qkv_bwd.launches`` counts launches: one
    a call, though a call runs two device kernels (query side, then key
    side)."""
    if _check_device(qkv):
        return mha_qkv_bwd_reference(qkv, bias_rows, dout, heads, dropout_p,
                                     seed)
    args = _launch_args(qkv, bias_rows, heads, dropout_p, seed)
    dout = _aligned(dout.to(qkv.dtype))
    if dout.shape != (qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3):
        raise ValueError(f"dout must be (B, L, E), got {tuple(dout.shape)}")
    d, dk = qkv.shape[2] // (3 * heads), args[3]
    qkv, dout = pad_heads(qkv, 3, heads, d), pad_heads(dout, 1, heads, d)
    dqkv = torch.empty_like(qkv)
    scratch = bwd_scratch(qkv.shape[0], qkv.shape[1], heads, dropout_p,
                          qkv.device)
    lib = _bwd_lib(dk)
    with torch.cuda.device(qkv.device):
        err = lib.mha_qkv_bwd_bf16(
            qkv.data_ptr(),
            None if bias_rows is None else bias_rows.data_ptr(),
            dout.data_ptr(), dqkv.data_ptr(), scratch.data_ptr(), *args,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "attention_bwd")
    mha_qkv_bwd.launches += 1
    return unpad_heads(dqkv, 3, heads, d)


class _MhaQkv(torch.autograd.Function):
    """Forward saves qkv, the bias and the seed; backward regenerates the
    softmax and the dropout mask and returns the packed dqkv."""

    @staticmethod
    def forward(ctx, qkv, bias_rows, heads, dropout_p, seed):
        ctx.save_for_backward(qkv, bias_rows)
        ctx.args = (heads, dropout_p, seed)
        return _fwd(qkv, bias_rows, heads, dropout_p, seed)

    @staticmethod
    def backward(ctx, dout) -> Tuple[Optional[torch.Tensor], ...]:
        qkv, bias_rows = ctx.saved_tensors
        dqkv = mha_qkv_bwd(qkv, bias_rows, dout, *ctx.args)
        return dqkv, None, None, None, None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will take a gradient through the call."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@torch.library.custom_op("plankton::mha_qkv_fwd", mutates_args=())
def mha_qkv_fwd_op(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
                   heads: int, dropout_p: float, seed: int) -> torch.Tensor:
    """Kernel 1 as a registered op: the kernel on CUDA, the plain version
    on the CPU (``_fwd``)."""
    return _fwd(qkv, bias_rows, heads, dropout_p, seed)


@mha_qkv_fwd_op.register_fake
def _(qkv, bias_rows, heads, dropout_p, seed):
    b, l, e3 = qkv.shape
    return qkv.new_empty((b, l, e3 // 3))


def mha_qkv(qkv: torch.Tensor, bias_rows: Optional[torch.Tensor],
            heads: int, dropout_p: float = 0.0,
            seed: int = 0) -> torch.Tensor:
    """Differentiable attention over packed qkv with probability dropout
    ``dropout_p`` (0 in eval mode) drawn from ``seed``: the CUDA kernels
    for a CUDA bf16 tensor, the plain versions for a CPU tensor, an error
    otherwise (no fallback). Without a gradient to take, the registered
    op ``plankton::mha_qkv_fwd``. ``mha_qkv.launches`` counts
    forward-kernel launches."""
    dropout_threshold(dropout_p)  # validates p before any launch
    _check_device(qkv)  # raises on a device with neither
    if not _needs_grad(qkv):
        return mha_qkv_fwd_op(qkv, bias_rows, heads, dropout_p, seed)
    return _MhaQkv.apply(qkv, bias_rows, heads, dropout_p, seed)


mha_qkv.launches = 0
mha_qkv_bwd.launches = 0


def _separate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias_rows: Optional[torch.Tensor], heads: int,
              dropout_p: float, seed: int):
    """Checks for kernels 3 and 4: three bf16 (B, L, E) operands of one
    shape on one card; returns the launch scalars."""
    for t in (k, v):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share shape, dtype and "
                             f"device, got {tuple(q.shape)} {q.dtype} "
                             f"{q.device} and {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
        _check_cuda_args(t, bias_rows, heads, parts=1)
    return _launch_args(q, bias_rows, heads, dropout_p, seed, parts=1)


def _mha_fwd(q, k, v, bias_rows, heads, dropout_p, seed) -> torch.Tensor:
    """Kernel 3 on CUDA, its plain version on the CPU."""
    if _check_device(q):
        return mha_reference(q, k, v, bias_rows, heads, dropout_p, seed)
    args = _separate(q, k, v, bias_rows, heads, dropout_p, seed)
    d, dk = q.shape[2] // heads, args[3]
    q, k, v = (pad_heads(t, 1, heads, d) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _fwd_lib(dk)
    with torch.cuda.device(q.device):
        err = lib.mha_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias_rows is None else bias_rows.data_ptr(),
            out.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "attention_fwd (separate q, k, v)")
    mha.launches += 1
    return unpad_heads(out, 1, heads, d)


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias_rows: Optional[torch.Tensor], dout: torch.Tensor,
            heads: int, dropout_p: float = 0.0, seed: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): kernel 4 on CUDA, the plain version on the CPU, an
    error otherwise. ``mha_bwd.launches`` counts launches, one a call (as
    ``mha_qkv_bwd``)."""
    if _check_device(q):
        return mha_bwd_reference(q, k, v, bias_rows, dout, heads, dropout_p,
                                 seed)
    args = _separate(q, k, v, bias_rows, heads, dropout_p, seed)
    dout = _aligned(dout.to(q.dtype))
    if dout.shape != q.shape:
        raise ValueError(f"dout must be (B, L, E), got {tuple(dout.shape)}")
    d, dkern = q.shape[2] // heads, args[3]
    q, k, v, dout = (pad_heads(t, 1, heads, d) for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = bwd_scratch(q.shape[0], q.shape[1], heads, dropout_p,
                          q.device)
    lib = _bwd_lib(dkern)
    with torch.cuda.device(q.device):
        err = lib.mha_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias_rows is None else bias_rows.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "attention_bwd (separate q, k, v)")
    mha_bwd.launches += 1
    return tuple(unpad_heads(t, 1, heads, d) for t in (dq, dk, dv))


class _Mha(torch.autograd.Function):
    """``_MhaQkv`` on separate q, k, v: kernels 3 and 4."""

    @staticmethod
    def forward(ctx, q, k, v, bias_rows, heads, dropout_p, seed):
        ctx.save_for_backward(q, k, v, bias_rows)
        ctx.args = (heads, dropout_p, seed)
        return _mha_fwd(q, k, v, bias_rows, heads, dropout_p, seed)

    @staticmethod
    def backward(ctx, dout) -> Tuple[Optional[torch.Tensor], ...]:
        q, k, v, bias_rows = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, bias_rows, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias_rows: Optional[torch.Tensor], heads: int,
        dropout_p: float = 0.0, seed: int = 0) -> torch.Tensor:
    """``mha_qkv`` on separate (B, L, E) q, k and v (the JAX ``mha_core``):
    kernels 3 and 4 for CUDA bf16 tensors, the plain versions for CPU
    tensors, an error otherwise. ``mha.launches`` counts forward-kernel
    launches."""
    dropout_threshold(dropout_p)  # validates p before any launch
    _check_device(q)  # raises on a device with neither
    if not _needs_grad(q, k, v):
        return mha_fwd_op(q, k, v, bias_rows, heads, dropout_p, seed)
    return _Mha.apply(q, k, v, bias_rows, heads, dropout_p, seed)


@torch.library.custom_op("plankton::mha_fwd", mutates_args=())
def mha_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias_rows: Optional[torch.Tensor], heads: int,
               dropout_p: float, seed: int) -> torch.Tensor:
    """Kernel 3 as a registered op: the kernel on CUDA, the plain version
    on the CPU (``_mha_fwd``)."""
    return _mha_fwd(q, k, v, bias_rows, heads, dropout_p, seed)


@mha_fwd_op.register_fake
def _(q, k, v, bias_rows, heads, dropout_p, seed):
    return torch.empty_like(q)


mha.launches = 0
mha_bwd.launches = 0
