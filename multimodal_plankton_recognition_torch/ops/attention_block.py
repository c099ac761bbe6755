"""The fused attention block: QKV projections, multi-head self-attention
with probability dropout and the out projection as one core, and its
backward.

Port of ``multimodal_plankton_recognition_tpu/ops/pallas/experimental/
attention_block.py``: the TPU kernels ``_fwd_kernel`` (kernel 11) and
``_bwd_kernel`` (kernel 12) become the entry points ``attn_block_fwd`` and
``attn_block_bwd`` of ``csrc/attention_block.cu``. ``attn_block_reference``
and ``attn_block_bwd_reference`` are their plain PyTorch versions, with the
TPU kernels' rounding points (``attention_block.py:55-99, :116-185``):

* forward: ``q|k|v = r(x·Wᵀ + b)`` with f32 accumulation and the f32 bias
  added before the one rounding ``r`` to x's dtype (the packed route
  rounds twice: the GEMM, then the bias); per head ``p = softmax_f32(q_h ·
  k_hᵀ/√D + bias)``, dropout, ``o_h = r(p)·v_h`` in f32; ``y = r(o)·Woᵀ +
  bo`` in f32, cast once to x's dtype;
* backward, dy rounded to x's dtype: ``do = r(dy·Wo)``; per head ``dz =
  p(dp − Σ dp·p)``, ``ds = r(dz/√D)``, dq, dk, dv rounded (the math of
  ``mha_qkv_bwd_reference``); ``dWo = dyᵀ·r(o)``, ``dbo = Σ dy``; ``dWqkv =
  dqkvᵀ·x``, ``dbqkv = Σ dqkv`` in f32 over every row; ``dx = dqkv·Wqkv``
  in f32, rounded once. The bias gets no gradient (it comes from the
  padding mask), as kernels 2 and 4 leave it out.

Weights in the port's own layout: ``qkv_weight`` (3E, E) with the q, k
and v row blocks, ``qkv_bias`` (3E,), ``out_weight`` (E, E) as
``nn.Linear`` holds it (y = o·out_weightᵀ), ``out_bias`` (E,); the JAX
kernel's (E, E) ``wq``... are their transposed blocks. ``bias_rows`` is a
(B, L) f32 key bias (−1e9 on padded keys) or ``None``. Dropout draws the
attention kernels' counter-hash bits (``ops.attention.dropout_bits``), so
the same seed gives kernel 11 the mask of kernel 1.

``attn_block`` is the differentiable entry (a ``torch.autograd.Function``):
the kernels for a CUDA tensor, the plain versions for a CPU tensor, an
error otherwise; it returns the weight gradients in the parameters'
dtype. When a gradient will be taken, the forward keeps its q|k|v and o
(``attn_block_fwd(..., keep=True)``) and the backward takes them
(``attn_block_bwd(..., qkv=, o=)``); given neither, the backward rebuilds
them, with the same bits, as the TPU kernel does.
``attn_block_fwd.launches`` and ``attn_block_bwd.launches`` count kernel
launches (one per wrapper call, whatever number of passes it runs).
Where no gradient will be taken, ``attn_block`` calls the forward as the
registered op ``plankton::attn_block_fwd`` (CUDA: kernel 11; CPU: the
plain version; a fake implementation for symbolic sizes), so that
``torch.export`` keeps kernel 11 as one node (``ops/attention.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build, hopper_gemm
from .attention import (_MASK32, _aligned, _needs_grad, bwd_scratch,
                        dropout_threshold, mha_qkv_bwd_reference,
                        mha_qkv_reference)

__all__ = ["attn_block", "attn_block_fwd", "attn_block_bwd",
           "attn_block_reference", "attn_block_bwd_reference",
           "attn_block_fwd_op", "SUPPORTED_BLOCKS"]

#: (E, heads) the CUDA kernels are instantiated for: ViT-T, the flagship's
#: profile encoder, ViT-S and the SigLIP card's profile encoder
SUPPORTED_BLOCKS = ((192, 3), (192, 8), (384, 6), (128, 4))
BF16 = torch.bfloat16


def _project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``x·wᵀ + b`` from x and w in ``dtype``, f32 accumulation and f32
    bias, one rounding to ``dtype``."""
    return (x.to(dtype).float() @ w.to(dtype).float().T
            + b.float()).to(dtype)


def attn_block_reference(x: torch.Tensor, qkv_weight: torch.Tensor,
                         qkv_bias: torch.Tensor, out_weight: torch.Tensor,
                         out_bias: torch.Tensor,
                         bias_rows: Optional[torch.Tensor], heads: int,
                         dropout_p: float = 0.0, seed: int = 0,
                         keep: bool = False):
    """Plain version of kernel 11: y (B, L, E) in x's dtype; with ``keep``,
    (y, q|k|v (B, L, 3E), o (B, L, E)), the residuals the backward
    takes."""
    qkv = _project(x, qkv_weight, qkv_bias, x.dtype)
    o = mha_qkv_reference(qkv, bias_rows, heads, dropout_p, seed)
    y = _project(o, out_weight, out_bias, x.dtype)
    return (y, qkv, o) if keep else y


def attn_block_bwd_reference(x: torch.Tensor, qkv_weight: torch.Tensor,
                             qkv_bias: torch.Tensor,
                             out_weight: torch.Tensor,
                             out_bias: torch.Tensor,
                             bias_rows: Optional[torch.Tensor],
                             dy: torch.Tensor, heads: int,
                             dropout_p: float = 0.0, seed: int = 0,
                             qkv: Optional[torch.Tensor] = None,
                             o: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain version of kernel 12: (dx in x's dtype, d qkv_weight (3E, E),
    d qkv_bias (3E,), d out_weight (E, E), d out_bias (E,) in f32). Takes
    the forward's q|k|v and o when given (both or neither), else rebuilds
    them."""
    dt = x.dtype
    b, l, e = x.shape
    _check_residuals(qkv, o)
    if qkv is None:
        qkv = _project(x, qkv_weight, qkv_bias, dt)
        o = mha_qkv_reference(qkv, bias_rows, heads, dropout_p, seed)
    dyf = dy.to(dt).float().reshape(-1, e)
    do = (dyf @ out_weight.to(dt).float()).to(dt).reshape(b, l, e)
    dqkv = mha_qkv_bwd_reference(qkv, bias_rows, do, heads, dropout_p, seed)
    g = dqkv.float().reshape(-1, 3 * e)
    dx = (g @ qkv_weight.to(dt).float()).to(dt).reshape(b, l, e)
    return (dx, g.T @ x.float().reshape(-1, e), g.sum(0),
            dyf.T @ o.float().reshape(-1, e), dyf.sum(0))


def _check_residuals(qkv: Optional[torch.Tensor],
                     o: Optional[torch.Tensor]) -> None:
    if (qkv is None) != (o is None):
        raise ValueError("give the backward both q|k|v and o, or neither")


# ---------------------------------------------------------------------------
# the kernels: csrc/attention_block.cu
# ---------------------------------------------------------------------------

_SCALARS = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_float,
                                 ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    """attn_block_fwd(x, wqkv, bqkv, wo, bo, bias, qkv, o, y, B, L, H, D,
    scale, seed, thr, inv_keep, stream); attn_block_bwd(x, wqkv, bqkv, wo,
    bias, dy, qkv, o, recompute, do, dqkv, dx, dwqkv, dbqkv, dwo, dbo,
    part, scratch, groups_qkv, groups_out, B, L, H, D, scale, seed, thr,
    inv_keep, stream). Both return a cudaError_t."""
    lib = build.load("attention_block")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.attn_block_fwd.argtypes = [vp] * 9 + _SCALARS
    lib.attn_block_fwd.restype = ci
    lib.attn_block_bwd.argtypes = [vp] * 8 + [ci] + [vp] * 9 + [ci, ci] \
        + _SCALARS
    lib.attn_block_bwd.restype = ci
    return lib


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no attention-block kernel for device {x.device}")
    return False


def _prep(x, qkv_weight, qkv_bias, out_weight, out_bias, bias_rows, heads,
          dropout_p):
    """Check what the kernels take; return (x, bf16 weights, f32 biases,
    the bias rows, the launch scalars)."""
    if x.dtype != BF16 or x.dim() != 3:
        raise TypeError(f"the attention-block kernels take bf16 (B, L, E) "
                        f"x, got {tuple(x.shape)} {x.dtype} (f32 models use "
                        f"the plain version)")
    b, l, e = x.shape
    if (e, heads) not in SUPPORTED_BLOCKS:
        raise ValueError(f"(E, heads) = ({e}, {heads}) not in "
                         f"{SUPPORTED_BLOCKS}")
    if (tuple(qkv_weight.shape) != (3 * e, e) or qkv_bias.numel() != 3 * e
            or tuple(out_weight.shape) != (e, e) or out_bias.numel() != e):
        raise ValueError(f"weights must be qkv ({3 * e}, {e}) + ({3 * e},) "
                         f"and out ({e}, {e}) + ({e},), got "
                         f"{tuple(qkv_weight.shape)}, {tuple(qkv_bias.shape)}"
                         f", {tuple(out_weight.shape)}, "
                         f"{tuple(out_bias.shape)}")
    for t in (qkv_weight, qkv_bias, out_weight, out_bias):
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")
    if bias_rows is not None and (
            bias_rows.device != x.device or bias_rows.dtype != torch.float32
            or tuple(bias_rows.shape) != (b, l)):
        raise ValueError(f"bias_rows must be a ({b}, {l}) f32 tensor on "
                         f"{x.device}, got {tuple(bias_rows.shape)} "
                         f"{bias_rows.dtype} on {bias_rows.device}")
    if b > 65535 or b * l >= 2 ** 31 // (3 * e):
        raise ValueError(f"B={b}, L={l} exceed the kernels' grid or 32-bit "
                         f"indexing")
    d = e // heads

    def f32(t):
        return t.detach().reshape(-1).float().contiguous()

    return (_aligned(x), _aligned(qkv_weight.detach().to(BF16)),
            f32(qkv_bias), _aligned(out_weight.detach().to(BF16)),
            f32(out_bias),
            None if bias_rows is None else bias_rows.contiguous(),
            (b, l, heads, d, 1.0 / math.sqrt(d)),
            (dropout_threshold(dropout_p), 1.0 / (1.0 - dropout_p)))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def attn_block_fwd(x, qkv_weight, qkv_bias, out_weight, out_bias,
                   bias_rows: Optional[torch.Tensor], heads: int,
                   dropout_p: float = 0.0, seed: int = 0, keep: bool = False):
    """Kernel 11 on CUDA, the plain version on the CPU: y (B, L, E) in x's
    dtype; with ``keep``, (y, q|k|v, o), which ``attn_block_bwd`` takes
    back. ``attn_block_fwd.launches`` counts launches."""
    if _on_cpu(x):
        return attn_block_reference(x, qkv_weight, qkv_bias, out_weight,
                                    out_bias, bias_rows, heads, dropout_p,
                                    seed, keep)
    x, wqkv, bqkv, wo, bo, bias, (b, l, h, d, scale), (thr, inv_keep) = \
        _prep(x, qkv_weight, qkv_bias, out_weight, out_bias, bias_rows,
              heads, dropout_p)
    e = h * d
    qkv = torch.empty((b, l, 3 * e), dtype=BF16, device=x.device)
    o, y = torch.empty_like(x), torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.attn_block_fwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), _ptr(bias), qkv.data_ptr(), o.data_ptr(),
            y.data_ptr(), b, l, h, d, scale, seed & _MASK32, thr, inv_keep,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "attn_block_fwd")
    attn_block_fwd.launches += 1
    return (y, qkv, o) if keep else y


def _residual(t: torch.Tensor, shape, x: torch.Tensor, name: str
              ) -> torch.Tensor:
    if t.device != x.device or t.dtype != BF16 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {shape} bf16 tensor on "
                         f"{x.device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                         f"(the kernel reads the forward's own tensor)")
    return t


def attn_block_bwd(x, qkv_weight, qkv_bias, out_weight, out_bias,
                   bias_rows: Optional[torch.Tensor], dy: torch.Tensor,
                   heads: int, dropout_p: float = 0.0, seed: int = 0,
                   qkv: Optional[torch.Tensor] = None,
                   o: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Kernel 12 on CUDA, the plain version on the CPU: (dx in x's dtype,
    d qkv_weight (3E, E), d qkv_bias (3E,), d out_weight (E, E), d
    out_bias (E,) in f32). ``qkv`` and ``o``: the forward's (``keep``),
    both or neither; without them the kernel rebuilds them first, with
    the same bits. ``attn_block_bwd.launches`` counts launches."""
    if _on_cpu(x):
        return attn_block_bwd_reference(x, qkv_weight, qkv_bias, out_weight,
                                        out_bias, bias_rows, dy, heads,
                                        dropout_p, seed, qkv, o)
    _check_residuals(qkv, o)
    x, wqkv, bqkv, wo, _, bias, (b, l, h, d, scale), (thr, inv_keep) = \
        _prep(x, qkv_weight, qkv_bias, out_weight, out_bias, bias_rows,
              heads, dropout_p)
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    e = h * d
    rows = b * l
    dy = _aligned(dy.to(BF16))
    bf = functools.partial(torch.empty, dtype=BF16, device=x.device)
    f32 = functools.partial(torch.empty, dtype=torch.float32,
                            device=x.device)
    recompute = qkv is None
    if recompute:
        qkv, o = bf((b, l, 3 * e)), bf((b, l, e))
    else:
        qkv = _residual(qkv, (b, l, 3 * e), x, "qkv")
        o = _residual(o, (b, l, e), x, "o")
    sms = hopper_gemm.sm_count(x.device)
    g_qkv = hopper_gemm.wgrad_groups(rows, 3 * e, e, sms)
    g_out = hopper_gemm.wgrad_groups(rows, e, e, sms)
    dqkv, do, dx = bf((b, l, 3 * e)), bf((b, l, e)), bf((b, l, e))
    dwqkv, dbqkv, dwo, dbo = f32((3 * e, e)), f32(3 * e), f32((e, e)), f32(e)
    part = f32(g_qkv * (3 * e * e + 3 * e) + g_out * (e * e + e))
    scratch = bwd_scratch(b, l, h, dropout_p, x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.attn_block_bwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            _ptr(bias), dy.data_ptr(), qkv.data_ptr(), o.data_ptr(),
            int(recompute), do.data_ptr(), dqkv.data_ptr(), dx.data_ptr(),
            dwqkv.data_ptr(), dbqkv.data_ptr(), dwo.data_ptr(),
            dbo.data_ptr(), part.data_ptr(), scratch.data_ptr(), g_qkv,
            g_out, b, l, h, d, scale, seed & _MASK32, thr, inv_keep,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "attn_block_bwd")
    attn_block_bwd.launches += 1
    return dx, dwqkv, dbqkv, dwo, dbo


attn_block_fwd.launches = 0
attn_block_bwd.launches = 0


class _AttnBlock(torch.autograd.Function):
    """Forward: kernel 11, keeping its q|k|v and o when a gradient will be
    taken (``keep``); backward: kernel 12 on them, or, without them,
    rebuilding q, k, v, the softmax and the dropout mask from x and the
    seed, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, qkv_weight, qkv_bias, out_weight, out_bias,
                bias_rows, heads, dropout_p, seed, keep):
        ctx.args = (heads, dropout_p, seed)
        out = attn_block_fwd(x, qkv_weight, qkv_bias, out_weight, out_bias,
                             bias_rows, heads, dropout_p, seed, keep)
        y, residuals = (out[0], out[1:]) if keep else (out, ())
        ctx.save_for_backward(x, qkv_weight, qkv_bias, out_weight, out_bias,
                              bias_rows, *residuals)
        return y

    @staticmethod
    def backward(ctx, dy) -> Tuple[Optional[torch.Tensor], ...]:
        x, wqkv, bqkv, wo, bo, bias_rows, *residuals = ctx.saved_tensors
        qkv, o = residuals or (None, None)
        dx, dwqkv, dbqkv, dwo, dbo = attn_block_bwd(
            x, wqkv, bqkv, wo, bo, bias_rows, dy, *ctx.args, qkv=qkv, o=o)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.reshape(bqkv.shape).to(
            bqkv.dtype), dwo.to(wo.dtype), dbo.reshape(bo.shape).to(
            bo.dtype), None, None, None, None, None)


def attn_block(x: torch.Tensor, qkv_weight: torch.Tensor,
               qkv_bias: torch.Tensor, out_weight: torch.Tensor,
               out_bias: torch.Tensor, bias_rows: Optional[torch.Tensor],
               heads: int, dropout_p: float = 0.0,
               seed: int = 0) -> torch.Tensor:
    """Differentiable fused attention block over (B, L, E) ``x`` with
    probability dropout ``dropout_p`` (0 in eval mode) drawn from ``seed``
    (the JAX ``attn_block``): kernels 11 and 12 for a CUDA tensor, the
    plain versions for a CPU tensor, an error otherwise. Returns (B, L, E)
    in x's dtype. Only when a gradient will be taken (grad mode on and an
    input that requires one) does the forward keep its q|k|v and o (3 B L
    E and B L E values) for the backward; under ``no_grad`` or
    ``inference_mode`` it keeps nothing."""
    dropout_threshold(dropout_p)  # validates p before any launch
    _on_cpu(x)  # raises on a device with neither kernel nor plain version
    if not _needs_grad(x, qkv_weight, qkv_bias, out_weight, out_bias):
        return attn_block_fwd_op(x, qkv_weight, qkv_bias, out_weight,
                                 out_bias, bias_rows, heads, dropout_p, seed)
    return _AttnBlock.apply(x, qkv_weight, qkv_bias, out_weight, out_bias,
                            bias_rows, heads, dropout_p, seed, True)


@torch.library.custom_op("plankton::attn_block_fwd", mutates_args=())
def attn_block_fwd_op(x: torch.Tensor, qkv_weight: torch.Tensor,
                      qkv_bias: torch.Tensor, out_weight: torch.Tensor,
                      out_bias: torch.Tensor,
                      bias_rows: Optional[torch.Tensor], heads: int,
                      dropout_p: float, seed: int) -> torch.Tensor:
    """Kernel 11 as a registered op: the kernel on CUDA, the plain version
    on the CPU (``attn_block_fwd``)."""
    return attn_block_fwd(x, qkv_weight, qkv_bias, out_weight, out_bias,
                          bias_rows, heads, dropout_p, seed, False)


@attn_block_fwd_op.register_fake
def _(x, qkv_weight, qkv_bias, out_weight, out_bias, bias_rows, heads,
      dropout_p, seed):
    return torch.empty_like(x)
