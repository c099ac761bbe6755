"""Self-attention module over the attention cores of ``ops/attention.py``.

Port of ``models/attention.py::FusedSelfAttention``. Its default route is
the packed-QKV one: one (E, 3E) projection, the attention core on the
packed operand (``mha_qkv``, kernels 1 and 2), then the out projection.
When ``PLANKTON_ATTN_QKV_PACKED`` or ``PLANKTON_ATTN_STACKED`` is set to
anything but ``"1"`` (read at every forward, as the JAX module reads them
at trace time, ``attention.py:82-98, :154-155``), it takes the unpacked
route instead: q, k and v as three projections over the row blocks of the
same ``qkv`` weight and bias, the core on separate operands (``mha``,
kernels 3 and 4), then ``out`` (``attention.py:186-195``). The
projections are plain ``F.linear`` GEMMs, as XLA ran them outside the
Pallas kernel. The Flax ``query``/``key``/``value`` (E, H, D) kernels map
onto ``qkv`` and ``out`` (H, D, E) onto ``out`` (``convert.py``), on both
routes.

Gate, as in the JAX module: a bf16 module runs the kernel wrappers (CUDA
kernels on the card, plain versions on the CPU); an f32 module, or
``fused=False``, runs the plain composition under autograd.

In train mode the attention probabilities drop at ``dropout_rate`` with a
seed drawn per call from the step's CPU generator (``models/dropout.py``),
as the JAX module draws one per call from its ``dropout`` stream
(``models/attention.py:146-150``). Not ported (TPU machinery): the
lane-mask kernel mode, the in-kernel projection block
(``PLANKTON_ATTN_FUSE_PROJ``), the ``PLANKTON_ATTN_BLOCK_B`` and
``PLANKTON_SOFTMAX_BF16`` probe knobs and the shard_map kernel gating
(``ops/kernels.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha, mha_qkv, mha_qkv_reference, mha_reference
from .dropout import kernel_seed


def _qkv_packed() -> bool:
    """The packed-QKV route, unless ``PLANKTON_ATTN_QKV_PACKED`` or
    ``PLANKTON_ATTN_STACKED`` is set to anything but "1" (the JAX
    module's reading of both variables)."""
    return all(os.environ.get(v, "1") == "1"
               for v in ("PLANKTON_ATTN_QKV_PACKED", "PLANKTON_ATTN_STACKED"))


class FusedSelfAttention(nn.Module):
    """``mask_rows``: optional (B, L) bool, True = key is padding; turned
    into a −1e9 additive pre-softmax key bias."""

    def __init__(self, dim: int, num_heads: int, fused: bool = True,
                 dropout_rate: float = 0.0) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"num_heads={num_heads} must divide "
                             f"features={dim}")
        self.num_heads = num_heads
        self.fused = fused
        self.dropout_rate = dropout_rate
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        bias = None if mask_rows is None else torch.where(
            mask_rows, -1e9, 0.0).to(torch.float32)
        drop = kernel_seed(self.dropout_rate, self.training)
        kernel = self.fused and x.dtype == torch.bfloat16
        if _qkv_packed():
            qkv = self.qkv(x)
            core = mha_qkv if kernel else mha_qkv_reference
            o = core(qkv, bias, self.num_heads, *drop)
        else:
            q, k, v = (F.linear(x, w, b) for w, b in zip(
                self.qkv.weight.chunk(3), self.qkv.bias.chunk(3)))
            core = mha if kernel else mha_reference
            o = core(q, k, v, bias, self.num_heads, *drop)
        return self.out(o)
