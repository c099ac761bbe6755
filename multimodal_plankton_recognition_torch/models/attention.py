"""Self-attention module over the attention cores of ``ops/attention.py``
and ``ops/attention_block.py``.

Port of ``models/attention.py::FusedSelfAttention`` and, for
``fused=False``, of flax ``nn.MultiHeadDotProductAttention``, which the
JAX encoders use when ``fused_attention`` is off (``models/image/
vit.py:38-48``, ``models/profile/transformer.py:53-69``). Both keep one
parameter tree: a (3E, E) ``qkv`` Linear (q|k|v row blocks) and an (E, E)
``out`` Linear, onto which the Flax ``query``/``key``/``value`` (E, H, D)
and ``out`` (H, D, E) kernels map (``convert.py``).

Routes of a ``fused`` module, chosen at every forward in the JAX module's
order (``attention.py:153-195``):

1. the fused block, when ``PLANKTON_ATTN_FUSE_PROJ`` is "1" (the JAX
   module's ``_fuse_proj_enabled``, ``attention.py:197-202``; its
   ``fuse_projections`` attribute has no port, nothing sets it): the QKV
   projections, the attention and the out projection in one core,
   ``attn_block`` (kernels 11 and 12);
2. the packed-QKV route (the default): one (E, 3E) projection, the core on
   the packed operand (``mha_qkv``, kernels 1 and 2), then ``out``;
3. the unpacked route, when ``PLANKTON_ATTN_QKV_PACKED`` or
   ``PLANKTON_ATTN_STACKED`` is set to anything but "1"
   (``attention.py:82-98``): q, k and v as three projections over the row
   blocks of ``qkv``, the core on separate operands (``mha``, kernels 3
   and 4), then ``out``.

Gate, as in the JAX module: a bf16 module runs the kernel wrappers (CUDA
kernels on the card, plain versions on the CPU); an f32 module runs the
plain composition of routes 2-3 under autograd, with its per-element
dropout (JAX's ``_einsum_fallback``), and ignores the fused block, as JAX
does when its kernel gate is closed. Projections outside a core are plain
``F.linear`` GEMMs, as XLA ran them outside the Pallas kernel.

``fused=False`` has flax's semantics in every dtype (``flax/linen/
attention.py::dot_product_attention_weights``, flax 0.12.3): q scaled by
``1/√D`` in the module dtype before ``q·kᵀ``, padded keys set to the
dtype's most negative value, the softmax in the module dtype, and in train
mode one (L, L) keep mask per call shared by every sample and head
(``broadcast_dropout=True``), its multiplier in the module dtype.

In train mode the kernel routes drop attention probabilities at
``dropout_rate`` with a seed drawn per call from the step's CPU generator
(``models/dropout.py``), as the JAX module draws one per call from its
``dropout`` stream (``models/attention.py:146-150``). Not ported (TPU
machinery): the lane-mask kernel mode, the ``PLANKTON_ATTN_BLOCK_B`` and
``PLANKTON_SOFTMAX_BF16`` probe knobs and the shard_map kernel gating
(``ops/kernels.py``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha, mha_qkv, mha_qkv_reference, mha_reference
from ..ops.attention_block import attn_block
from .dropout import kernel_seed, keep_mask


def _qkv_packed() -> bool:
    """The packed-QKV route, unless ``PLANKTON_ATTN_QKV_PACKED`` or
    ``PLANKTON_ATTN_STACKED`` is set to anything but "1" (the JAX
    module's reading of both variables)."""
    return all(os.environ.get(v, "1") == "1"
               for v in ("PLANKTON_ATTN_QKV_PACKED", "PLANKTON_ATTN_STACKED"))


def _fuse_projections() -> bool:
    """The fused-block route, when ``PLANKTON_ATTN_FUSE_PROJ`` is "1"."""
    return os.environ.get("PLANKTON_ATTN_FUSE_PROJ") == "1"


class FusedSelfAttention(nn.Module):
    """``mask_rows``: optional (B, L) bool, True = key is padding; the
    kernel routes turn it into a −1e9 additive pre-softmax key bias."""

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
        if not self.fused:
            return self._flax(x, mask_rows)
        bias = None if mask_rows is None else torch.where(
            mask_rows, -1e9, 0.0).to(torch.float32)
        drop = kernel_seed(self.dropout_rate, self.training)
        kernel = x.dtype == torch.bfloat16
        if kernel and _fuse_projections():
            return attn_block(x, self.qkv.weight, self.qkv.bias,
                              self.out.weight, self.out.bias, bias,
                              self.num_heads, *drop)
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

    def _flax(self, x: torch.Tensor,
              mask_rows: Optional[torch.Tensor]) -> torch.Tensor:
        """flax ``MultiHeadDotProductAttention`` on ``x`` as q, k and v:
        every step in x's dtype, as ``dot_product_attention`` runs it."""
        b, l, e = x.shape
        h = self.num_heads
        dt = x.dtype
        q, k, v = (t.reshape(b, l, h, e // h)
                   for t in self.qkv(x).chunk(3, dim=-1))
        # query / jnp.sqrt(depth).astype(dtype)
        q = q / torch.tensor(math.sqrt(e // h), dtype=torch.float32,
                             device=x.device).to(dt)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask_rows is not None:
            s = torch.where(mask_rows[:, None, None, :],
                            torch.finfo(dt).min, s)
        # jax.nn.softmax in dt: exp(s - max) / sum, each op rounded to dt
        s = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = s / s.sum(dim=-1, keepdim=True)
        if self.training and self.dropout_rate > 0.0:
            keep = keep_mask((l, l), self.dropout_rate, x.device, dt)
            p = p * (keep / torch.tensor(1.0 - self.dropout_rate, dtype=dt,
                                         device=x.device))
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, l, e)
        return self.out(o)
