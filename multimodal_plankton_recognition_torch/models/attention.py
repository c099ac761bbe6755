"""Self-attention module over the packed-QKV attention core.

Port of ``models/attention.py::FusedSelfAttention`` on its packed-QKV path:
one (E, 3E) projection, the attention core (``ops/attention.py``), then the
out projection. The projections are plain ``F.linear`` GEMMs, as XLA ran
them outside the Pallas kernel. The Flax ``query``/``key``/``value``
(E, H, D) kernels map onto ``qkv`` and ``out`` (H, D, E) onto ``out``
(``convert.py``).

Gate, as in the JAX module: a bf16 module runs the kernel wrapper
(``mha_qkv``: CUDA kernels on the card, plain versions on the CPU); an f32
module, or ``fused=False``, runs the plain composition under autograd.

In train mode the attention probabilities drop at ``dropout_rate`` with a
seed drawn per call from the step's CPU generator (``models/dropout.py``),
as the JAX module draws one per call from its ``dropout`` stream
(``models/attention.py:146-150``). Not ported (TPU machinery): the
separate-q/k/v and lane-mask kernel paths, the in-kernel projection block
(``PLANKTON_ATTN_FUSE_PROJ``), the environment probe knobs and the
shard_map kernel gating (``ops/kernels.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention import mha_qkv, mha_qkv_reference
from .dropout import attention_seed


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
        qkv = self.qkv(x)
        drop = attention_seed(self.dropout_rate, self.training)
        if self.fused and qkv.dtype == torch.bfloat16:
            o = mha_qkv(qkv, bias, self.num_heads, *drop)
        else:
            o = mha_qkv_reference(qkv, bias, self.num_heads, *drop)
        return self.out(o)
