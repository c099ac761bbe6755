"""Transformer feed-forward block over the fused FFN kernels
(``models/ffn.py`` of the JAX package).

``apply_fused_ffn`` runs Dense → activation → dropout → Dense through
``ops.ffn.ffn_core`` on the block's own ``nn.Linear`` pair, so the
parameters, their names (``mlp1`` / ``mlp2``, ``ff1`` / ``ff2``) and the
converted Flax tree are those of the unfused block. The hidden dropout
happens inside the kernel, with one seed per call drawn from the step's
generator (``models/dropout.py``), as the JAX block draws one from its
``dropout`` stream.

Gate: the JAX package runs ``ffn_core`` on a TPU whatever the model's
dtype (``ffn.py:89-97``), so an f32 card's FFN rounds through bf16 there
too; the port does the same, in both dtypes, on the card (the kernels) and
on the CPU (their plain versions). The JAX package's CPU fallback
(``ffn.py:98-107``) rounds after each op in the model dtype instead; the
tests state both comparisons. Not ported: ``apply_remat_ffn`` and its
``PLANKTON_REMAT_MLP`` knob (a recompute policy of XLA, not a kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.ffn import ffn_core
from .dropout import kernel_seed


def apply_fused_ffn(x: torch.Tensor, mlp1: nn.Linear, mlp2: nn.Linear,
                    activation: str, dropout_p: float,
                    training: bool) -> torch.Tensor:
    """Dense → ``activation`` → dropout at ``dropout_p`` (train mode
    only) → Dense over (B, L, E), in x's dtype."""
    rate, seed = kernel_seed(dropout_p, training)
    return ffn_core(x, mlp1.weight.t(), mlp1.bias, mlp2.weight.t(),
                    mlp2.bias, activation, rate, seed)
