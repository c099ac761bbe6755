"""Vision Transformer backbones (tiny/small, patch 16/32, 224 px).

Port of ``models/image/vit.py``: strided-conv patch embedding, a zero CLS
token, learned position embeddings, pre-LN blocks (attention through
``FusedSelfAttention``, a Dense → tanh-GELU → Dense MLP), a final
LayerNorm and CLS pooling. Flax defaults carried over: LayerNorm eps 1e-6
and the tanh form of GELU. Images come in the JAX layout (B, H, W, C); the
patch conv runs on an NCHW view.

Train-mode dropout at the JAX placements (``vit.py:49, :65, :67, :111``):
attention probabilities, the attention output, the MLP hidden and the MLP
output, and the embedded tokens. With ``fused_ffn`` the MLP runs through
the fused FFN kernels (``models/ffn.py``), its hidden dropout inside them;
the parameters stay ``mlp1`` / ``mlp2``. Not ported: the remat-MLP probe
of the JAX block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import LN_EPS
from ..attention import FusedSelfAttention
from ..dropout import dropout
from ..ffn import apply_fused_ffn


class _Block(nn.Module):
    """Pre-LN transformer block: x += MHA(LN(x)); x += MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dropout: float, fused_attention: bool,
                 fused_ffn: bool) -> None:
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.dropout = dropout
        self.fused_ffn = fused_ffn
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = FusedSelfAttention(dim, num_heads, fused=fused_attention,
                                       dropout_rate=dropout)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp1 = nn.Linear(dim, hidden)
        self.mlp2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._drop(self.attn(self.ln1(x)))
        if self.fused_ffn:
            h = apply_fused_ffn(self.ln2(x), self.mlp1, self.mlp2, "gelu",
                                self.dropout, self.training)
        else:
            h = F.gelu(self.mlp1(self.ln2(x)), approximate="tanh")
            h = self.mlp2(self._drop(h))
        return x + self._drop(h)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.dropout, self.training)


class ViT(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 192,
                 depth: int = 12, num_heads: int = 3, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, in_chans: int = 1, img_size: int = 224,
                 fused_attention: bool = False,
                 fused_ffn: bool = False) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout = dropout
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size,
                                     stride=patch_size)
        n_tokens = (img_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            _Block(embed_dim, num_heads, mlp_ratio, dropout, fused_attention,
                   fused_ffn)
            for _ in range(depth))
        self.ln_final = nn.LayerNorm(embed_dim, eps=LN_EPS)

    @property
    def num_features(self) -> int:
        return self.embed_dim

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (B, H, W, C) channel-last; returns the CLS feature (B, D)."""
        x = image.to(self.pos_embed.dtype).permute(0, 3, 1, 2)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, h*w, D)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = dropout(x, self.dropout, self.training)
        for block in self.blocks:
            x = block(x)
        return self.ln_final(x)[:, 0]


def _vit(kw, **defaults) -> ViT:
    # defaults yield to caller kwargs (backbone_kwargs shrink the model)
    return ViT(**{**defaults, **kw})


def vit_tiny_patch16_224(**kw) -> ViT:
    return _vit(kw, patch_size=16, embed_dim=192, depth=12, num_heads=3)


def vit_small_patch16_224(**kw) -> ViT:
    return _vit(kw, patch_size=16, embed_dim=384, depth=12, num_heads=6)


def vit_small_patch32_224(**kw) -> ViT:
    return _vit(kw, patch_size=32, embed_dim=384, depth=12, num_heads=6)
