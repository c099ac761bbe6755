"""The two flagships and their synthetic batches (``models/flagships.py``
of the JAX package): EfficientNet-B0 + ProfileCNN and ViT-T/16 +
ProfileTransformer, each with the CLIP head; plus a seeded random
initialisation for runs without a checkpoint."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .image.vit import ViT
from .multi import MultiModel


def flagship_b0(dim_embed: int = 512, fused_loss: bool = True,
                dropout: Optional[float] = None,
                dtype: torch.dtype = torch.bfloat16) -> MultiModel:
    """EfficientNet-B0 + ProfileCNN (blocks 2-2-2-2, 32 base channels) +
    CLIP head, bf16 — the JAX package's ``flagship_b0``, "the reference's
    best model". ``fused_loss`` and ``dropout`` (image feature and profile
    feature, 0.1 by default) as in ``flagship_vit``. Its serving path
    (eval mode) runs no MBConv kernel, in JAX neither."""
    drop = {} if dropout is None else {"dropout": dropout}
    return MultiModel(
        dim_embed=dim_embed,
        image_encoder_args={"name": "efficientnet_b0", "in_chans": 1,
                            "metadata": True, **drop},
        profile_encoder_args={"kind": "cnn", "dim_in": 6,
                              "blocks": (2, 2, 2, 2), "base_channels": 32,
                              **drop},
        coordination_args={"method": "clip", "fused": fused_loss},
        dtype=dtype,
    )


def flagship_vit(dim_embed: int = 512, fused_attention: bool = True,
                 fused_ffn: bool = False, target_size: int = 224,
                 fused_loss: bool = True, dropout: Optional[float] = None,
                 dtype: torch.dtype = torch.bfloat16) -> MultiModel:
    """ViT-T/16 + ProfileTransformer (192 wide, 2 layers, 8 heads) + CLIP
    head, bf16 — the JAX package's ``flagship_vit``. With
    ``fused_attention`` every attention layer runs the attention kernels,
    with ``fused_ffn`` every feed-forward block the fused FFN kernels (both
    encoders), with ``fused_loss`` the CLIP loss runs the CLIP kernels;
    without them, the plain PyTorch compositions of the same math.
    ``dropout`` overrides the image-encoder and profile dropout (0.1 by
    default; the ViT's own is 0.0), e.g. 0.0 to compare two paths step for
    step."""
    drop = {} if dropout is None else {"dropout": dropout}
    return MultiModel(
        dim_embed=dim_embed,
        image_encoder_args={"name": "vit_tiny_patch16_224", "in_chans": 1,
                            "metadata": True,
                            "fused_attention": fused_attention,
                            "fused_ffn": fused_ffn, **drop},
        profile_encoder_args={"kind": "transformer", "dim_in": 6,
                              "dim_hidden": 192, "num_layers": 2,
                              "num_head": 8, "target_size": target_size,
                              "fused_attention": fused_attention,
                              "fused_ffn": fused_ffn, **drop},
        coordination_args={"method": "clip", "fused": fused_loss},
        dtype=dtype,
    )


def synthetic_batch_b0(bs: int, img: int = 224, plen: int = 224,
                       seed: int = 0, device: torch.device | str = "cpu"
                       ) -> dict:
    """The JAX package's synthetic B0 batch, from the same numpy
    ``RandomState`` stream: fixed-length profiles, no tokens beyond them."""
    rs = np.random.RandomState(seed)
    batch = {
        "image": rs.randn(bs, img, img, 1).astype(np.float32),
        "image_shape": rs.randint(50, 400, (bs, 2)).astype(np.int32),
        "profile": rs.randn(bs, plen, 6).astype(np.float32),
        "profile_len": rs.randint(20, 2000, (bs, 1)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def synthetic_batch_vit(bs: int, img: int = 224, target_size: int = 224,
                        seed: int = 0, device: torch.device | str = "cpu"
                        ) -> dict:
    """The JAX package's synthetic ViT batch, drawn from the same numpy
    ``RandomState`` stream (so both packages see the same numbers): CLS row
    prepended (target_size + 1 tokens), time ids, an all-False padding
    mask."""
    rs = np.random.RandomState(seed)
    length = target_size + 1
    batch = {
        "image": rs.randn(bs, img, img, 1).astype(np.float32),
        "image_shape": rs.randint(50, 400, (bs, 2)).astype(np.int32),
        "profile": rs.randn(bs, length, 6).astype(np.float32),
        "profile_len": rs.randint(20, 2000, (bs, 1)).astype(np.int32),
        "time": np.tile(np.arange(length, dtype=np.int32), (bs, 1)),
        "padding_mask": np.zeros((bs, length), bool),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, after the Flax initialisers:
    lecun-normal Dense and conv kernels (fan-in of a depthwise kernel:
    k·k), zero biases, unit LayerNorm scales, N(0, 0.02) position tables,
    a zero CLS token; norms keep their unit scales, zero biases and
    running statistics (0 mean, 1 variance)."""
    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, 1.0 / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ViT):
            normal_(m.pos_embed, 0.02)
            m.cls_token.zero_()
    return model
