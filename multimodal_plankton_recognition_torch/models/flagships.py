"""The two flagships and their synthetic batches (``models/flagships.py``
of the JAX package): EfficientNet-B0 + ProfileCNN and ViT-T/16 +
ProfileTransformer, each with the CLIP head, and each flagship as a model
card (``flagship_card``), which a checkpoint's metadata stores. The seeded
random initialisation for runs without a checkpoint, ``init_weights_``,
lives in ``models.initializers`` and is re-exported here."""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from .initializers import init_weights_
from .multi import MultiModel

__all__ = ["flagship_b0", "flagship_vit", "flagship_card", "init_weights_",
           "synthetic_batch_b0", "synthetic_batch_vit"]


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


_FLAGSHIP_CARDS = {
    "vit": {
        "bs": 256, "buckets": 16, "target_size": 224, "dim_embedding": 512,
        "image_encoder_args": {"name": "vit_tiny_patch16_224",
                               "in_chans": 1, "metadata": True,
                               "fused_attention": True, "fused_ffn": False},
        "profile_encoder_args": {"kind": "transformer", "dim_in": 6,
                                 "dim_hidden": 192, "num_layers": 2,
                                 "num_head": 8, "target_size": 224,
                                 "fused_attention": True,
                                 "fused_ffn": False},
        "coordination_args": {"method": "clip", "fused": True},
        "optim_args": {"lr": 5e-3, "momentum": 0.9, "weight_decay": 1e-3,
                       "nesterov": True},
        "trainer_args": {"precision": "16-mixed"},
    },
    "b0": {
        "bs": 256, "buckets": 16, "target_size": 224, "dim_embedding": 512,
        "image_encoder_args": {"name": "efficientnet_b0", "in_chans": 1,
                               "metadata": True},
        "profile_encoder_args": {"kind": "cnn", "dim_in": 6,
                                 "blocks": [2, 2, 2, 2],
                                 "base_channels": 32},
        "coordination_args": {"method": "clip", "fused": True},
        "optim_args": {"lr": 5e-3, "momentum": 0.9, "weight_decay": 1e-3,
                       "nesterov": True},
        "trainer_args": {"precision": "16-mixed"},
    },
}


def flagship_card(name: str) -> dict:
    """The model-card dict (``config.ModelCard.from_dict``) whose
    ``models.build.build_multi_model`` is ``flagship_vit()`` (``name``
    "vit") or ``flagship_b0()`` ("b0"): batch 256 in 16 buckets, bf16
    (``precision: 16-mixed``), SGD lr 5e-3, momentum 0.9, nesterov,
    weight decay 1e-3. JSON-serializable (lists, no tuples)."""
    return copy.deepcopy(_FLAGSHIP_CARDS[name])


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
