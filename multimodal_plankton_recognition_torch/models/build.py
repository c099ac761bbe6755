"""Model builders from validated model cards (``models/build.py`` of the
JAX package): one place that maps a ``ModelCard`` to the port's modules.

Card options the port does not take yet raise ``NotImplementedError``
naming ``ROADMAP.md``, before any module is built: ``remat``,
``pretrained_path`` and ``pretrained: true`` (the image encoder's own
refusal). So do image backbones and profile-encoder kinds not ported yet
(``models/image/registry.py``, ``models/profile/factory.py``).
``fused_mbconv`` goes to the image encoder, which hands it to an
EfficientNet only; ``fused_ffn`` to either encoder, the image encoder
handing it to a ViT only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import ModelCard
from .multi import MultiModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NOT_PORTED = {
    "image_encoder_args": ("remat", "pretrained_path"),
    "profile_encoder_args": (),
}


def compute_dtype(card: ModelCard) -> torch.dtype:
    """The card's compute dtype: ``precision: 16-mixed`` → bf16."""
    return _DTYPES[card.trainer_args.compute_dtype]


def step_buckets(card: ModelCard) -> int:
    """Buckets of the contrastive loss in a one-card train step:
    ``negatives: global`` makes the whole batch one bucket
    (as the JAX package's ``train_multi`` sets it)."""
    negatives = (card.coordination_args or {}).get("negatives", "bucketed")
    return 1 if negatives == "global" else card.buckets


def _strip(field: str, args: Optional[Dict[str, Any]]
           ) -> Optional[Dict[str, Any]]:
    """Drop the card keys the port's modules do not take; raise for one
    that is set."""
    if args is None:
        return None
    for key in _NOT_PORTED[field]:
        if args.get(key):
            raise NotImplementedError(
                f"{field}.{key}={args[key]!r} is not ported yet; see "
                f"ROADMAP.md")
    return {k: v for k, v in args.items() if k not in _NOT_PORTED[field]}


def build_multi_model(card: ModelCard,
                      dtype: Optional[torch.dtype] = None) -> MultiModel:
    """The card's ``MultiModel`` at ``dtype`` (default: the card's compute
    dtype), on the CPU with PyTorch's default initialisation."""
    return MultiModel(
        dim_embed=card.dim_embedding or 512,
        image_encoder_args=_strip("image_encoder_args",
                                  card.image_encoder_args),
        profile_encoder_args=_strip("profile_encoder_args",
                                    card.profile_encoder_args),
        coordination_args=card.coordination_args,
        dtype=dtype or compute_dtype(card),
    )
