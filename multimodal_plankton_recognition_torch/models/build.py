"""Model builders from validated model cards (``models/build.py`` of the
JAX package): one place that maps a ``ModelCard`` to the port's modules,
the contrastive ``MultiModel`` and the supervised ``ImageClassifier`` and
``ProfileClassifier`` (one output per class name).

The encoder arguments go to the modules as the card gives them:
``fused_mbconv`` and ``remat`` to the image encoder, which hands them to
an EfficientNet only; ``fused_ffn`` to either encoder, the image encoder
handing it to a ViT only; ``pretrained`` and ``pretrained_path`` are
the train drivers' (they load the npz, ``models.pretrained``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..config import ModelCard
from .classifier import ImageClassifier, ProfileClassifier
from .multi import MultiModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(card: ModelCard) -> torch.dtype:
    """The card's compute dtype: ``precision: 16-mixed`` → bf16."""
    return _DTYPES[card.trainer_args.compute_dtype]


def step_buckets(card: ModelCard) -> int:
    """Buckets of the contrastive loss in a one-card train step:
    ``negatives: global`` makes the whole batch one bucket
    (as the JAX package's ``train_multi`` sets it)."""
    negatives = (card.coordination_args or {}).get("negatives", "bucketed")
    return 1 if negatives == "global" else card.buckets


def build_multi_model(card: ModelCard,
                      dtype: Optional[torch.dtype] = None) -> MultiModel:
    """The card's ``MultiModel`` at ``dtype`` (default: the card's compute
    dtype), on the CPU with PyTorch's default initialisation."""
    return MultiModel(
        dim_embed=card.dim_embedding or 512,
        image_encoder_args=card.image_encoder_args,
        profile_encoder_args=card.profile_encoder_args,
        coordination_args=card.coordination_args,
        dtype=dtype or compute_dtype(card),
    )


def build_image_classifier(card: ModelCard, class_names: Iterable[str],
                           dtype: Optional[torch.dtype] = None
                           ) -> ImageClassifier:
    """The card's image classifier over ``class_names``, as
    ``build_multi_model`` builds its model."""
    return ImageClassifier(
        n_classes=len(list(class_names)),
        image_encoder_args=card.image_encoder_args,
        dtype=dtype or compute_dtype(card),
    )


def build_profile_classifier(card: ModelCard, class_names: Iterable[str],
                             dtype: Optional[torch.dtype] = None
                             ) -> ProfileClassifier:
    """The card's profile classifier over ``class_names``."""
    return ProfileClassifier(
        n_classes=len(list(class_names)),
        profile_encoder_args=card.profile_encoder_args,
        dtype=dtype or compute_dtype(card),
    )


def build_for_kind(card: ModelCard, kind: str,
                   class_names: Iterable[str] = (),
                   dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """The model of a checkpoint's or driver's ``kind``: ``multi`` (the
    contrastive model), ``image`` or ``profile`` (a classifier over
    ``class_names``), at ``dtype`` (default: the card's compute dtype)."""
    if kind == "multi":
        return build_multi_model(card, dtype)
    if kind == "image":
        return build_image_classifier(card, class_names, dtype)
    if kind == "profile":
        return build_profile_classifier(card, class_names, dtype)
    raise ValueError(f"Unknown checkpoint kind {kind!r}")
