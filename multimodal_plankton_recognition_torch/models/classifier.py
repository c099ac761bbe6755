"""Supervised unimodal classifiers (``models/classifier.py`` of the JAX
package): an encoder and a linear softmax head ``fc``, both in the module
dtype (the JAX modules cast their f32 parameters to it at use). The
train and eval steps (cross-entropy, accuracy) are
``train.loop.make_classifier_steps``; the metrics ``train.metrics``.
Dropout follows ``self.training``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .dense import Dense
from .image.encoder import ImageEncoder
from .profile.factory import create_profile_encoder


class ImageClassifier(nn.Module):
    def __init__(self, n_classes: int = 2,
                 image_encoder_args: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.image_encoder = ImageEncoder(**(image_encoder_args or {}))
        self.fc = Dense(self.image_encoder.dim_out, n_classes)
        self.to(dtype)

    def forward(self, image: torch.Tensor,
                image_shape: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        """Logits (B, n_classes); other batch keys are ignored."""
        return self.fc(self.image_encoder(image, image_shape=image_shape))


class ProfileClassifier(nn.Module):
    def __init__(self, n_classes: int = 2,
                 profile_encoder_args: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.profile_encoder = create_profile_encoder(
            profile_encoder_args or {})
        self.fc = Dense(self.profile_encoder.dim_out, n_classes)
        self.to(dtype)

    def forward(self, profile: torch.Tensor,
                profile_len: Optional[torch.Tensor] = None,
                **tokens) -> torch.Tensor:
        """Logits (B, n_classes); ``tokens`` are the tokenizer's ``time``
        and ``padding_mask``, or ``last_idx``. The LSTM's f32 feature is
        cast to the head's dtype, as a Flax Dense casts its input."""
        x = self.profile_encoder(profile, profile_len=profile_len, **tokens)
        return self.fc(x.to(self.fc.weight.dtype))
