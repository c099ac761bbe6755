"""Contrastive cross-modal model (``models/multi.py`` of the JAX package).

Image and profile encoders with bias-free projections into a shared
``dim_embed`` space, plus the coordination head that holds the loss's
learnable scalars and computes the loss. ``dtype`` is the compute dtype:
the encoders and projections hold their weights in it (the JAX modules cast
their f32 parameters to it at use, which rounds the same way); the
coordination scalars stay f32, as in the Flax tree. Training keeps f32
master weights outside the module (``train/state.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops import losses
from ..ops.contrastive import clip_loss_fused
from .image.encoder import ImageEncoder
from .profile.factory import create_profile_encoder

_CLIP_FAMILY = ("clip", "clipplus")


class CoordinationHead(nn.Module):
    """The coordination loss and its learnable scalars (CLIP
    ``logit_scale``, init 1.0). ``fused`` sends CLIP through
    ``ops.contrastive.clip_loss_fused`` (kernels on the card, plain
    versions on the CPU); otherwise ``ops.losses``."""

    def __init__(self, method: str = "clip", fused: bool = False,
                 beta: float = 0.25) -> None:
        super().__init__()
        if method not in _CLIP_FAMILY:
            raise NotImplementedError(
                f"coordination method {method!r} is not ported yet (ported: "
                f"{_CLIP_FAMILY}); see ROADMAP.md")
        self.method = method
        self.fused = fused
        self.beta = beta
        self.logit_scale = nn.Parameter(torch.ones(()))

    def forward(self, image_emb: torch.Tensor, profile_emb: torch.Tensor,
                buckets: int = 1) -> torch.Tensor:
        if not self.fused:
            if self.method == "clip":
                return losses.clip_loss(image_emb, profile_emb,
                                        self.logit_scale, buckets)
            return losses.clipplus_loss(image_emb, profile_emb,
                                        self.logit_scale, buckets, self.beta)
        loss = clip_loss_fused(image_emb, profile_emb, self.logit_scale,
                               buckets)
        if self.method == "clipplus":
            loss = loss + self.beta * losses.mse_loss(image_emb, profile_emb)
        return loss


class MultiModel(nn.Module):
    def __init__(self, dim_embed: int = 512,
                 image_encoder_args: Optional[Dict[str, Any]] = None,
                 profile_encoder_args: Optional[Dict[str, Any]] = None,
                 coordination_args: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.image_encoder = ImageEncoder(**(image_encoder_args or {}))
        self.profile_encoder = create_profile_encoder(
            profile_encoder_args or {})
        self.image_projection = nn.Linear(self.image_encoder.dim_out,
                                          dim_embed, bias=False)
        self.profile_projection = nn.Linear(self.profile_encoder.dim_out,
                                            dim_embed, bias=False)
        coord = dict(coordination_args or {"method": "clip"})
        coord.pop("negatives", None)
        self.coordination = CoordinationHead(**coord)
        for module in (self.image_encoder, self.profile_encoder,
                       self.image_projection, self.profile_projection):
            module.to(dtype)

    def encode(self, image: Optional[torch.Tensor] = None,
               image_shape: Optional[torch.Tensor] = None,
               profile: Optional[torch.Tensor] = None,
               profile_len: Optional[torch.Tensor] = None,
               **tokens) -> Dict[str, Optional[torch.Tensor]]:
        """Embed the available modalities; a missing (None) one is skipped.
        ``tokens`` are the profile tokenizer's ``time`` and
        ``padding_mask``. Dropout follows ``self.training``."""
        image_emb = profile_emb = None
        if image is not None:
            image_emb = self.image_projection(
                self.image_encoder(image, image_shape=image_shape))
        if profile is not None:
            profile_emb = self.profile_projection(
                self.profile_encoder(profile, profile_len=profile_len,
                                     **tokens))
        return {"image_emb": image_emb, "profile_emb": profile_emb}

    def loss(self, buckets: int = 1, **batch) -> torch.Tensor:
        """The coordination loss of one batch (``MultiModel.loss``)."""
        emb = self.encode(**batch)
        return self.coordination(emb["image_emb"], emb["profile_emb"],
                                 buckets=buckets)
