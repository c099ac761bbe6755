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

from ..config import COORDINATION_METHODS
from ..ops import losses
from ..ops.contrastive import clip_loss_fused, siglip_loss_fused
from .dense import Dense
from .image.encoder import ImageEncoder
from .profile.factory import create_profile_encoder

_SCALED = ("clip", "clipplus", "siglip", "siglipplus")
_SIGLIP = ("siglip", "siglipplus")


class CoordinationHead(nn.Module):
    """The coordination loss and its learnable parameters, dispatched on
    ``method`` (one of ``config.COORDINATION_METHODS``): ``logit_scale``
    (init 1.0) for the CLIP and SigLIP families, ``logit_bias`` (init
    −10.0) for SigLIP, and for ArcFace the class ``weight`` (out_features,
    in_features), Xavier-uniform. All f32, as in the Flax tree. ``fused``
    sends clip, clipplus, siglip and siglipplus through
    ``ops.contrastive`` (kernels on the card, plain versions on the CPU);
    the ``plus`` variants add ``beta · mse``. Otherwise ``ops.losses``."""

    def __init__(self, method: str = "clip", fused: bool = False,
                 beta: float = 0.25, margin: float = 0.25,
                 out_features: int = 0, in_features: int = 0,
                 s: float = 30.0, m: float = 0.50,
                 easy_margin: bool = False) -> None:
        super().__init__()
        if method not in COORDINATION_METHODS:
            raise ValueError(f"Coordination loss not found: {method!r}")
        self.method = method
        self.fused = fused
        self.beta = beta
        self.margin = margin
        self.s, self.m, self.easy_margin = s, m, easy_margin
        if method in _SCALED:
            self.logit_scale = nn.Parameter(torch.ones(()))
        if method in _SIGLIP:
            self.logit_bias = nn.Parameter(torch.full((), -10.0))
        if method == "arcface":
            self.weight = nn.Parameter(
                nn.init.xavier_uniform_(torch.empty(out_features,
                                                    in_features)))

    def forward(self, image_emb: torch.Tensor, profile_emb: torch.Tensor,
                buckets: int = 1,
                label: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = self.method
        if self.fused and m in _SCALED:
            if m in _SIGLIP:
                loss = siglip_loss_fused(image_emb, profile_emb,
                                         self.logit_scale, self.logit_bias,
                                         buckets)
            else:
                loss = clip_loss_fused(image_emb, profile_emb,
                                       self.logit_scale, buckets)
            if m.endswith("plus"):
                loss = loss + self.beta * losses.mse_loss(image_emb,
                                                          profile_emb)
            return loss
        if m == "clip":
            return losses.clip_loss(image_emb, profile_emb, self.logit_scale,
                                    buckets)
        if m == "clipplus":
            return losses.clipplus_loss(image_emb, profile_emb,
                                        self.logit_scale, buckets, self.beta)
        if m == "siglip":
            return losses.siglip_loss(image_emb, profile_emb,
                                      self.logit_scale, self.logit_bias,
                                      buckets)
        if m == "siglipplus":
            return losses.siglipplus_loss(image_emb, profile_emb,
                                          self.logit_scale, self.logit_bias,
                                          buckets, self.beta)
        if m == "rank":
            return losses.rank_loss(image_emb, profile_emb, self.margin,
                                    buckets)
        if m == "distance":
            return losses.distance_loss(image_emb, profile_emb)
        if m == "arcface":
            return losses.arcface_loss(image_emb, profile_emb, label,
                                       self.weight, self.s, self.m,
                                       self.easy_margin)
        return losses.zero_loss(image_emb)


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
        self.image_projection = Dense(self.image_encoder.dim_out,
                                          dim_embed, bias=False)
        self.profile_projection = Dense(self.profile_encoder.dim_out,
                                            dim_embed, bias=False)
        coord = dict(coordination_args or {"method": "clip"})
        coord.pop("negatives", None)
        if coord.get("method") == "arcface":
            coord.setdefault("in_features", dim_embed)
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
        ``padding_mask``, or ``last_idx``. Dropout follows ``self.training``."""
        image_emb = profile_emb = None
        if image is not None:
            image_emb = self.image_projection(
                self.image_encoder(image, image_shape=image_shape))
        if profile is not None:
            # the LSTM's feature is f32 in any model dtype; a Flax Dense
            # casts its input to the module dtype
            feat = self.profile_encoder(profile, profile_len=profile_len,
                                        **tokens)
            profile_emb = self.profile_projection(
                feat.to(self.profile_projection.weight.dtype))
        return {"image_emb": image_emb, "profile_emb": profile_emb}

    def loss(self, buckets: int = 1, label: Optional[torch.Tensor] = None,
             **batch) -> torch.Tensor:
        """The coordination loss of one batch (``MultiModel.loss``);
        ``label`` (class ids) goes to the head, not to the encoders."""
        emb = self.encode(**batch)
        return self.coordination(emb["image_emb"], emb["profile_emb"],
                                 buckets=buckets, label=label)
