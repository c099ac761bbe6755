"""Image encoder: backbone + image-shape metadata
(``models/image/encoder.py`` of the JAX package).

The pooled backbone feature gets the original (height, width) divided by
the model's input resolution appended, so ``dim_out = num_features +
2*metadata``. The shape is cast to the model dtype BEFORE the division, as
in the JAX module: in bf16 a size like 399 rounds to 400 first. In train
mode the feature drops at ``dropout`` (``encoder.py:83``).

As in the JAX module, ``fused_mbconv`` reaches only an EfficientNet
backbone (as its ``fused``) and ``fused_attention`` and ``fused_ffn`` only a
ViT; the other backbones ignore them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..dropout import dropout
from .registry import create_backbone


class ImageEncoder(nn.Module):
    def __init__(self, name: str = "vit_tiny_patch16_224", in_chans: int = 1,
                 dropout: float = 0.1, metadata: bool = True,
                 num_classes: int = 0, pretrained: bool = False,
                 fused_attention: bool = False, fused_mbconv: bool = False,
                 fused_ffn: bool = False,
                 backbone_kwargs: Optional[dict] = None) -> None:
        """Card keys of the JAX module; ``num_classes`` is accepted for
        card parity (features only)."""
        super().__init__()
        if pretrained:
            raise NotImplementedError("pretrained npz weights are not ported "
                                      "yet (ROADMAP.md)")
        self.metadata = metadata
        self.dropout = dropout
        extra = {}
        if fused_mbconv and "efficientnet" in name:
            extra["fused"] = True
        if fused_attention and name.startswith("vit"):
            extra["fused_attention"] = True
        if fused_ffn and name.startswith("vit"):
            extra["fused_ffn"] = True
        extra.update(backbone_kwargs or {})
        self.backbone = create_backbone(name, in_chans=in_chans, **extra)

    @property
    def dim_out(self) -> int:
        return self.backbone.num_features + 2 * int(self.metadata)

    def forward(self, image: torch.Tensor,
                image_shape: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.backbone(image)
        if self.metadata:
            md = image_shape.to(x.dtype) / image.shape[1]
            x = torch.cat([x, md.reshape(x.shape[0], -1)], dim=1)
        return dropout(x, self.dropout, self.training)
