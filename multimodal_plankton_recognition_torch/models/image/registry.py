"""Image-backbone registry keyed by timm model names
(``models/image/registry.py`` of the JAX package). Ported so far: the ViT
and EfficientNet families."""

from __future__ import annotations

from torch import nn

from . import efficientnet, vit

IMAGE_BACKBONES = {
    "vit_tiny_patch16_224": vit.vit_tiny_patch16_224,
    "vit_small_patch16_224": vit.vit_small_patch16_224,
    "vit_small_patch32_224": vit.vit_small_patch32_224,
    "efficientnet_b0": efficientnet.efficientnet_b0,
    "efficientnet_b1": efficientnet.efficientnet_b1,
}


def create_backbone(name: str, in_chans: int = 1, **kw) -> nn.Module:
    if name not in IMAGE_BACKBONES:
        raise NotImplementedError(
            f"image backbone {name!r} is not ported yet (ported: "
            f"{sorted(IMAGE_BACKBONES)}); see ROADMAP.md")
    return IMAGE_BACKBONES[name](in_chans=in_chans, **kw)
