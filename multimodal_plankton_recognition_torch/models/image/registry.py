"""Image-backbone registry keyed by timm model names
(``models/image/registry.py`` of the JAX package): every name it
registers, the ViT, ResNet, EfficientNet and DenseNet families."""

from __future__ import annotations

from torch import nn

from . import densenet, efficientnet, resnet, vit

IMAGE_BACKBONES = {
    "vit_tiny_patch16_224": vit.vit_tiny_patch16_224,
    "vit_small_patch16_224": vit.vit_small_patch16_224,
    "vit_small_patch32_224": vit.vit_small_patch32_224,
    "resnet18": resnet.resnet18,
    "resnet50": resnet.resnet50,
    "efficientnet_b0": efficientnet.efficientnet_b0,
    "efficientnet_b1": efficientnet.efficientnet_b1,
    "densenet121": densenet.densenet121,
    "densenet169": densenet.densenet169,
}


def create_backbone(name: str, in_chans: int = 1, **kw) -> nn.Module:
    if name not in IMAGE_BACKBONES:
        raise NotImplementedError(
            f"image backbone {name!r} is not registered (registered: "
            f"{sorted(IMAGE_BACKBONES)})")
    return IMAGE_BACKBONES[name](in_chans=in_chans, **kw)
