"""ViT-T/16 (DeiT-Ti, arXiv:2012.12877; timm ``vit_tiny_patch16_224``):
192 wide, 12 blocks, 3 heads, MLP 4 × 192, over (S / 16)² patches and a
class token; ``backbone_kwargs`` overrides the widths as the port's
builder takes them."""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.layers import transformer_block


def _dims(args: Dict, size: int):
    kw = args.get("backbone_kwargs") or {}
    e = kw.get("embed_dim", 192)
    patches = (kw.get("img_size", size) // 16) ** 2
    return e, kw.get("depth", 12), kw.get("num_heads", 3), patches


def flops(args: Dict, size: int) -> int:
    e, depth, _, patches = _dims(args, size)
    return 2 * patches * 16 * 16 * args.get("in_chans", 1) * e \
        + depth * transformer_block(patches + 1, e, 4 * e)


def width(args: Dict) -> int:
    return (args.get("backbone_kwargs") or {}).get("embed_dim", 192)


def attention(args: Dict, size: int, batch: int, keys=None) -> List:
    e, depth, heads, patches = _dims(args, size)
    tokens = patches + 1
    return [(batch, tokens, heads, e // heads, tokens, False)] * depth
