"""Plain PyTorch encoders of the two contrastive cards, in float32.

Written from the published descriptions and the cards, not from the
program: ViT-T/16 (DeiT-Ti, arXiv:2012.12877; timm's
``vit_tiny_patch16_224``: 192 wide, 12 pre-LN blocks of 3 heads, MLP
768), EfficientNet-B0 (arXiv:1905.11946: the B0 stage table, MBConv with
squeeze-excite at a quarter of the block's input width, a 1x1 head to
1,280), and the reference repository's profile encoders (a post-LN
transformer over a CLS token and learned positions; a 1-D ResNet of basic
blocks with a global max over time). Each image or profile feature gets
the card's ``metadata`` scalars appended: the image's (height, width)
over the input size, the profile's raw length over its token count.

Conventions the cards fix and the reference follows: LayerNorm eps 1e-6
and the tanh form of GELU (the Flax defaults the cards were trained
with); BatchNorm eps 1e-5, batch statistics with the biased variance;
symmetric padding k // 2 on every convolution; images channel-last (B, H,
W, C), profiles (B, L, 6). Dropout is left out: the reference is compared
with steps that run without it.

The parameter names are the layout the benchmark makes weights in
(``harness/weights.py``) and hands to both sides. Every product runs
through ``prec.op`` on both operands (``precision.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .precision import Precision

LN_EPS = 1e-6
BN_EPS = 1e-5

#: init of a leaf: (mean, std) of the normal draw it is made from
Init = tuple


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True) -> None:
        super().__init__()
        self.weight = _param(cout, cin)
        self.bias = _param(cout) if bias else None

    def forward(self, x, prec: Precision):
        return F.linear(prec.op(x), prec.op(self.weight), self.bias)


class Conv(nn.Module):
    """A 1-D or 2-D convolution, padding k // 2."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dims: int = 2) -> None:
        super().__init__()
        self.stride, self.groups, self.dims = stride, groups, dims
        self.padding = k // 2
        self.weight = _param(cout, cin // groups, *([k] * dims))
        self.bias = _param(cout) if bias else None

    def forward(self, x, prec: Precision):
        conv = F.conv2d if self.dims == 2 else F.conv1d
        return conv(prec.op(x), prec.op(self.weight), self.bias,
                    stride=self.stride, padding=self.padding,
                    groups=self.groups)


class LayerNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


class BatchNorm(nn.Module):
    """Over dim 1 of (B, C, ...). ``stats`` is the run's mode: None
    normalizes with the running statistics; a dict normalizes with the
    batch's and records them in it by module."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.weight = _param(channels)
        self.bias = _param(channels)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, stats: Optional[dict]):
        if stats is None:
            mean, var = self.running_mean, self.running_var
        else:
            dims = (0, *range(2, x.dim()))
            mean = x.mean(dims)
            var = x.var(dims, unbiased=False)
            stats[self] = (mean.detach(), var.detach())
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + BN_EPS) * self.weight.reshape(shape) \
            + self.bias.reshape(shape)


def attention(x, qkv: Linear, out: Linear, heads: int,
              key_padding: Optional[torch.Tensor], prec: Precision):
    """Multi-head self-attention, q|k|v in the row blocks of ``qkv``,
    head-major inside each; padded keys (True in ``key_padding``) take no
    weight."""
    b, l, e = x.shape
    d = e // heads
    q, k, v = qkv(x, prec).reshape(b, l, 3, heads, d).permute(
        2, 0, 3, 1, 4)
    s = prec.op(q) @ prec.op(k).transpose(-1, -2) / math.sqrt(d)
    if key_padding is not None:
        s = s.masked_fill(key_padding[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = (prec.op(p) @ prec.op(v)).transpose(1, 2).reshape(b, l, e)
    return out(o, prec)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class _VitBlock(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int) -> None:
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNorm(dim)
        self.attn = nn.Module()
        self.attn.qkv = Linear(dim, 3 * dim)
        self.attn.out = Linear(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.mlp1 = Linear(dim, hidden)
        self.mlp2 = Linear(hidden, dim)

    def forward(self, x, prec):
        x = x + attention(self.ln1(x), self.attn.qkv, self.attn.out,
                          self.heads, None, prec)
        return x + self.mlp2(_gelu(self.mlp1(self.ln2(x), prec)), prec)


class ViT(nn.Module):
    """Patch embedding by a strided convolution, a CLS token, learned
    positions, pre-LN blocks, a final LayerNorm, the CLS feature."""

    def __init__(self, patch: int = 16, dim: int = 192, depth: int = 12,
                 heads: int = 3, mlp_ratio: float = 4.0, in_chans: int = 1,
                 img_size: int = 224) -> None:
        super().__init__()
        self.patch_embed = Conv(in_chans, dim, patch, stride=patch,
                                bias=True)
        self.patch_embed.padding = 0
        tokens = (img_size // patch) ** 2 + 1
        self.cls_token = _param(1, 1, dim)
        self.pos_embed = _param(1, tokens, dim)
        self.blocks = nn.ModuleList(
            _VitBlock(dim, heads, int(dim * mlp_ratio)) for _ in range(depth))
        self.ln_final = LayerNorm(dim)
        self.num_features = dim

    def forward(self, image, prec, stats=None):
        x = self.patch_embed(image.permute(0, 3, 1, 2), prec)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x, prec)
        return self.ln_final(x)[:, 0]


# (expand ratio, channels, repeats, stride, kernel) of each B0 stage
B0_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
             (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
             (6, 320, 1, 1, 3))


class _MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand: int, stride: int,
                 k: int, se_ratio: float = 0.25) -> None:
        super().__init__()
        mid = cin * expand
        self.residual = stride == 1 and cin == cout
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand_conv = Conv(cin, mid, 1)
            self.expand_bn = BatchNorm(mid)
        self.dw_conv = Conv(mid, mid, k, stride, groups=mid)
        self.dw_bn = BatchNorm(mid)
        self.se = nn.Module()
        self.se.reduce = Conv(mid, max(1, int(cin * se_ratio)), 1, bias=True)
        self.se.expand = Conv(max(1, int(cin * se_ratio)), mid, 1, bias=True)
        self.project_conv = Conv(mid, cout, 1)
        self.project_bn = BatchNorm(cout)

    def forward(self, x, prec, stats):
        y = x
        if self.has_expand:
            y = F.silu(self.expand_bn(self.expand_conv(y, prec), stats))
        y = F.silu(self.dw_bn(self.dw_conv(y, prec), stats))
        s = y.mean((2, 3), keepdim=True)
        s = torch.sigmoid(self.se.expand(F.silu(self.se.reduce(s, prec)),
                                         prec))
        y = self.project_bn(self.project_conv(y * s, prec), stats)
        return y + x if self.residual else y


class EfficientNetB0(nn.Module):
    def __init__(self, in_chans: int = 1) -> None:
        super().__init__()
        self.stem_conv = Conv(in_chans, 32, 3, 2)
        self.stem_bn = BatchNorm(32)
        self.block_names = []
        cin = 32
        for si, (expand, ch, repeats, stride, k) in enumerate(B0_STAGES):
            for b in range(repeats):
                name = f"stage{si + 1}_block{b}"
                self.add_module(name, _MBConv(cin, ch, expand,
                                              stride if b == 0 else 1, k))
                self.block_names.append(name)
                cin = ch
        self.head_conv = Conv(cin, 1280, 1)
        self.head_bn = BatchNorm(1280)
        self.num_features = 1280

    def forward(self, image, prec, stats=None):
        x = F.silu(self.stem_bn(self.stem_conv(image.permute(0, 3, 1, 2),
                                               prec), stats))
        for name in self.block_names:
            x = getattr(self, name)(x, prec, stats)
        x = F.silu(self.head_bn(self.head_conv(x, prec), stats))
        return x.mean((2, 3))


class ImageEncoder(nn.Module):
    """The backbone's feature, then (height, width) / input size."""

    def __init__(self, args: Dict) -> None:
        super().__init__()
        name = args["name"]
        kw = dict(args.get("backbone_kwargs") or {})
        if name == "vit_tiny_patch16_224":
            self.backbone = ViT(patch=16, dim=kw.get("embed_dim", 192),
                                depth=kw.get("depth", 12),
                                heads=kw.get("num_heads", 3),
                                in_chans=args.get("in_chans", 1),
                                img_size=kw.get("img_size", 224))
        elif name == "efficientnet_b0":
            self.backbone = EfficientNetB0(args.get("in_chans", 1))
        else:
            raise NotImplementedError(f"no reference for {name!r}")
        self.metadata = args.get("metadata", True)
        self.dim_out = self.backbone.num_features + 2 * int(self.metadata)

    def forward(self, image, image_shape, prec, stats=None):
        x = self.backbone(image, prec, stats)
        if self.metadata:
            x = torch.cat([x, image_shape.float() / image.shape[1]], 1)
        return x


class _PostLNLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int) -> None:
        super().__init__()
        self.heads = heads
        self.attn = nn.Module()
        self.attn.qkv = Linear(dim, 3 * dim)
        self.attn.out = Linear(dim, dim)
        self.ln1 = LayerNorm(dim)
        self.ff1 = Linear(dim, hidden)
        self.ff2 = Linear(hidden, dim)
        self.ln2 = LayerNorm(dim)

    def forward(self, x, padding, prec):
        x = self.ln1(x + attention(x, self.attn.qkv, self.attn.out,
                                   self.heads, padding, prec))
        return self.ln2(x + self.ff2(_gelu(self.ff1(x, prec)), prec))


class ProfileTransformer(nn.Module):
    """Pulse channels expanded without bias, plus learned positions (the
    last of target + 2 rows is the padding row), post-LN layers, the CLS
    token's output, then raw length / token count."""

    def __init__(self, args: Dict) -> None:
        super().__init__()
        dim = args.get("dim_hidden", 128)
        self.metadata = args.get("metadata", True)
        self.expand = Linear(args.get("dim_in", 6), dim, bias=False)
        self.position = nn.Module()
        self.position.weight = _param(args.get("target_size", 224) + 2, dim)
        self.layers = nn.ModuleList(
            _PostLNLayer(dim, args.get("num_head", 4),
                         args.get("dim_feedforward", 2024))
            for _ in range(args.get("num_layers", 6)))
        if args.get("activation", "gelu") != "gelu":
            raise NotImplementedError("the reference's profile transformer "
                                      "is the cards' GELU one")
        self.dim_out = dim + int(self.metadata)

    def forward(self, batch, prec, stats=None):
        profile = batch["profile"]
        x = self.expand(profile, prec) + self.position.weight[batch["time"]]
        for layer in self.layers:
            x = layer(x, batch["padding_mask"], prec)
        x = x[:, 0]
        if self.metadata:
            x = torch.cat([x, batch["profile_len"].float()
                           / profile.shape[1]], 1)
        return x


class _BasicBlock1D(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int, proj: bool) -> None:
        super().__init__()
        self.conv1 = Conv(cin, ch, 3, stride, dims=1)
        self.bn1 = BatchNorm(ch)
        self.conv2 = Conv(ch, ch, 3, 1, dims=1)
        self.bn2 = BatchNorm(ch)
        self.proj = proj
        if proj:
            self.proj_conv = Conv(cin, ch, 1, stride, dims=1)
            self.proj_bn = BatchNorm(ch)

    def forward(self, x, prec, stats):
        y = F.relu(self.bn1(self.conv1(x, prec), stats))
        y = self.bn2(self.conv2(y, prec), stats)
        skip = self.proj_bn(self.proj_conv(x, prec), stats) if self.proj \
            else x
        return F.relu(y + skip)


class ProfileCNN(nn.Module):
    """A 1-D ResNet: stem conv (k 3, stride 2) + BN + ReLU + max pool (3,
    2, 1), stages of basic blocks doubling the channels (stride 2 from
    the second stage), the max over time, then raw length / steps."""

    def __init__(self, args: Dict) -> None:
        super().__init__()
        base = args.get("base_channels", 32)
        blocks: Sequence[int] = args.get("blocks", (2, 2, 2, 2))
        self.metadata = args.get("metadata", True)
        self.stem_conv = Conv(args.get("dim_in", 6), base, 3, 2, dims=1)
        self.stem_bn = BatchNorm(base)
        self.block_names = []
        cin = base
        for stage, repeats in enumerate(blocks):
            ch = base * 2 ** stage
            for b in range(repeats):
                stride = 2 if stage and b == 0 else 1
                name = f"stage{stage + 1}_block{b}"
                self.add_module(name, _BasicBlock1D(
                    cin, ch, stride, b == 0 and (stride != 1 or cin != ch)))
                self.block_names.append(name)
                cin = ch
        self.dim_out = cin + int(self.metadata)

    def forward(self, batch, prec, stats=None):
        profile = batch["profile"]
        x = self.stem_conv(profile.transpose(1, 2), prec)
        x = F.max_pool1d(F.relu(self.stem_bn(x, stats)), 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, prec, stats)
        x = x.amax(dim=2)
        if self.metadata:
            x = torch.cat([x, batch["profile_len"].float()
                           / profile.shape[1]], 1)
        return x


def profile_encoder(args: Dict) -> nn.Module:
    kind = args.get("kind")
    if kind == "transformer":
        return ProfileTransformer(args)
    if kind == "cnn":
        return ProfileCNN(args)
    raise NotImplementedError(f"no reference for profile kind {kind!r}")


def init_spec(model: nn.Module) -> Dict[str, Init]:
    """(mean, std) of every parameter and buffer by name: weights of
    products N(0, 1 / fan_in), biases N(0, 0.02²), norm scales N(1,
    0.05²), positions and the CLS token N(0, 0.02²), the contrastive
    scale 1 (its published init); running statistics 0 and 1."""
    spec: Dict[str, Init] = {}
    for mname, mod in model.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, p in mod.named_parameters(recurse=False):
            name = prefix + pname
            if isinstance(mod, (Linear, Conv)) and pname == "weight":
                fan_in = p[0].numel()
                spec[name] = (0.0, 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, (LayerNorm, BatchNorm)) \
                    and pname == "weight":
                spec[name] = (1.0, 0.05)
            elif pname == "logit_scale":
                spec[name] = (1.0, 0.0)
            else:
                spec[name] = (0.0, 0.02)
        for bname, _ in mod.named_buffers(recurse=False):
            spec[prefix + bname] = (1.0 if bname == "running_var" else 0.0,
                                    0.0)
    return spec
