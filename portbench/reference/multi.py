"""The plain reference of a contrastive card: both encoders and their
bias-free projections into the shared space, the bucketed CLIP loss, SGD
with Nesterov momentum and weight decay on float32 weights, and the
served classifier's exact kNN with an inverse-distance weighted vote.

Written from the card and the published descriptions: CLIP (Radford et
al., 2021, arXiv:2103.00020) over buckets of consecutive pairs, the
logits the cosine similarities times exp(logit_scale), the symmetric
cross-entropy against the diagonal averaged over the buckets; SGD as
``torch.optim.SGD`` defines it (d = g + wd p; b = d on the first step,
else mu b + d; p -= lr (d + mu b) with Nesterov); the fused gallery of
the reference repository (image and profile embeddings stacked as rows
with their labels twice), one k-neighbour query per query modality, the
neighbours pooled, each weighted by 1 / distance, the class of the
largest summed weight, ties to the smaller class id.

Imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .encoders import ImageEncoder, init_spec, profile_encoder
from .precision import F32, Precision

PROFILE_KEYS = ("profile", "profile_len", "time", "padding_mask")


class MultiModel(nn.Module):
    def __init__(self, card: Dict) -> None:
        super().__init__()
        dim = card.get("dim_embedding") or 512
        self.image_encoder = ImageEncoder(card["image_encoder_args"])
        self.profile_encoder = profile_encoder(card["profile_encoder_args"])
        self.image_projection = nn.Module()
        self.image_projection.weight = nn.Parameter(
            torch.zeros(dim, self.image_encoder.dim_out))
        self.profile_projection = nn.Module()
        self.profile_projection.weight = nn.Parameter(
            torch.zeros(dim, self.profile_encoder.dim_out))
        self.coordination = nn.Module()
        self.coordination.logit_scale = nn.Parameter(torch.zeros(()))

    def init_spec(self) -> Dict[str, tuple]:
        return init_spec(self)

    def encode(self, batch: Dict[str, torch.Tensor],
               prec: Precision = F32, stats: Optional[dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image, profile) embeddings, unnormalized. ``stats``: None for
        BatchNorm's running statistics, a dict for the batch's."""
        img = self.image_encoder(batch["image"], batch["image_shape"],
                                 prec, stats)
        img = F.linear(prec.op(img), prec.op(self.image_projection.weight))
        prof = self.profile_encoder(
            {k: batch[k] for k in PROFILE_KEYS if k in batch}, prec, stats)
        prof = F.linear(prec.op(prof),
                        prec.op(self.profile_projection.weight))
        return img, prof


def clip_loss(image_emb: torch.Tensor, profile_emb: torch.Tensor,
              logit_scale: torch.Tensor, buckets: int,
              prec: Precision = F32) -> torch.Tensor:
    b, d = image_emb.shape
    n = b // buckets
    i = F.normalize(image_emb, dim=-1).reshape(buckets, n, d)
    p = F.normalize(profile_emb, dim=-1).reshape(buckets, n, d)
    z = (prec.op(i) @ prec.op(p).transpose(1, 2)) * torch.exp(logit_scale)
    target = torch.arange(n, device=z.device).repeat(buckets)
    rows = F.cross_entropy(z.reshape(b, n), target)
    cols = F.cross_entropy(z.transpose(1, 2).reshape(b, n), target)
    return (rows + cols) / 2


def load_weights(model: nn.Module, weights: Dict[str, torch.Tensor]
                 ) -> nn.Module:
    """Copy ``weights`` (every parameter and buffer by name, float32)
    into ``model``."""
    model.load_state_dict({k: v.float() for k, v in weights.items()},
                          strict=True)
    return model


class SGD:
    """``torch.optim.SGD(lr, momentum, weight_decay, nesterov)``'s update,
    written out, over named float32 leaves."""

    def __init__(self, lr: float, momentum: float, weight_decay: float,
                 nesterov: bool) -> None:
        self.lr, self.mu, self.wd, self.nesterov = (lr, momentum,
                                                    weight_decay, nesterov)
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        for name, p in params.items():
            d = grads[name] + self.wd * p
            if self.mu:
                if name in self.buf:
                    self.buf[name].mul_(self.mu).add_(d)
                else:
                    self.buf[name] = d.clone()
                d = d + self.mu * self.buf[name] if self.nesterov \
                    else self.buf[name]
            p.sub_(self.lr * d)


def train_steps(card: Dict, weights: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]], buckets: int,
                prec: Precision = F32, rows: Optional[int] = None
                ) -> Dict[str, object]:
    """The card's train steps from ``weights`` over ``batches``, one step
    each, no dropout: {"losses": [...], "grad1": first step's gradients,
    "params": the weights after the last step}, float32 on the weights'
    device. ``rows`` keeps the first rows of each batch in ``rows /
    batch`` of the buckets (a fault the check must catch: half the batch
    left out)."""
    device = next(iter(weights.values())).device
    model = load_weights(MultiModel(card).to(device), weights)
    opt = card.get("optim_args") or {}
    sgd = SGD(opt.get("lr", 5e-3), opt.get("momentum", 0.9),
              opt.get("weight_decay", 1e-3), opt.get("nesterov", True))
    params = dict(model.named_parameters())
    losses, grad1 = [], None
    for batch in batches:
        bk = buckets
        if rows is not None:
            n = next(iter(batch.values())).shape[0]
            bk = buckets * rows // n
            batch = {k: v[:rows] for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        img, prof = model.encode(batch, prec, stats={})
        loss = clip_loss(img, prof, params["coordination.logit_scale"], bk,
                         prec)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in grads.items()}
        sgd.step(params, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1,
            "params": {n: p.detach().clone() for n, p in params.items()}}


@torch.no_grad()
def embed(card: Dict, weights: Dict[str, torch.Tensor], batches,
          prec: Precision = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2-normalized (image, profile) embeddings of every batch of the
    iterable, in eval mode (BatchNorm's running statistics), stacked."""
    device = next(iter(weights.values())).device
    model = load_weights(MultiModel(card).to(device), weights)
    imgs, profs = [], []
    for batch in batches:
        i, p = model.encode(batch, prec)
        imgs.append(F.normalize(i, dim=-1))
        profs.append(F.normalize(p, dim=-1))
    return torch.cat(imgs), torch.cat(profs)


@torch.no_grad()
def calibrate(card: Dict, weights: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``weights`` with every BatchNorm's running statistics set to the
    batch statistics of one float32 pass over ``batch`` (a served model's
    statistics describe the data it sees)."""
    device = next(iter(weights.values())).device
    model = load_weights(MultiModel(card).to(device), weights)
    stats: dict = {}
    model.encode(batch, F32, stats)
    out = dict(weights)
    for name, mod in model.named_modules():
        if mod in stats:
            mean, var = stats[mod]
            out[f"{name}.running_mean"] = mean.clone()
            out[f"{name}.running_var"] = var.clone()
    return out


@torch.no_grad()
def knn_votes(queries: Tuple[torch.Tensor, torch.Tensor],
              gallery: torch.Tensor, gallery_ids: torch.Tensor,
              n_classes: int, k: int) -> torch.Tensor:
    """(B, n_classes) summed inverse-distance weights of the k nearest
    gallery rows of each query modality, pooled; a neighbour at distance
    0 takes all the weight of its row (the reference's exact-hit
    rule)."""
    dists, idxs = [], []
    for q in queries:
        d = torch.cdist(q.float(), gallery.float(),
                        compute_mode="donot_use_mm_for_euclid_dist")
        dist, idx = torch.topk(d, k, dim=1, largest=False)
        dists.append(dist)
        idxs.append(idx)
    dist = torch.cat(dists, 1)
    idx = torch.cat(idxs, 1)
    exact = dist == 0
    w = torch.where(exact.any(1, keepdim=True), exact.float(),
                    1.0 / dist.clamp_min(1e-38))
    votes = torch.zeros(dist.shape[0], n_classes, device=dist.device)
    return votes.scatter_add_(1, gallery_ids[idx], w)
