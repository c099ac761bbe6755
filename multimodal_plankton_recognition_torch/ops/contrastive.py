"""Fused bucketed contrastive losses, forward and backward: CLIP and SigLIP.

Port of ``multimodal_plankton_recognition_tpu/ops/pallas/contrastive.py``:
the TPU kernels ``_clip_fwd_kernel`` / ``_clip_bwd_kernel`` become the
hand-written Hopper kernels in ``csrc/clip_loss.cu``, and
``_siglip_fwd_kernel`` / ``_siglip_bwd_kernel`` those in
``csrc/siglip_loss.cu`` (one entry point covers every bucket).
``*_fused_reference`` and ``*_bwd_reference`` are their plain PyTorch
versions, line by line: f32 inside, gradients returned in the embedding
dtype, the cotangent divided by ``buckets`` (``contrastive.py:140, :252``)
and the scalar gradients summed over buckets.

``clip_loss_fused`` and ``siglip_loss_fused`` are the differentiable
entries (``torch.autograd.Function``s): kernels on a CUDA tensor, plain
versions on a CPU tensor, an error otherwise. Their values are the
semantics of ``ops.losses.clip_loss`` and ``ops.losses.siglip_loss``. The
scalars (``logit_scale``, ``logit_bias``) and the cotangent stay on the
device: no step reads them on the host. The CLIP forward keeps its
statistics (each row's and column's lse, the norms: ``clip_fwd(...,
keep=True)``) and the backward takes them, so it needs no second pass
over the logits. The SigLIP backward needs nothing from its forward (dz
depends on z alone, and it takes the norms from its own staged rows). On
the card each wrapper returns the kernels' own scalars: no PyTorch op runs
after a launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import build

__all__ = ["clip_loss_fused", "clip_fwd", "clip_bwd",
           "clip_loss_fused_reference", "clip_loss_bwd_reference",
           "clip_fwd_tile", "clip_bwd_tile", "clip_scratch",
           "siglip_loss_fused", "siglip_fwd", "siglip_bwd",
           "siglip_loss_fused_reference", "siglip_loss_bwd_reference",
           "siglip_fwd_tile", "siglip_bwd_tile", "siglip_scratch"]

_GRAD_TR = 32  # output rows of a d_in / d_pn tile in csrc/contrastive.cuh
_CLIP_FWD_TILE16_ROWS = 128  # see clip_fwd_tile
_SIGLIP_FWD_TILE16_ROWS = 256  # see siglip_fwd_tile
_EPS = 1e-12


def _normalize(x: torch.Tensor):
    """(x / max(||x||, eps), max(||x||, eps)) in f32, as ``_normalize``."""
    nrm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(_EPS)
    return x / nrm, nrm


def _buckets(image_emb, profile_emb, buckets):
    b, d = image_emb.shape
    if b % buckets:
        raise ValueError(f"batch {b} is not divisible by buckets={buckets}")
    n = b // buckets
    return (image_emb.float().reshape(buckets, n, d),
            profile_emb.float().reshape(buckets, n, d), n)


def clip_loss_fused_reference(image_emb: torch.Tensor,
                              profile_emb: torch.Tensor,
                              logit_scale: torch.Tensor,
                              buckets: int = 1, keep: bool = False):
    """Plain version of the forward kernel: per bucket, normalise, logits
    exp(scale)·i·pᵀ, symmetric cross-entropy; mean over buckets (f32).
    With ``keep``, (loss, stats): stats (4, B) f32 holds each row's lse
    over its bucket's columns, each column's lse over its rows, and the
    image and profile norms max(‖x‖, 1e-12), which the backward takes."""
    x, y, n = _buckets(image_emb, profile_emb, buckets)
    i, i_nrm = _normalize(x)
    p, p_nrm = _normalize(y)
    z = (i @ p.transpose(1, 2)) * torch.exp(logit_scale.float())
    diag = torch.diagonal(z, dim1=1, dim2=2)
    lse_r = torch.logsumexp(z, dim=2)
    lse_c = torch.logsumexp(z, dim=1)
    losses = ((lse_r - diag).sum(1) + (lse_c - diag).sum(1)) * 0.5 / n
    if not keep:
        return losses.mean()
    stats = torch.stack([t.reshape(-1) for t in (lse_r, lse_c, i_nrm,
                                                  p_nrm)])
    return losses.mean(), stats


def clip_loss_bwd_reference(image_emb: torch.Tensor,
                            profile_emb: torch.Tensor,
                            logit_scale: torch.Tensor, g: torch.Tensor,
                            buckets: int = 1,
                            stats: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward kernel: (d_image, d_profile) in the
    embedding dtype and d logit_scale (summed over buckets) for the
    cotangent ``g`` of the mean loss. With the forward's ``stats`` the
    norms and both softmaxes come from them (exp(z − lse)); without, as
    the TPU kernel recomputes them."""
    x, y, n = _buckets(image_emb, profile_emb, buckets)
    if stats is None:
        i, i_nrm = _normalize(x)
        p, p_nrm = _normalize(y)
    else:
        lse_r, lse_c, i_nrm, p_nrm = (t.reshape(buckets, n, 1)
                                      for t in stats)
        i, p = x / i_nrm, y / p_nrm
    scale_e = torch.exp(logit_scale.float())
    s = i @ p.transpose(1, 2)
    z = s * scale_e
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    if stats is None:
        soft_r = torch.softmax(z, dim=2)
        soft_c = torch.softmax(z, dim=1)
    else:
        soft_r = torch.exp(z - lse_r)
        soft_c = torch.exp(z - lse_c.transpose(1, 2))
    gb = g.float() / buckets  # d(total)/d(bucket loss)
    dz = gb * 0.5 / n * ((soft_r - eye) + (soft_c - eye))
    d_scale = (dz * s).sum(dim=(1, 2)) * scale_e
    d_s = dz * scale_e
    d_in = d_s @ p
    d_pn = d_s.transpose(1, 2) @ i
    di = (d_in - (d_in * i).sum(-1, keepdim=True) * i) / i_nrm
    dp = (d_pn - (d_pn * p).sum(-1, keepdim=True) * p) / p_nrm
    return (di.reshape(image_emb.shape).to(image_emb.dtype),
            dp.reshape(profile_emb.shape).to(profile_emb.dtype),
            d_scale.sum().to(logit_scale.dtype))


def clip_fwd_tile(n: int) -> int:
    """Rows and columns of the CLIP forward's similarity tiles for buckets
    of ``n``: 16 up to ``_CLIP_FWD_TILE16_ROWS`` rows (more blocks), else
    32 (fewer (max, sum of exp) pairs for the last block to merge); the
    crossover as ``chip_smoke.py --kernel-profile`` times it on the H100."""
    return 16 if n <= _CLIP_FWD_TILE16_ROWS else 32


def clip_bwd_tile(n: int) -> int:
    """The CLIP backward's tiles: 16 for a bucket of one 16-row tile (the
    one-block backward), else 32 (the two-kernel backward, which the
    one-block backward on 32-row tiles lost to on the H100)."""
    return 16 if n <= 16 else 32


def clip_scratch(buckets: int, n: int) -> Dict[str, int]:
    """f32 elements of the CLIP kernels' device scratch for ``buckets`` of
    ``n`` rows (``csrc/clip_loss.cu``): ``fwd``: the (max, sum of exp)
    pairs of every row and column of every tile, then the diagonal;
    ``bwd``: one-block backward, each bucket's d logit_scale partial;
    else the two N x NP operands of d_in and d_pn (NP: n rounded up to
    32), the line partials of q and every tile's d logit_scale partial."""
    rows = buckets * n
    fwd = 4 * rows * -(-n // clip_fwd_tile(n)) + rows
    tile = clip_bwd_tile(n)
    if tile == 16:
        return {"fwd": fwd, "bwd": buckets}
    tiles = -(-n // tile)
    np_ = -(-n // _GRAD_TR) * _GRAD_TR
    return {"fwd": fwd, "bwd": 2 * rows * np_ + 2 * rows * tiles
            + buckets * tiles * tiles}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("clip_loss")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.clip_fwd.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.clip_fwd.restype = ci
    lib.clip_bwd.argtypes = [vp] * 10 + [ci] * 5 + [vp]
    lib.clip_bwd.restype = ci
    return lib


@functools.cache
def _ticket(device: int, stream: int) -> torch.Tensor:
    """The loss kernels' completion ticket for one stream of one card,
    shared by CLIP and SigLIP: a zeroed int32 that every launch leaves at
    0 again, so launches on one stream share it and launches on two
    streams never do."""
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda",
                                                                 device))


def _ticket_ptr(dev: torch.device) -> int:
    return _ticket(dev.index,
                   torch.cuda.current_stream(dev).cuda_stream).data_ptr()


def _on_cpu(image_emb: torch.Tensor, loss: str = "CLIP") -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if image_emb.device.type == "cpu":
        return True
    if image_emb.device.type != "cuda":
        raise ValueError(f"no {loss} kernel for device {image_emb.device}")
    return False


def _check_scalar(name: str, value: torch.Tensor, image_emb: torch.Tensor):
    if (value.numel() != 1 or value.dtype != torch.float32
            or value.device != image_emb.device):
        raise ValueError(f"{name} must be one f32 value on the embeddings' "
                         f"device")


def _check_cuda_args(image_emb, profile_emb, logit_scale, buckets,
                     loss: str = "CLIP"):
    """Validate what the kernels take; return (bucket size, width)."""
    if image_emb.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the {loss} kernels take bf16 or f32 embeddings, "
                        f"got {image_emb.dtype}")
    if (image_emb.dim() != 2 or profile_emb.shape != image_emb.shape
            or profile_emb.dtype != image_emb.dtype
            or profile_emb.device != image_emb.device):
        raise ValueError(f"image and profile embeddings must be (B, D) of "
                         f"one dtype and device, got {tuple(image_emb.shape)} "
                         f"and {tuple(profile_emb.shape)}")
    b, d = image_emb.shape
    if buckets < 1 or b % buckets:
        raise ValueError(f"batch {b} is not divisible by buckets={buckets}")
    _check_scalar("logit_scale", logit_scale, image_emb)
    return b // buckets, d


def _clip_stats(image_emb, profile_emb, logit_scale, buckets, n, d):
    """Launch kernel 5 on contiguous embeddings: (loss, stats)."""
    dev = image_emb.device
    rows = buckets * n
    loss = torch.empty((), dtype=torch.float32, device=dev)
    stats = torch.empty((4, rows), dtype=torch.float32, device=dev)
    scratch = torch.empty(clip_scratch(buckets, n)["fwd"],
                          dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.clip_fwd(image_emb.data_ptr(), profile_emb.data_ptr(),
                           logit_scale.data_ptr(), loss.data_ptr(),
                           stats.data_ptr(), scratch.data_ptr(),
                           _ticket_ptr(dev), buckets, n, d,
                           clip_fwd_tile(n),
                           int(image_emb.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "clip_fwd")
    return loss, stats


def clip_fwd(image_emb: torch.Tensor, profile_emb: torch.Tensor,
             logit_scale: torch.Tensor, buckets: int = 1,
             keep: bool = False):
    """Mean bucketed CLIP loss (f32 scalar): the forward kernel for CUDA
    tensors, the plain version for CPU tensors; with ``keep``, (loss,
    stats), the statistics ``clip_bwd`` takes. ``clip_fwd.launches``
    counts launches."""
    if _on_cpu(image_emb):
        return clip_loss_fused_reference(image_emb, profile_emb, logit_scale,
                                         buckets, keep)
    n, d = _check_cuda_args(image_emb, profile_emb, logit_scale, buckets)
    loss, stats = _clip_stats(image_emb.contiguous(),
                              profile_emb.contiguous(), logit_scale, buckets,
                              n, d)
    clip_fwd.launches += 1
    return (loss, stats) if keep else loss


def clip_bwd(image_emb: torch.Tensor, profile_emb: torch.Tensor,
             logit_scale: torch.Tensor, g: torch.Tensor, buckets: int = 1,
             stats: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_image, d_profile, d_logit_scale) for the cotangent ``g`` of the
    mean loss: the backward kernel for CUDA tensors, the plain version for
    CPU tensors. ``stats``: the forward's (``clip_fwd(..., keep=True)``);
    without them the forward kernel runs first for them (counted here, not
    as ``clip_fwd``): the gradients are the same bits either way.
    ``clip_bwd.launches`` counts calls."""
    if _on_cpu(image_emb):
        return clip_loss_bwd_reference(image_emb, profile_emb, logit_scale,
                                       g, buckets, stats)
    n, d = _check_cuda_args(image_emb, profile_emb, logit_scale, buckets)
    image_emb, profile_emb = image_emb.contiguous(), profile_emb.contiguous()
    dev = image_emb.device
    _check_scalar("g", g, image_emb)
    if stats is None:
        stats = _clip_stats(image_emb, profile_emb, logit_scale, buckets, n,
                            d)[1]
    elif (stats.shape != (4, buckets * n) or stats.dtype != torch.float32
          or stats.device != dev or not stats.is_contiguous()):
        raise ValueError(f"stats must be the forward's contiguous (4, "
                         f"{buckets * n}) f32 statistics on {dev}")
    d_img = torch.empty_like(image_emb)
    d_prof = torch.empty_like(profile_emb)
    d_scale = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(clip_scratch(buckets, n)["bwd"],
                          dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.clip_bwd(image_emb.data_ptr(), profile_emb.data_ptr(),
                           logit_scale.data_ptr(), g.data_ptr(),
                           stats.data_ptr(), d_img.data_ptr(),
                           d_prof.data_ptr(), d_scale.data_ptr(),
                           scratch.data_ptr(), _ticket_ptr(dev),
                           buckets, n, d, clip_bwd_tile(n),
                           int(image_emb.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "clip_bwd")
    clip_bwd.launches += 1
    return d_img, d_prof, d_scale


clip_fwd.launches = 0
clip_bwd.launches = 0


class _ClipLoss(torch.autograd.Function):
    """Forward saves the embeddings, the scale and the forward's statistics
    (lse of every row and column, the norms: 4 B floats); backward
    recomputes the logits (as the TPU kernel does) and returns all three
    gradients."""

    @staticmethod
    def forward(ctx, image_emb, profile_emb, logit_scale, buckets):
        loss, stats = clip_fwd(image_emb, profile_emb, logit_scale, buckets,
                               keep=True)
        ctx.save_for_backward(image_emb, profile_emb, logit_scale, stats)
        ctx.buckets = buckets
        return loss

    @staticmethod
    def backward(ctx, g):
        image_emb, profile_emb, logit_scale, stats = ctx.saved_tensors
        di, dp, ds = clip_bwd(image_emb, profile_emb, logit_scale,
                              g.float().contiguous(), ctx.buckets, stats)
        return di, dp, ds.reshape(logit_scale.shape), None


def clip_loss_fused(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                    logit_scale: torch.Tensor,
                    buckets: int = 1) -> torch.Tensor:
    """Fused bucketed symmetric InfoNCE (semantics of
    ``ops.losses.clip_loss``), differentiable in all three inputs."""
    return _ClipLoss.apply(image_emb, profile_emb, logit_scale, buckets)


def siglip_loss_fused_reference(image_emb: torch.Tensor,
                                profile_emb: torch.Tensor,
                                logit_scale: torch.Tensor,
                                logit_bias: torch.Tensor,
                                buckets: int = 1) -> torch.Tensor:
    """Plain version of the SigLIP forward kernel: per bucket, normalise,
    logits z = exp(scale)·i·pᵀ + bias, labels +1 on the diagonal and −1
    off it, Σ softplus(−y·z) / N (``logaddexp(0, −y·z)``); mean over
    buckets (f32)."""
    x, y, n = _buckets(image_emb, profile_emb, buckets)
    i, _ = _normalize(x)
    p, _ = _normalize(y)
    z = (i @ p.transpose(1, 2)) * torch.exp(logit_scale.float()) \
        + logit_bias.float()
    labels = 2.0 * torch.eye(n, dtype=z.dtype, device=z.device) - 1.0
    xl = labels * z
    losses = torch.logaddexp(torch.zeros_like(xl), -xl).sum(dim=(1, 2)) / n
    return losses.mean()


def siglip_loss_bwd_reference(image_emb: torch.Tensor,
                              profile_emb: torch.Tensor,
                              logit_scale: torch.Tensor,
                              logit_bias: torch.Tensor, g: torch.Tensor,
                              buckets: int = 1
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Plain version of the SigLIP backward kernel: (d_image, d_profile) in
    the embedding dtype, d logit_scale and d logit_bias (summed over
    buckets) for the cotangent ``g`` of the mean loss."""
    x, y, n = _buckets(image_emb, profile_emb, buckets)
    i, i_nrm = _normalize(x)
    p, p_nrm = _normalize(y)
    scale_e = torch.exp(logit_scale.float())
    s = i @ p.transpose(1, 2)
    z = s * scale_e + logit_bias.float()
    labels = 2.0 * torch.eye(n, dtype=z.dtype, device=z.device) - 1.0
    gb = g.float() / buckets  # d(total)/d(bucket loss)
    # d softplus(-y z)/dz = -y * sigmoid(-y z)
    dz = gb / n * (-labels * torch.sigmoid(-labels * z))
    d_scale = (dz * s).sum(dim=(1, 2)) * scale_e
    d_bias = dz.sum(dim=(1, 2))
    d_s = dz * scale_e
    d_in = d_s @ p
    d_pn = d_s.transpose(1, 2) @ i
    di = (d_in - (d_in * i).sum(-1, keepdim=True) * i) / i_nrm
    dp = (d_pn - (d_pn * p).sum(-1, keepdim=True) * p) / p_nrm
    return (di.reshape(image_emb.shape).to(image_emb.dtype),
            dp.reshape(profile_emb.shape).to(profile_emb.dtype),
            d_scale.sum().to(logit_scale.dtype),
            d_bias.sum().to(logit_bias.dtype))


def siglip_fwd_tile(n: int) -> int:
    """Rows and columns of the SigLIP forward's tiles for buckets of ``n``:
    16 up to ``_SIGLIP_FWD_TILE16_ROWS`` rows (more blocks), else 32 (fewer
    partials and less re-staging); the crossover as ``chip_smoke.py
    --kernel-profile``'s ``siglip regimes`` lines time it on the H100. It
    lies above CLIP's (``clip_fwd_tile``): SigLIP's last block adds one
    float a tile, where CLIP's merges (max, sum of exp) pairs of every
    line."""
    return 16 if n <= _SIGLIP_FWD_TILE16_ROWS else 32


def siglip_bwd_tile(n: int) -> int:
    """The SigLIP backward's tiles: 16 for a bucket of one 16-row tile (the
    one-block backward), else 32 (the two-kernel backward), as CLIP's
    (``clip_bwd_tile``)."""
    return clip_bwd_tile(n)


def siglip_scratch(buckets: int, n: int) -> Dict[str, int]:
    """f32 elements of the SigLIP kernels' device scratch for ``buckets``
    of ``n`` rows (``csrc/siglip_loss.cu``): ``fwd``: one partial sum a
    tile; ``bwd``: one-block backward, each bucket's partials of d
    logit_scale and d logit_bias; else the two N x NP operands of d_in and
    d_pn (NP: n rounded up to 32), the line partials of q, the norms (nx
    | ny) and each tile's two partials."""
    rows = buckets * n
    fwd = buckets * (-(-n // siglip_fwd_tile(n))) ** 2
    tile = siglip_bwd_tile(n)
    if tile == 16:
        return {"fwd": fwd, "bwd": 2 * buckets}
    tiles = -(-n // tile)
    np_ = -(-n // _GRAD_TR) * _GRAD_TR
    return {"fwd": fwd, "bwd": 2 * rows * np_ + 2 * rows * tiles + 2 * rows
            + 2 * buckets * tiles * tiles}


@functools.cache
def _siglip_lib() -> ctypes.CDLL:
    lib = build.load("siglip_loss")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.siglip_fwd.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.siglip_fwd.restype = ci
    lib.siglip_bwd.argtypes = [vp] * 11 + [ci] * 5 + [vp]
    lib.siglip_bwd.restype = ci
    return lib


def _siglip_cuda_args(image_emb, profile_emb, logit_scale, logit_bias,
                      buckets):
    """Validate what the SigLIP kernels take; return (bucket size,
    width)."""
    n, d = _check_cuda_args(image_emb, profile_emb, logit_scale, buckets,
                            "SigLIP")
    _check_scalar("logit_bias", logit_bias, image_emb)
    return n, d


def siglip_fwd(image_emb: torch.Tensor, profile_emb: torch.Tensor,
               logit_scale: torch.Tensor, logit_bias: torch.Tensor,
               buckets: int = 1) -> torch.Tensor:
    """Mean bucketed SigLIP loss (f32 scalar): the forward kernel for CUDA
    tensors (one launch, which writes the mean itself), the plain version
    for CPU tensors. ``siglip_fwd.launches`` counts launches."""
    if _on_cpu(image_emb, "SigLIP"):
        return siglip_loss_fused_reference(image_emb, profile_emb,
                                           logit_scale, logit_bias, buckets)
    n, d = _siglip_cuda_args(image_emb, profile_emb, logit_scale, logit_bias,
                             buckets)
    image_emb, profile_emb = image_emb.contiguous(), profile_emb.contiguous()
    dev = image_emb.device
    loss = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(siglip_scratch(buckets, n)["fwd"],
                          dtype=torch.float32, device=dev)
    lib = _siglip_lib()
    with torch.cuda.device(dev):
        err = lib.siglip_fwd(image_emb.data_ptr(), profile_emb.data_ptr(),
                             logit_scale.data_ptr(), logit_bias.data_ptr(),
                             loss.data_ptr(), scratch.data_ptr(),
                             _ticket_ptr(dev), buckets, n, d,
                             siglip_fwd_tile(n),
                             int(image_emb.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "siglip_fwd")
    siglip_fwd.launches += 1
    return loss


def siglip_bwd(image_emb: torch.Tensor, profile_emb: torch.Tensor,
               logit_scale: torch.Tensor, logit_bias: torch.Tensor,
               g: torch.Tensor, buckets: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(d_image, d_profile, d_logit_scale, d_logit_bias) for the cotangent
    ``g`` of the mean loss: the backward kernel for CUDA tensors (one
    launch for buckets of up to 16 rows, two above; the scalars are the
    kernels' own), the plain version for CPU tensors.
    ``siglip_bwd.launches`` counts calls."""
    if _on_cpu(image_emb, "SigLIP"):
        return siglip_loss_bwd_reference(image_emb, profile_emb, logit_scale,
                                         logit_bias, g, buckets)
    n, d = _siglip_cuda_args(image_emb, profile_emb, logit_scale, logit_bias,
                             buckets)
    _check_scalar("g", g, image_emb)
    image_emb, profile_emb = image_emb.contiguous(), profile_emb.contiguous()
    dev = image_emb.device
    d_img = torch.empty_like(image_emb)
    d_prof = torch.empty_like(profile_emb)
    d_scale = torch.empty((), dtype=torch.float32, device=dev)
    d_bias = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty(siglip_scratch(buckets, n)["bwd"],
                          dtype=torch.float32, device=dev)
    lib = _siglip_lib()
    with torch.cuda.device(dev):
        err = lib.siglip_bwd(image_emb.data_ptr(), profile_emb.data_ptr(),
                             logit_scale.data_ptr(), logit_bias.data_ptr(),
                             g.data_ptr(), d_img.data_ptr(),
                             d_prof.data_ptr(), d_scale.data_ptr(),
                             d_bias.data_ptr(), scratch.data_ptr(),
                             _ticket_ptr(dev), buckets, n, d,
                             siglip_bwd_tile(n),
                             int(image_emb.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "siglip_bwd")
    siglip_bwd.launches += 1
    return d_img, d_prof, d_scale, d_bias


siglip_fwd.launches = 0
siglip_bwd.launches = 0


class _SiglipLoss(torch.autograd.Function):
    """Forward saves the embeddings and both scalars; backward recomputes
    the logits (as the TPU kernel does) and returns all four gradients."""

    @staticmethod
    def forward(ctx, image_emb, profile_emb, logit_scale, logit_bias,
                buckets):
        ctx.save_for_backward(image_emb, profile_emb, logit_scale,
                              logit_bias)
        ctx.buckets = buckets
        return siglip_fwd(image_emb, profile_emb, logit_scale, logit_bias,
                          buckets)

    @staticmethod
    def backward(ctx, g):
        image_emb, profile_emb, logit_scale, logit_bias = ctx.saved_tensors
        di, dp, ds, db = siglip_bwd(image_emb, profile_emb, logit_scale,
                                    logit_bias, g.float().contiguous(),
                                    ctx.buckets)
        return (di, dp, ds.reshape(logit_scale.shape),
                db.reshape(logit_bias.shape), None)


def siglip_loss_fused(image_emb: torch.Tensor, profile_emb: torch.Tensor,
                      logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                      buckets: int = 1) -> torch.Tensor:
    """Fused bucketed SigLIP (semantics of ``ops.losses.siglip_loss``),
    differentiable in all four inputs."""
    return _SiglipLoss.apply(image_emb, profile_emb, logit_scale, logit_bias,
                             buckets)
