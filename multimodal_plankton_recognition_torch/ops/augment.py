"""Batched train-time augmentation on the card (``ops/augment.py`` of the
JAX package): the random tail of the train transforms — per-sample crop
of the oversize image and profile, vertical flip, N(0, 1e-3) profile
noise, and the pair's joint horizontal flip and time reversal — run
inside the train step on the batch, so the host only delivers the
deterministic oversize prefix (``PackedMultiSet(device_augment=True)``
or the ``*Oversize`` transforms).

Each helper is a draw step and an apply step. The draws come from an
explicit ``torch.Generator`` on the host (the train step's augmentation
generator, seeded from (seed, step)) and go to the batch's device by a
non-blocking copy, so nothing reads a device value on the host; the apply
step takes the draws, so it can be held against the JAX package on JAX's
own draws. Semantics as the host transforms: crop offsets uniform over the
(oversize - target) range, flips with probability 1/2, noise N(0, 1e-3).
Plain torch ops: no Pallas kernel stands behind this module.
"""

from __future__ import annotations

from typing import Dict

import torch

NOISE_SCALE = 1e-3


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def draw_crop(b: int, size: int, target: int,
              generator: torch.Generator) -> torch.Tensor:
    """Per-sample crop offsets, uniform over [0, size - target]."""
    return torch.randint(0, size - target + 1, (b,), generator=generator)


def draw_flip(b: int, generator: torch.Generator) -> torch.Tensor:
    """Per-sample coins, True with probability 1/2."""
    return torch.rand((b,), generator=generator) < 0.5


def draw_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal f32 draws of ``shape``."""
    return torch.randn(shape, generator=generator)


def crop_2d(images: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
            target: int) -> torch.Tensor:
    """Crop (B, H, W, C) to (B, target, target, C) at per-sample offsets."""
    b = images.shape[0]
    ar = torch.arange(target, device=images.device)
    rows = (dy[:, None] + ar)[:, :, None]
    cols = (dx[:, None] + ar)[:, None, :]
    return images[torch.arange(b, device=images.device)[:, None, None],
                  rows, cols]


def crop_1d(profiles: torch.Tensor, start: torch.Tensor,
            target: int) -> torch.Tensor:
    """Crop (B, L, D) to (B, target, D) at per-sample starts."""
    b = profiles.shape[0]
    steps = start[:, None] + torch.arange(target, device=profiles.device)
    return profiles[torch.arange(b, device=profiles.device)[:, None], steps]


def vertical_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], images.flip(1), images)


def joint_horizontal_flip(images: torch.Tensor, profiles: torch.Tensor,
                          flip: torch.Tensor):
    """One coin flips both the image horizontally and the profile in time
    (the reference's PairAugmentation, src/data.py:198-204)."""
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    profiles = torch.where(flip[:, None, None], profiles.flip(1), profiles)
    return images, profiles


def add_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``x`` plus ``NOISE_SCALE`` times the standard normal ``noise``."""
    return x + NOISE_SCALE * noise.to(x.dtype)


def draw_augment(batch: Dict[str, torch.Tensor], target_size: int,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The draws of one batch, on the CPU: image crop (``dy``, ``dx``),
    profile crop (``start``), ``vflip``, ``joint`` flip and ``noise``
    (B, target_size, D)."""
    b, h, w, _ = batch["image"].shape
    _, length, d = batch["profile"].shape
    return {"dy": draw_crop(b, h, target_size, generator),
            "dx": draw_crop(b, w, target_size, generator),
            "start": draw_crop(b, length, target_size, generator),
            "vflip": draw_flip(b, generator),
            "joint": draw_flip(b, generator),
            "noise": draw_noise((b, target_size, d), generator)}


def apply_augment(batch: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor], target_size: int,
                  kind: str = "cnn") -> Dict[str, torch.Tensor]:
    """The augmentation of ``batch`` (image (B, OS, OS, 1) in [-1, 1],
    profile (B, OS, D) normalized; OS = ceil(1.05 * target)) given its
    ``draws``, in the JAX package's order: image crop, vertical flip,
    profile crop, noise, joint flip. Then the tokenize fields of the
    profile encoder ``kind``, rebuilt after the crop: every profile is
    ``target_size`` long, so a transformer gets a zero CLS row, dense
    position ids and an all-False padding mask, an LSTM ``last_idx =
    target_size - 1``, a CNN the profile alone."""
    if kind not in ("transformer", "lstm", "cnn"):
        raise ValueError(f"Unknown profile encoder kind {kind!r}")
    device = batch["image"].device
    draws = {k: v.to(device) for k, v in draws.items()}
    image = crop_2d(batch["image"], draws["dy"], draws["dx"], target_size)
    image = vertical_flip(image, draws["vflip"])
    profile = crop_1d(batch["profile"], draws["start"], target_size)
    profile = add_noise(profile, draws["noise"])
    image, profile = joint_horizontal_flip(image, profile, draws["joint"])
    out = dict(batch)
    out["image"] = image
    b = profile.shape[0]
    if kind == "transformer":
        cls = profile.new_zeros((b, 1, profile.shape[-1]))
        out["profile"] = torch.cat([cls, profile], dim=1)
        out["time"] = torch.arange(target_size + 1, dtype=torch.int32,
                                   device=device).repeat(b, 1)
        out["padding_mask"] = torch.zeros((b, target_size + 1),
                                          dtype=torch.bool, device=device)
    elif kind == "lstm":
        out["profile"] = profile
        out["last_idx"] = torch.full((b,), target_size - 1,
                                     dtype=torch.int32, device=device)
    else:
        out["profile"] = profile
    return out


def multi_train_augment(batch: Dict[str, torch.Tensor], target_size: int,
                        generator: torch.Generator,
                        kind: str = "cnn") -> Dict[str, torch.Tensor]:
    """Device-side tail of the contrastive train transforms: draws from
    ``generator`` (on the host), copied to the batch's device without a
    wait, then ``apply_augment``."""
    device = batch["image"].device
    draws = {k: _to(v, device)
             for k, v in draw_augment(batch, target_size, generator).items()}
    return apply_augment(batch, draws, target_size, kind)
