"""Eval-time image and profile transforms (``data/transforms.py`` of the
JAX package): ``ImageTransformTest``, ``ProfileTransformTest`` and the
helpers they call, in numpy. PIL is imported inside the image functions.

Conventions: images come out channel-last ``(H, W, 1)`` float32 in [-1, 1];
profiles ``(L, D)`` float32 with D = 6 pulse channels.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

# Per-channel log-space ceilings, log(1 + max) over the training corpora
PROFILE_LOG_CEILINGS = np.array(
    [9.6058, 8.9211, 8.9211, 8.9211, 8.9211, 8.9211], dtype=np.float32)

SCALEBAR_ROWS = 25  # the burned-in scale bar occupies the top 25 px


def resize_edge(img, target_res: int = 224) -> np.ndarray:
    """Aspect-preserving LANCZOS resize of a ``PIL.Image``'s long side to
    ``target_res``, then center-pad the short side by edge replication;
    uint8 (target_res, target_res[, C])."""
    from PIL import Image

    w, h = img.size
    if h <= w:
        new_h = int(np.around(target_res * h / w))
        arr = np.asarray(img.resize((target_res, new_h),
                                    Image.Resampling.LANCZOS))
        top = (target_res - new_h) // 2
        pad = [(top, target_res - new_h - top), (0, 0)]
    else:
        new_w = int(np.around(target_res * w / h))
        arr = np.asarray(img.resize((new_w, target_res),
                                    Image.Resampling.LANCZOS))
        left = (target_res - new_w) // 2
        pad = [(0, 0), (left, target_res - new_w - left)]
    return np.pad(arr, pad + [(0, 0)] * (arr.ndim - 2), mode="edge")


def resample_linear(profile: np.ndarray, target_len: int,
                    antialias: bool = True) -> np.ndarray:
    """Resample a (L, D) profile to (target_len, D) along time, as
    torchvision's bilinear ``Resize`` with ``antialias=True`` and
    ``align_corners=False``: output sample i maps to input coordinate
    (i + 0.5) · L / target_len − 0.5, and downsampling applies a triangle
    filter of support L / target_len, truncated at the ends and
    renormalized."""
    profile = np.asarray(profile, dtype=np.float32)
    L = profile.shape[0]
    if L == 0:  # a profile whose every row was dropped: silence
        return np.zeros((target_len, profile.shape[1]), np.float32)
    if L == target_len:
        return profile
    scale = L / target_len
    support = max(1.0, scale) if antialias else 1.0
    centers = (np.arange(target_len, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(centers - support).astype(np.int64)
    idx = lo[:, None] + np.arange(int(math.ceil(2 * support)) + 1)[None, :]
    weights = np.clip(1.0 - np.abs(idx - centers[:, None]) / support, 0.0,
                      None)
    weights = np.where((idx >= 0) & (idx < L), weights, 0.0)
    idx = np.clip(idx, 0, L - 1)
    weights = weights / np.maximum(weights.sum(axis=1, keepdims=True), 1e-12)
    return np.einsum("tw,twd->td", weights, profile[idx]).astype(np.float32)


class ImageTransformTest:
    """Crop the top scale-bar rows, resize the long side to
    ``target_size`` with edge padding, grayscale, scale to [-1, 1]."""

    def __init__(self, target_size: int = 224) -> None:
        self.target_size = target_size

    def __call__(self, img, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
        img = img.convert("L")
        img = img.crop((0, SCALEBAR_ROWS, img.width, img.height))
        arr = resize_edge(img, self.target_size)
        return (arr.astype(np.float32) / 255.0 * 2.0 - 1.0)[..., None]


class ProfileTransformTest:
    """log1p, divide by the per-channel log ceilings, scale to [-1, 1],
    resample to exactly ``target_size``."""

    def __init__(self, target_size: int = 224,
                 ceilings: np.ndarray = PROFILE_LOG_CEILINGS) -> None:
        self.target_size = target_size
        self.ceilings = np.asarray(ceilings, dtype=np.float32)

    def __call__(self, profile: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        x = np.log1p(np.asarray(profile, dtype=np.float32))
        x = x / self.ceilings[:x.shape[-1]] * 2.0 - 1.0
        return resample_linear(x, self.target_size).astype(np.float32)
