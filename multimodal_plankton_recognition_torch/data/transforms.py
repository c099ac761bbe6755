"""Image and profile transforms (``data/transforms.py`` of the JAX
package): the eval transforms ``ImageTransformTest`` and
``ProfileTransformTest``; the raw transforms of the supervised
classifiers, ``ImageTransforms`` (background statistics from the rim, the
scale bar covered and the image padded to a square with background noise,
a LANCZOS resize) and ``ProfileTransform`` (log1p, an optional resample); the random train transforms
``ImageTransformTrain``, ``ProfileTransformTrain`` and the joint flip
``PairAugmentation`` of the CSV path; the oversize train prefixes
``ImageTransformOversize`` and ``ProfileTransformOversize`` (whose random
crop, flips and noise run later, on the card in ``ops.augment`` or on the
host in ``data.packed``); and the helpers they call, in numpy. PIL is
imported inside the image functions.

The random transforms draw from the one ``numpy.random.Generator`` a
sample is given, in the JAX package's order: the image crop (dy, then dx)
and its flip coin (``ImageTransforms``: the scale bar's noise, then the
padding's), the profile crop start and its noise, then the pair's coin.
With the same generator they give the JAX package's bits.

Conventions: images come out channel-last ``(H, W, 1)`` float32 in [-1, 1];
profiles ``(L, D)`` float32 with D = 6 pulse channels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# Per-channel log-space ceilings, log(1 + max) over the training corpora
PROFILE_LOG_CEILINGS = np.array(
    [9.6058, 8.9211, 8.9211, 8.9211, 8.9211, 8.9211], dtype=np.float32)

SCALEBAR_ROWS = 25  # the burned-in scale bar occupies the top 25 px

_default_rng = np.random.default_rng(0)


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else _default_rng


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


def find_background_stats(image: np.ndarray, p: int = 2,
                          closest: float = 0.80
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Background mode and std from the image rim of thickness ``p``: the
    per-channel mode over the first and last ``p`` rows and columns, the
    std over the ``closest`` fraction of rim pixels nearest (L2) to it."""
    c = 1 if image.ndim < 3 else image.shape[-1]
    edges = np.concatenate([image[:, :p].reshape(-1, c),
                            image[:, -p:].reshape(-1, c),
                            image[:p, :].reshape(-1, c),
                            image[-p:, :].reshape(-1, c)], axis=0)
    color_mode = np.empty(c, dtype=edges.dtype)
    for ch in range(c):
        vals, counts = np.unique(edges[:, ch], return_counts=True)
        color_mode[ch] = vals[np.argmax(counts)]
    n_closest = int(edges.shape[0] * closest)
    distances = np.sum((edges.astype(np.int64)
                        - color_mode.astype(np.int64)) ** 2, axis=1)
    closest_indices = np.argpartition(
        distances, min(n_closest, len(distances) - 1))[:n_closest]
    color_std = np.std(edges[closest_indices].astype(float), axis=0)
    return color_mode, color_std


def cover_scale(image: np.ndarray, bg: np.ndarray, std: np.ndarray,
                rng: Optional[np.random.Generator] = None,
                rows: int = SCALEBAR_ROWS) -> np.ndarray:
    """Overwrite the burned-in scale bar (top ``rows`` px) with Gaussian
    background noise."""
    g = _rng(rng)
    image = image.copy()
    noise = g.normal(loc=float(np.mean(bg)), scale=float(np.mean(std)) + 1e-8,
                     size=image[:rows].shape)
    image[:rows] = np.clip(noise, 0, 255).astype(image.dtype)
    return image


def pad_image_to_square(image: np.ndarray, bg: np.ndarray, std: np.ndarray,
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
    """Center-pad to a square with background noise (no draw when the
    image is square already)."""
    g = _rng(rng)
    height, width = image.shape[:2]
    max_side = max(height, width)
    y_from = (max_side - height) // 2
    x_from = (max_side - width) // 2
    if x_from > 0 or y_from > 0:
        shape = (max_side, max_side) + image.shape[2:]
        canvas = np.full(shape, fill_value=float(np.mean(bg)),
                         dtype=np.float64)
        canvas += g.normal(loc=0.0, scale=float(np.mean(std)) + 1e-8,
                           size=shape)
        out = np.clip(canvas, 0, 255).astype(image.dtype)
        out[y_from:y_from + height, x_from:x_from + width] = image
        return out
    return image


def to_grayscale(arr: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma, as torchvision's ``rgb_to_grayscale`` (exact for
    the grayscale crops, where R = G = B)."""
    if arr.ndim == 2:
        return arr
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    lum = 0.2989 * r + 0.587 * g + 0.114 * b
    if arr.dtype == np.uint8:
        return lum.astype(np.uint8)
    return lum.astype(arr.dtype)


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


class ImageTransforms:
    """Raw canonicalization of the supervised baselines: background
    statistics from the rim, the scale bar overwritten with background
    noise, a center pad to a square with background noise, then (with
    ``target_size``) a LANCZOS resize to ``target_size`` square; float
    [0, 1], (H, W, 1). Takes a ``PIL.Image`` (decoded to L) or a uint8
    array (an RGB one goes through ``to_grayscale``)."""

    def __init__(self, target_size: Optional[int] = 224) -> None:
        self.target_size = target_size

    def __call__(self, image, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
        if not isinstance(image, np.ndarray):
            image = np.asarray(image.convert("L"))
        elif image.ndim == 3:
            image = to_grayscale(image)
        bg, std = find_background_stats(image)
        image = cover_scale(image, bg, std, rng)
        image = pad_image_to_square(image, bg, std, rng)
        if self.target_size is not None and \
                image.shape[0] != self.target_size:
            from PIL import Image

            image = np.asarray(Image.fromarray(image).resize(
                (self.target_size, self.target_size),
                Image.Resampling.LANCZOS))
        out = image.astype(np.float32) / 255.0
        return out[..., None]


class ProfileTransform:
    """Raw profile transform: log1p, then a linear resample to
    ``max_len`` when it is set (0 or None: the profile's own length)."""

    def __init__(self, max_len: Optional[int] = None) -> None:
        self.max_len = max_len

    def __call__(self, profile: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        profile = np.log1p(np.asarray(profile, dtype=np.float32))
        if self.max_len:
            profile = resample_linear(profile, self.max_len)
        return profile


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


class ImageTransformOversize:
    """Deterministic prefix of the train image transform: crop the scale
    bar, resize to ceil(1.05 * target) with edge padding, rescale to
    [-1, 1]. The random crop and flips come after it."""

    def __init__(self, target_size: int = 224) -> None:
        self.oversize = math.ceil(1.05 * target_size)

    def __call__(self, img, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
        img = img.convert("L")
        img = img.crop((0, SCALEBAR_ROWS, img.width, img.height))
        arr = resize_edge(img, self.oversize)
        return (arr.astype(np.float32) / 255.0 * 2.0 - 1.0)[..., None]


class ProfileTransformOversize:
    """Deterministic prefix of the train profile transform: log1p,
    ceiling-normalize, [-1, 1], resample to ceil(1.05 * target). The
    random crop and noise come after it."""

    def __init__(self, target_size: int = 224,
                 ceilings: np.ndarray = PROFILE_LOG_CEILINGS) -> None:
        self.oversize = math.ceil(1.05 * target_size)
        self.ceilings = np.asarray(ceilings, dtype=np.float32)

    def __call__(self, profile: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        x = np.log1p(np.asarray(profile, dtype=np.float32))
        x = x / self.ceilings[:x.shape[-1]] * 2.0 - 1.0
        return resample_linear(x, self.oversize).astype(np.float32)


class ImageTransformTrain:
    """The oversize prefix (``ImageTransformOversize``), then a random
    ``target_size`` crop (offsets dy, then dx) and a vertical flip on a
    coin's 0."""

    def __init__(self, target_size: int = 224) -> None:
        self.target_size = target_size
        self.prefix = ImageTransformOversize(target_size)

    def __call__(self, img, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
        g = _rng(rng)
        x = self.prefix(img)
        t = self.target_size
        dy = int(g.integers(0, x.shape[0] - t + 1))
        dx = int(g.integers(0, x.shape[1] - t + 1))
        x = x[dy:dy + t, dx:dx + t]
        if g.integers(0, 2) == 0:
            x = x[::-1]
        return np.ascontiguousarray(x)


class ProfileTransformTrain:
    """The oversize prefix (``ProfileTransformOversize``), then a random
    ``target_size`` crop and N(0, 1e-3) noise."""

    def __init__(self, target_size: int = 224,
                 ceilings: np.ndarray = PROFILE_LOG_CEILINGS) -> None:
        self.target_size = target_size
        self.prefix = ProfileTransformOversize(target_size, ceilings)

    def __call__(self, profile: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        g = _rng(rng)
        x = self.prefix(profile)
        start = int(g.integers(0, x.shape[0] - self.target_size + 1))
        x = x[start:start + self.target_size]
        x = x + 1e-3 * g.standard_normal(x.shape).astype(np.float32)
        return x.astype(np.float32)


class PairAugmentation:
    """On a coin's 0, flip the image horizontally and reverse the profile
    in time together, so the two modalities stay consistent."""

    def __call__(self, image: np.ndarray, profile: np.ndarray,
                 rng: Optional[np.random.Generator] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        if _rng(rng).integers(0, 2) == 0:
            image = np.ascontiguousarray(image[:, ::-1])
            profile = np.ascontiguousarray(profile[::-1])
        return image, profile
