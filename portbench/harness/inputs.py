"""The traffic's inputs, made from the run's seed.

Class-structured pairs over long-tailed labels: the generators of the
port's card smoke run (``chip_smoke.py`` ``_long_tailed_labels``,
``_image_prototypes``, ``_profile_tokens`` and ``_class_inputs``), copied
here so the benchmark's yardstick cannot move with that script, and
vectorized, so every seed draws the same amount of noise and makes the
same work. The layout is the port's collates' (``data/pipeline.py``):
``image`` (B, S, S, 1) float32, ``image_shape`` (B, 2) int32,
``profile_len`` (B, 1) int32, and for a transformer profile encoder
``profile`` (B, S + 1, 6) with the CLS row, ``time`` and
``padding_mask`` (``data/tokenize.py`` ``tokenize_transformer``); for a
CNN ``profile`` (B, S, 6), the eval pipeline's resampled length.

The class prototypes are the same for every seed (``PROTOTYPE_SEED``);
the seed draws the labels and the noise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PROTOTYPE_SEED = 0


def seed_words(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run: (seed, stream) hashed, so
    any whole seed, however large or negative, gives independent
    streams."""
    state = np.random.SeedSequence(
        [seed % 2 ** 64, *stream]).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed, *stream))


def device_generator(device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        seed_words(seed, *stream))


def long_tailed_labels(n: int, classes: int, gen: np.random.Generator
                       ) -> np.ndarray:
    """``n`` class ids over ``classes`` classes with counts n (1/c) / H,
    floored, the remainder in class 0 (the most common), shuffled."""
    harmonic = sum(1.0 / c for c in range(1, classes + 1))
    counts = [int(n / c / harmonic) for c in range(1, classes + 1)]
    counts[0] += n - sum(counts)
    return gen.permutation(np.repeat(np.arange(classes), counts))


def image_prototypes(classes: int, size: int, device) -> torch.Tensor:
    """One image a class, (classes, size, size, 1): a random 16 x 16 tile
    in [-1, 1] repeated over the image, so every ViT patch of a class
    starts from the same pixels."""
    gen = torch.Generator(device=device).manual_seed(PROTOTYPE_SEED)
    tile = torch.rand((classes, 16, 16), generator=gen, device=device) * 2 - 1
    reps = -(-size // 16)
    return tile.repeat(1, reps, reps)[:, :size, :size, None]


def profile_prototypes(classes: int) -> Dict[str, np.ndarray]:
    proto = np.random.RandomState(PROTOTYPE_SEED)
    return {"level": proto.uniform(-1.0, 1.0, (classes, 6)),
            "freq": proto.uniform(1.0, 6.0, (classes, 1)),
            "phase": proto.uniform(0.0, 2 * np.pi, (classes, 6))}


def profiles(labels: np.ndarray, classes: int, steps: int, kind: str,
             gen: np.random.Generator) -> Dict[str, np.ndarray]:
    """Tokenized profiles of ``labels``: each its class's level and
    waveform over the 6 channels plus N(0, 0.3²) noise. ``kind``
    "transformer": ragged lengths ``steps`` / 2 to ``steps`` (the
    key-padding mask is live), a zero CLS row first, positions 0..L and
    ``steps + 1`` on padding, ``steps + 1`` tokens; "cnn": ``steps``
    steps each."""
    n = len(labels)
    p = profile_prototypes(classes)
    if kind == "transformer":
        lengths = gen.integers(steps // 2, steps + 1, n)
    elif kind == "cnn":
        lengths = np.full(n, steps)
    else:
        raise ValueError(f"no profile generator for kind {kind!r}")
    j = np.arange(steps)
    t = j[None, :] / np.maximum(lengths - 1, 1)[:, None]
    wave = np.sin(2 * np.pi * p["freq"][labels][:, :, None] * t[:, None, :]
                  + p["phase"][labels][:, :, None])  # (n, 6, steps)
    noise = 0.3 * gen.standard_normal((n, steps, 6))
    x = (p["level"][labels][:, None, :] + 0.5 * wave.transpose(0, 2, 1)
         + noise).astype(np.float32)
    live = j[None, :] < lengths[:, None]
    x *= live[..., None]
    if kind == "cnn":
        return {"profile": x}
    tokens = np.zeros((n, steps + 1, 6), np.float32)
    tokens[:, 1:] = x
    pos = np.arange(steps + 1)[None, :]
    mask = pos > lengths[:, None]
    time = np.where(mask, steps + 1, pos).astype(np.int32)
    return {"profile": tokens, "time": time, "padding_mask": mask}


def pairs(labels: np.ndarray, classes: int, size: int, kind: str,
          seed: int, *stream: int, device) -> Dict[str, torch.Tensor]:
    """Class-structured pairs of ``labels`` on ``device``: images are
    their class's prototype plus N(0, 0.5²) noise drawn on the device,
    the rest drawn on the host; every key of the collates."""
    gen = rng(seed, *stream)
    n = len(labels)
    dgen = device_generator(device, seed, *stream)
    idx = torch.as_tensor(labels, device=device)
    out = {"image": image_prototypes(classes, size, device)[idx]
           + 0.5 * torch.randn((n, size, size, 1), generator=dgen,
                               device=device)}
    host = {"image_shape": gen.integers(50, 400, (n, 2)).astype(np.int32),
            **profiles(labels, classes, size, kind, gen),
            "profile_len": gen.integers(20, 2000, (n, 1)).astype(np.int32)}
    out.update({k: torch.as_tensor(v).to(device) for k, v in host.items()})
    return out
