"""Host-side IO: profile CSV parsing and image decode (``data/profile_io.py``
of the JAX package, without its optional native parser and JPEG decoder,
whose output it equals: profiles parse in numpy, images decode through PIL,
imported inside ``load_image``)."""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np


def _parse(text: str) -> np.ndarray:
    lines = text.splitlines()
    if not lines:
        return np.zeros((0, 6), dtype=np.float32)
    rows = [r for r in lines[1:] if r]  # skip the header and blank lines
    if not rows:
        return np.zeros((0, len(lines[0].split(","))), dtype=np.float32)
    arr = np.array(",".join(rows).split(","), dtype=np.float32)
    return arr.reshape(-1, len(rows[0].split(",")))


def load_profile_csv(path: Path | str) -> np.ndarray:
    """A per-particle profile CSV (one header line, comma-separated float
    columns) as a float32 (L, D) array; L may be 0."""
    with open(path, "rb") as f:
        return _parse(f.read().decode("utf-8", errors="replace"))


def load_image(path: Path | str):
    """The image at ``path`` as a ``PIL.Image``."""
    from PIL import Image

    with open(path, "rb") as f:
        return Image.open(io.BytesIO(f.read()))
