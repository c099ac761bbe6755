"""Synthetic CytoSense-like dataset for tests and CPU runs
(``data/synthetic.py`` of the JAX package): for the same seed the same
files, byte for byte.

The layout is the real data's: grayscale JPEG crops with a burned-in
scale bar in the top 25 rows, a 6-column profile CSV per particle, and an
``annotations.csv`` (``image, profile, class``); with ``with_split``, a
``split/`` directory holding ``train.csv`` and ``test.csv`` (half of each
class, shuffled, paths relative to it). The tables are written with the
``csv`` module as pandas writes them; PIL is imported inside.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

PROFILE_COLUMNS = ["FSC", "SSC", "Green", "Yellow", "Orange", "Red"]


def _write_table(path: Path, header, rows) -> None:
    """A CSV as pandas' ``to_csv(index=False)`` writes it: ``\\n`` line
    ends, fields quoted only where needed, floats as numpy prints them."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def _shuffled(n: int, seed: int) -> np.ndarray:
    """The row order of pandas' ``sample(frac=1.0, random_state=seed)``
    on ``n`` rows: ``RandomState(seed).choice(n, n, replace=False)``,
    which is the permutation of a fresh ``RandomState(seed)``."""
    return np.random.RandomState(seed).permutation(n)


def make_synthetic_dataset(root: Path | str, n_classes: int = 3,
                           n_per_class: int = 8, seed: int = 0,
                           image_size_range: tuple[int, int] = (80, 160),
                           profile_len_range: tuple[int, int] = (40, 400),
                           with_split: bool = True) -> Path:
    """Write the dataset under ``root``; returns the split directory
    (``with_split``) or ``root``. Each class is its own blob shape and
    brightness and its own profile frequency, so a model can learn to
    separate them."""
    from PIL import Image

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    rows = []
    for c in range(n_classes):
        cls = f"genus_{c}"
        (root / cls).mkdir(exist_ok=True)
        for i in range(n_per_class):
            h = int(rng.integers(*image_size_range))
            w = int(rng.integers(*image_size_range))
            img = rng.normal(200, 5, size=(h, w))
            yy, xx = np.mgrid[0:h, 0:w]
            cy = h // 2 + rng.integers(-5, 6)
            cx = w // 2 + rng.integers(-5, 6)
            r = (min(h, w) // 4) * (1 + 0.3 * c)
            blob = ((yy - cy) ** 2 / (r ** 2) + (xx - cx) ** 2 /
                    ((r * (1 + 0.5 * c)) ** 2)) < 1.0
            img[blob] = 60 + 40 * c + rng.normal(0, 5, size=blob.sum())
            img[:25] = 255  # the scale bar strip
            img[5:8, 5:30] = 0
            img = np.clip(img, 0, 255).astype(np.uint8)
            img_rel = f"{cls}/img_{i:04d}.jpg"
            Image.fromarray(img, mode="L").save(root / img_rel, quality=92)

            length = int(rng.integers(*profile_len_range))
            t = np.linspace(0, 1, length)
            base = (np.sin(2 * np.pi * (2 + 3 * c) * t) + 1.2) \
                * (500 + 300 * c)
            prof = np.stack(
                [base * (1 + 0.1 * k) + rng.gamma(2.0, 20.0, size=length)
                 for k in range(6)], axis=1)
            prof = np.clip(prof, 1.0, None)
            prof_rel = f"{cls}/prof_{i:04d}.csv"
            _write_table(root / prof_rel, PROFILE_COLUMNS, prof.astype(str))
            rows.append((img_rel, prof_rel, cls))

    header = ["image", "profile", "class"]
    _write_table(root / "annotations.csv", header, rows)
    if not with_split:
        return root
    split_dir = root / "split"
    split_dir.mkdir(exist_ok=True)
    train, test = [], []
    for cls in sorted({r[2] for r in rows}):
        group = [r for r in rows if r[2] == cls]
        group = [group[i] for i in _shuffled(len(group), seed)]
        k = max(1, len(group) // 2)
        train += group[:k]
        test += group[k:]
    for name, part in (("train", train), ("test", test)):
        _write_table(split_dir / f"{name}.csv", header,
                     [("../" + i, "../" + p, c) for i, p, c in part])
    return split_dir
