"""Packed input cache (``data/packed.py`` of the JAX package): the
deterministic prefix of each transform, decoded and resized once, read
from numpy memmaps at train and serve time.

The layout is the JAX package's, byte for byte, so a cache it packed reads
here unchanged (and the other way round):

    <dataset>/packed_t<target>/<split>/
        images.npy    (N, S, S)  uint8   S = ceil(1.05*t) train, t test
        profiles.npy  (N, P, D)  float32 P = ceil(1.05*t) train, t test
        shapes.npy    (N, 2)     int32   original (height, width)
        lens.npy      (N, 1)     int32   original profile length
        labels.npy    (N,)       unicode class names
        meta.json     target_size / split / row count / source mtime guard

Train images are the uint8 plane of the scale-bar crop and LANCZOS
oversize resize (the float scaling ``arr/255*2-1`` comes after it, so the
cache is bit-identical to the CSV path); train profiles the log1p →
ceiling-normalize → resample-to-oversize f32 output; test images and
profiles the whole eval transform.

``PackedMultiSet`` reads the cache with numpy alone: its stale guard
reads the annotation CSV with the ``csv`` module, so a machine without
pandas or PIL reads real pairs. ``pack_split`` (the CLI
``scripts/pack_dataset_torch.py``) writes a cache; it imports pandas and
PIL when called.
"""

from __future__ import annotations

import csv
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .transforms import (
    SCALEBAR_ROWS, ImageTransformOversize, ImageTransformTest,
    ProfileTransformOversize, ProfileTransformTest, _rng, resize_edge,
)


def _payload_fingerprint(images: Sequence[str], profiles: Sequence[str],
                         parent: Path, k: int = 8):
    """(size, mtime_ns) of up to ``k`` image and profile payload files
    spread across the table: a cheap stale guard for payloads regenerated
    without touching the annotation CSV (whose own mtime and row count are
    checked separately)."""
    n = len(images)
    idx = sorted({int(i) for i in np.linspace(0, n - 1, num=min(k, n))})
    fp = []
    for i in idx:
        for col, paths in (("image", images), ("profile", profiles)):
            st = (parent / paths[i]).stat()
            fp.append([int(i), col, st.st_size, st.st_mtime_ns])
    return fp


def _read_rows(annotation_path: Path) -> List[Dict[str, str]]:
    """The annotation table's data rows (blank lines skipped, as pandas
    skips them)."""
    with open(annotation_path, newline="") as f:
        return list(csv.DictReader(f))


def cache_dir(annotation_path: Path | str, target_size: int) -> Path:
    p = Path(annotation_path)
    return p.parent / f"packed_t{target_size}" / p.stem


def pack_split(annotation_path: Path | str, target_size: int,
               out_dir: Optional[Path] = None) -> Path:
    """Materialize the packed cache for one split CSV. The split kind is
    the file stem: ``train`` packs the oversize train prefix, anything else
    packs the deterministic eval output."""
    import pandas as pd

    from .profile_io import load_image, load_profile_csv

    annotation_path = Path(annotation_path)
    train = annotation_path.stem == "train"
    out = Path(out_dir) if out_dir else cache_dir(annotation_path,
                                                  target_size)
    out.mkdir(parents=True, exist_ok=True)
    table = pd.read_csv(annotation_path)
    parent = annotation_path.parent
    n = len(table)
    if n == 0:
        raise ValueError(
            f"{annotation_path} has no data rows — refusing to build an "
            f"empty packed cache (PackedMultiSet could not load it)")
    side = math.ceil(1.05 * target_size) if train else target_size
    prof_tf = (ProfileTransformOversize(target_size) if train
               else ProfileTransformTest(target_size))
    # pack-time oracle: the float path whose uint8 plane is stored
    img_tf = (ImageTransformOversize(target_size) if train
              else ImageTransformTest(target_size))

    images = np.lib.format.open_memmap(
        out / "images.npy", mode="w+", dtype=np.uint8, shape=(n, side, side))
    profiles = None  # dtype and width fixed by the first sample
    shapes = np.zeros((n, 2), np.int32)
    lens = np.zeros((n, 1), np.int32)
    for i in range(n):
        img = load_image(parent / table["image"].iloc[i])
        shapes[i] = (img.height, img.width)
        # the shared uint8 prefix of both image transforms: grayscale,
        # scale-bar crop, LANCZOS + edge resize
        gray = img.convert("L")
        gray = gray.crop((0, SCALEBAR_ROWS, gray.width, gray.height))
        arr = resize_edge(gray, side)
        images[i] = arr
        if i < 4:  # self-check the stored plane against the float oracle
            recon = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
            np.testing.assert_array_equal(recon[..., None], img_tf(img))
        prof = load_profile_csv(parent / table["profile"].iloc[i])
        lens[i] = prof.shape[0]
        y = prof_tf(prof)
        if profiles is None:
            profiles = np.lib.format.open_memmap(
                out / "profiles.npy", mode="w+", dtype=np.float32,
                shape=(n,) + y.shape)
        profiles[i] = y
    images.flush()
    profiles.flush()
    np.save(out / "shapes.npy", shapes)
    np.save(out / "lens.npy", lens)
    np.save(out / "labels.npy", table["class"].to_numpy(dtype=np.str_))
    (out / "meta.json").write_text(json.dumps({
        "target_size": target_size, "train": train, "rows": n,
        "source": annotation_path.name,
        "source_mtime": annotation_path.stat().st_mtime,
        "payload_fingerprint": _payload_fingerprint(
            table["image"].tolist(), table["profile"].tolist(), parent),
    }))
    return out


class PackedMultiSet:
    """Memmap-backed counterpart of ``MultiSet`` over a packed cache: the
    same item dict (``image``, ``profile``, ``label``, ``image_shape``,
    ``profile_length``), ``labels`` (class names, one a row) and
    ``class_names``.

    ``device_augment=True`` returns the stored oversize prefix unchanged
    (the random crop, flips and noise run on the card,
    ``ops.augment.multi_train_augment``); otherwise a train split replays
    the CSV path's random suffix with the same numpy draw order.
    """

    def __init__(self, annotation_path: Path | str, target_size: int,
                 device_augment: bool = False) -> None:
        annotation_path = Path(annotation_path)
        self.annotation_path = annotation_path
        self.train = annotation_path.stem == "train"
        self.target_size = target_size
        self.oversize = math.ceil(1.05 * target_size)
        self.device_augment = device_augment
        root = cache_dir(annotation_path, target_size)
        meta_path = root / "meta.json"
        if not meta_path.exists():
            raise FileNotFoundError(
                f"no packed cache at {root} — build it with "
                f"scripts/pack_dataset_torch.py -d {annotation_path.parent} "
                f"-t {target_size}")
        meta = json.loads(meta_path.read_text())
        rows = _read_rows(annotation_path)
        if meta["source_mtime"] != annotation_path.stat().st_mtime \
                or meta["rows"] != len(rows):
            raise RuntimeError(
                f"packed cache at {root} is stale (source csv changed) — "
                f"re-run scripts/pack_dataset_torch.py")
        # payload files regenerated without touching the csv must also
        # invalidate the cache
        want = meta.get("payload_fingerprint")
        if want is not None and _payload_fingerprint(
                [r["image"] for r in rows], [r["profile"] for r in rows],
                annotation_path.parent) != want:
            raise RuntimeError(
                f"packed cache at {root} is stale (image/profile payload "
                f"files changed since packing) — re-run "
                f"scripts/pack_dataset_torch.py")
        self.images = np.load(root / "images.npy", mmap_mode="r")
        self.profiles = np.load(root / "profiles.npy", mmap_mode="r")
        self.shapes = np.load(root / "shapes.npy")
        self.lens = np.load(root / "lens.npy")
        self.labels = np.load(root / "labels.npy")
        self.class_names = np.unique(self.labels)

    def __len__(self) -> int:
        return len(self.labels)

    def __getstate__(self):
        """A pickle holds the paths, not the arrays: a worker process of
        ``data.grain_pipeline.GrainLoader`` re-opens the memmaps."""
        return {"annotation_path": str(self.annotation_path),
                "target_size": self.target_size,
                "device_augment": self.device_augment}

    def __setstate__(self, state):
        self.__init__(state["annotation_path"], state["target_size"],
                      device_augment=state["device_augment"])

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        g = _rng(rng)
        arr = self.images[index]                       # uint8, memmap read
        prof = np.asarray(self.profiles[index])
        t = self.target_size
        if self.train and not self.device_augment:
            # the CSV path's draw order: image dy, dx, vertical flip; the
            # uint8 plane is cropped before the (elementwise) float scaling
            dy = int(g.integers(0, arr.shape[0] - t + 1))
            dx = int(g.integers(0, arr.shape[1] - t + 1))
            x = arr[dy:dy + t, dx:dx + t].astype(np.float32) \
                / 255.0 * 2.0 - 1.0
            if g.integers(0, 2) == 0:
                x = x[::-1, :]
            x = np.ascontiguousarray(x)[..., None]
            # then the profile's crop start and additive noise
            start = int(g.integers(0, self.oversize - t + 1))
            prof = prof[start:start + t]
            prof = prof + 1e-3 * g.standard_normal(prof.shape).astype(
                np.float32)
            prof = prof.astype(np.float32)
            # then the pair's joint horizontal flip and time reversal
            if g.integers(0, 2) == 0:
                x = np.ascontiguousarray(x[:, ::-1])
                prof = np.ascontiguousarray(prof[::-1])
        else:
            x = (arr.astype(np.float32) / 255.0 * 2.0 - 1.0)[..., None]
        return {
            "image": x,
            "profile": prof,
            "label": str(self.labels[index]),
            "image_shape": self.shapes[index],
            "profile_length": self.lens[index],
        }
