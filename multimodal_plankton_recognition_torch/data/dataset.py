"""Multimodal dataset (``data/dataset.py`` of the JAX package): one (image,
pulse-shape profile, class) triple per row of an annotations table whose
``image`` and ``profile`` paths resolve relative to the table's directory.
pandas is imported inside ``MultiSet.__init__``. An optional
``pair_augmentation(image, profile, rng)`` runs after both transforms, on
the same generator."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from .profile_io import load_image, load_profile_csv


class MultiSet:
    """Indexable dataset; each item holds ``image`` (transformed, float32
    (H, W, 1)), ``profile`` (transformed, float32 (L, D)), ``label`` (class
    name), ``image_shape`` (original (height, width), int32 (2,)) and
    ``profile_length`` (original length, int32 (1,)). A table without a
    ``class`` column gets the label ``unknown``."""

    def __init__(self, annotation_path: Path | str,
                 image_transforms: Callable,
                 profile_transform: Callable,
                 pair_augmentation: Optional[Callable] = None) -> None:
        import pandas as pd

        annotation_path = Path(annotation_path)
        self.parent = annotation_path.parent
        self.table = pd.read_csv(annotation_path)
        if "class" not in self.table.columns:
            self.table = self.table.assign(**{"class": "unknown"})
        self.class_names = np.unique(self.table["class"])
        self.image_transforms = image_transforms
        self.profile_transform = profile_transform
        self.pair_augmentation = pair_augmentation

    def __len__(self) -> int:
        return len(self.table)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        row = self.table.iloc[index]
        image = load_image(self.parent / row["image"])
        profile = load_profile_csv(self.parent / row["profile"])
        item = {
            "image": self.image_transforms(image, rng),
            "profile": self.profile_transform(profile, rng),
            "label": row["class"],
            "image_shape": np.array([image.height, image.width],
                                    dtype=np.int32),
            "profile_length": np.array([profile.shape[0]], dtype=np.int32),
        }
        if self.pair_augmentation:
            item["image"], item["profile"] = self.pair_augmentation(
                item["image"], item["profile"], rng)
        return item
