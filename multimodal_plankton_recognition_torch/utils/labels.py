"""Label-name <-> integer-id vocabulary (``utils/labels.py`` of the JAX
package, which is framework-free: copied as it is).

Replaces the reference's use of ``sklearn.preprocessing.LabelEncoder``
(reference: src/model.py:170, scripts/benchmark_raw.py:74) with a tiny
deterministic numpy implementation so the vocabulary can be serialized into
checkpoints as a plain list of strings.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class LabelVocab:
    """Sorted-unique label vocabulary.

    Matches sklearn's ``LabelEncoder`` semantics: classes are the sorted
    unique label names; ``transform`` maps names to ids, ``inverse_transform``
    maps ids back to names.
    """

    def __init__(self, classes: Iterable[str]) -> None:
        self.classes_ = np.sort(np.unique(np.asarray(list(classes))))
        self._index = {name: i for i, name in enumerate(self.classes_.tolist())}

    @classmethod
    def fit(cls, labels: Iterable[str]) -> "LabelVocab":
        return cls(labels)

    def __len__(self) -> int:
        return len(self.classes_)

    def transform(self, labels: Sequence[str] | str) -> np.ndarray:
        if isinstance(labels, str):
            labels = [labels]
        try:
            return np.asarray([self._index[l] for l in labels], dtype=np.int32)
        except KeyError as e:  # pragma: no cover - error path
            raise ValueError(f"Unknown label {e.args[0]!r}") from e

    def inverse_transform(self, ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        return self.classes_[ids]

    def to_list(self) -> list[str]:
        return [str(c) for c in self.classes_.tolist()]
