"""Static-shape batching ("tokenize") for the transformer profile encoder.

The port's own numpy copy of ``tokenize_transformer`` from the JAX
package's ``data/tokenize.py``: that one is reachable only through its
``data/__init__.py``, which imports pandas and PIL.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np


def _round_up(n: int, m: int = 8) -> int:
    return ((n + m - 1) // m) * m


def _as_list(profiles) -> List[np.ndarray]:
    if isinstance(profiles, np.ndarray) and profiles.ndim == 2:
        return [profiles]
    return list(profiles)


def tokenize_transformer(profiles: Iterable[np.ndarray], target_size: int,
                         pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad variable-length profiles, prepend a CLS slot, and build position
    ids and the padding mask.

    Per sample of raw length L: token 0 is CLS (zero row, position 0),
    tokens 1..L carry the profile with positions 1..L, and tokens beyond L
    are padding with position ``target_size + 1`` and mask True. Without
    ``pad_to`` the batch's longest sequence is rounded up to a multiple
    of 8.
    """
    profiles = _as_list(profiles)
    d = profiles[0].shape[-1]
    padding_idx = target_size + 1
    max_tokens = max(p.shape[0] for p in profiles) + 1  # + CLS
    T = pad_to if pad_to is not None else _round_up(max_tokens)
    if T < max_tokens:
        raise ValueError(f"pad_to={T} < longest sequence ({max_tokens} tokens)")
    B = len(profiles)

    tokens = np.zeros((B, T, d), dtype=np.float32)
    time = np.full((B, T), padding_idx, dtype=np.int32)
    mask = np.ones((B, T), dtype=bool)
    for i, p in enumerate(profiles):
        L = p.shape[0]
        tokens[i, 1:L + 1] = p
        time[i, :L + 1] = np.arange(L + 1, dtype=np.int32)
        mask[i, :L + 1] = False
    return {"profile": tokens, "time": time, "padding_mask": mask}
