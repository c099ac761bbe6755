"""Static-shape batching ("tokenize") for the profile encoders.

The port's own numpy copy of the JAX package's ``data/tokenize.py``
(``tokenize_transformer``, ``tokenize_lstm``, ``tokenize_cnn`` and the
``Tokenizer`` picked by encoder kind): that one is reachable only through
its ``data/__init__.py``, which imports pandas and PIL.
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


def tokenize_lstm(profiles: Iterable[np.ndarray],
                  pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad to a common length and record the last valid index per
    sequence."""
    profiles = _as_list(profiles)
    d = profiles[0].shape[-1]
    max_len = max(p.shape[0] for p in profiles)
    T = pad_to if pad_to is not None else _round_up(max_len)
    if T < max_len:
        raise ValueError(f"pad_to={T} < longest sequence ({max_len})")
    B = len(profiles)
    tokens = np.zeros((B, T, d), dtype=np.float32)
    last = np.empty((B,), dtype=np.int32)
    for i, p in enumerate(profiles):
        L = p.shape[0]
        tokens[i, :L] = p
        last[i] = L - 1
    return {"profile": tokens, "last_idx": last}


def tokenize_cnn(profiles: Iterable[np.ndarray],
                 pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack equal-length profiles; zero-pad to ``pad_to`` (or the longest,
    rounded up to a multiple of 8) when they are ragged or ``pad_to`` is
    given."""
    profiles = _as_list(profiles)
    lengths = {p.shape[0] for p in profiles}
    if pad_to is None and len(lengths) == 1:
        return {"profile": np.stack(profiles).astype(np.float32)}
    d = profiles[0].shape[-1]
    T = pad_to if pad_to is not None else _round_up(max(lengths))
    B = len(profiles)
    tokens = np.zeros((B, T, d), dtype=np.float32)
    for i, p in enumerate(profiles):
        tokens[i, :p.shape[0]] = p
    return {"profile": tokens}


class Tokenizer:
    """``tokenize(list_of_profiles) -> dict`` for a profile-encoder kind
    (``transformer``, ``lstm`` or ``cnn``)."""

    def __init__(self, kind: str, target_size: int = 224,
                 pad_to: Optional[int] = None) -> None:
        if kind not in ("transformer", "lstm", "cnn"):
            raise ValueError(f"Unknown profile encoder kind {kind!r}")
        self.kind = kind
        self.target_size = target_size
        self.pad_to = pad_to

    def __call__(self, profiles) -> Dict[str, np.ndarray]:
        if self.kind == "transformer":
            return tokenize_transformer(profiles, self.target_size,
                                        self.pad_to)
        if self.kind == "lstm":
            return tokenize_lstm(profiles, self.pad_to)
        return tokenize_cnn(profiles, self.pad_to)


def get_tokenizer(kind: str, target_size: int = 224,
                  pad_to: Optional[int] = None) -> Tokenizer:
    return Tokenizer(kind, target_size, pad_to)
