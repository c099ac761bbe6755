"""The work of the attention cores a card runs: softmax(q kᵀ / √d) v
over packed q|k|v, per call, counted from the shapes (the card smoke
run's counts, ``chip_smoke.py`` kernels 1-2, without the backward's
recomputed scores: the work, not a kernel's way of doing it).

A forward reads q|k|v (B, L, 3E) in bf16 and, where keys are padded,
an f32 key bias (B, L), writes o (B, L, E) in bf16, and multiplies
4 B L K E (q kᵀ and P v), K the live keys of a row (L where none is
padded; where some are, the inputs' mean, since the padded ones need no
work). A backward reads q|k|v, the bias and dO (B, L, E), writes
dq|dk|dv (B, L, 3E), and multiplies 8 B L K E (dP = dO vᵀ, dV = Pᵀ dO,
dQ = dS k, dK = dSᵀ q).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .encoders import count_file
from .peaks import least_time_s

BF16 = 2
F32 = 4

#: (batch, tokens, heads, head dim, live keys a row, keys padded)
Call = Tuple[int, int, int, int, float, bool]


def attention_calls(card: Dict, batch: int,
                    profile_keys: Optional[float] = None) -> List[Call]:
    """The attention-core calls of one forward of ``card`` at ``batch``
    pairs, as each encoder's count file (``counts/encoders/``) gives
    them: the profile transformer's with ``profile_keys`` live keys a row
    on average (all, if not given)."""
    size = card.get("target_size", 224)
    calls: List[Call] = []
    for role, keys in (("image", None), ("profile", profile_keys)):
        args = card[f"{role}_encoder_args"]
        calls += count_file(args, role).attention(args, size, batch, keys)
    return calls


def forward_work(call: Call) -> Tuple[float, float]:
    """(bytes, bf16 operations) of one forward."""
    b, l, h, d, keys, masked = call
    e = h * d
    nbytes = b * l * 3 * e * BF16 + b * l * e * BF16 \
        + (b * l * F32 if masked else 0)
    return nbytes, 4 * b * l * keys * e


def backward_work(call: Call) -> Tuple[float, float]:
    """(bytes, bf16 operations) of one backward."""
    b, l, h, d, keys, masked = call
    e = h * d
    nbytes = 2 * b * l * 3 * e * BF16 + b * l * e * BF16 \
        + (b * l * F32 if masked else 0)
    return nbytes, 8 * b * l * keys * e


def least_time(calls: List[Call], backward: bool) -> float:
    """Seconds the card needs at least for the forwards of ``calls``,
    and with ``backward`` their backwards too, each call on its own."""
    total = 0.0
    for call in calls:
        total += least_time_s(*forward_work(call))
        if backward:
            total += least_time_s(*backward_work(call))
    return total
