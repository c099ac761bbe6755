"""The profile transformer: the 6-channel pulse profile over
``target_size`` + 1 tokens expanded to ``dim_hidden``, then
``num_layers`` blocks with ``dim_feedforward``; padded keys are masked."""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.layers import transformer_block


def flops(args: Dict, size: int) -> int:
    e, tokens = args["dim_hidden"], size + 1
    return 2 * tokens * args.get("dim_in", 6) * e + args["num_layers"] \
        * transformer_block(tokens, e, args["dim_feedforward"])


def width(args: Dict) -> int:
    return args["dim_hidden"]


def attention(args: Dict, size: int, batch: int, keys=None) -> List:
    """``keys``: the mean live keys of a row (all, if not given)."""
    e, heads, tokens = args["dim_hidden"], args["num_head"], size + 1
    live = tokens if keys is None else keys
    return [(batch, tokens, heads, e // heads, live, True)] \
        * args["num_layers"]
