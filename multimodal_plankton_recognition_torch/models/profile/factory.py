"""Profile-encoder factory (``models/profile/factory.py`` of the JAX
package). Ported so far: the transformer and cnn kinds."""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from .cnn import ProfileCNN
from .transformer import ProfileTransformer

_KINDS = {"transformer": ProfileTransformer, "cnn": ProfileCNN}


def create_profile_encoder(args: Dict[str, Any]) -> nn.Module:
    args = dict(args)
    kind = args.pop("kind", None)
    if kind is None:  # key-sniffing fallback, as in the JAX package
        kind = "transformer" if "num_head" in args else (
            "cnn" if "blocks" in args else "lstm")
    if kind not in _KINDS:
        raise NotImplementedError(
            f"profile encoder kind {kind!r} is not ported yet (ported: "
            f"{sorted(_KINDS)}); see ROADMAP.md")
    return _KINDS[kind](**args)
