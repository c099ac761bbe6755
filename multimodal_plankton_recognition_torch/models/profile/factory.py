"""Profile-encoder factory (``models/profile/factory.py`` of the JAX
package): the transformer, lstm and cnn kinds."""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from .cnn import ProfileCNN
from .lstm import ProfileLSTM
from .transformer import ProfileTransformer

_KINDS = {"transformer": ProfileTransformer, "lstm": ProfileLSTM,
          "cnn": ProfileCNN}


def create_profile_encoder(args: Dict[str, Any]) -> nn.Module:
    args = dict(args)
    kind = args.pop("kind", None)
    if kind is None:  # key-sniffing fallback, as in the JAX package
        kind = "transformer" if "num_head" in args else (
            "cnn" if "blocks" in args else "lstm")
    if kind not in _KINDS:
        raise KeyError(f"Unknown profile encoder kind {kind!r} (kinds: "
                       f"{sorted(_KINDS)})")
    return _KINDS[kind](**args)
