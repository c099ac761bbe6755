"""PyTorch encoders and the contrastive ``MultiModel`` (``models/`` of the
JAX package): the ViT flagship's serving path so far."""

from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


def check_eval(module: nn.Module) -> None:
    """The port's encoders run in eval mode only (dropout is the identity);
    training is a later slice."""
    if module.training:
        raise RuntimeError(f"{type(module).__name__} runs in eval mode only "
                           "(call .eval()); training is not ported yet, see "
                           "ROADMAP.md")
