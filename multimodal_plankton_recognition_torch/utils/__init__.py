"""Small host-side helpers (``utils/`` of the JAX package): the label
vocabulary."""

from .labels import LabelVocab

__all__ = ["LabelVocab"]
