"""Embedding export for gallery retrieval, the retrieval benchmarks and
the serving export (``export_checkpoint``, ``load_artifact``)."""

from .export import export_checkpoint, load_artifact

__all__ = ["export_checkpoint", "load_artifact"]
