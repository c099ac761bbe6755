"""Embedding export for gallery retrieval."""
