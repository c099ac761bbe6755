"""Kernels, their plain PyTorch versions, losses and kNN retrieval."""
