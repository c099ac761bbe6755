"""PyTorch encoders and the contrastive ``MultiModel`` (``models/`` of the
JAX package): the ViT and EfficientNet-B0 flagships and their cards, for
serving and training."""

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)
