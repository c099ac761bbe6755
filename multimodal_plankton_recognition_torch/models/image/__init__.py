"""Image backbones and the image encoder."""
