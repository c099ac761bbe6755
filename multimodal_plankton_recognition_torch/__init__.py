"""PyTorch / CUDA port of the multimodal plankton recognition framework,
for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``multimodal_plankton_recognition_tpu`` is the reference:
this package mirrors its layout and names, holds each ported module to it
on converted weights (``convert.py``), and replaces each Pallas TPU kernel
with a kernel written by hand for Hopper (``csrc/``, built at first use by
``ops/build.py``). It imports torch and never JAX.

Ported so far: the ViT flagship's serving path — ``models.flagships``
(ViT-T/16 + ProfileTransformer), ``retrieval.encode`` and the exact kNN
classifier ``ops.knn`` — with the attention kernel ``csrc/attention_fwd.cu``.
"""

__version__ = "0.1.0"
