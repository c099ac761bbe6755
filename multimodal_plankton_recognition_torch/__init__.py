"""PyTorch / CUDA port of the multimodal plankton recognition framework,
for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``multimodal_plankton_recognition_tpu`` is the reference:
this package mirrors its layout and names, holds each ported module to it
on converted weights (``convert.py``), and replaces each Pallas TPU kernel
with a kernel written by hand for Hopper (``csrc/``, built at first use by
``ops/build.py``). It imports torch and never JAX.

Ported so far: for the ViT flagship (``models.flagships``: ViT-T/16 +
ProfileTransformer), the serving path — ``retrieval.encode`` and the exact
kNN classifier ``ops.knn`` — and the contrastive train step — ``train``
(SGD on f32 master weights, ``make_multi_steps``) with train-mode dropout
and the CLIP loss; for the ViT model cards, the card path — ``config``
(``ModelCard``), ``models.build`` and ``train.Fitter`` — with every
coordination method and the SigLIP loss; for the EfficientNet-B0 family
(``flagship_b0``: EfficientNet-B0 + ProfileCNN, and the B0 model cards),
serving and the card path, with the fused MBConv block (``ops.mbconv``)
for ``fused_mbconv``; for both transformer encoders, the fused
feed-forward block (``ops.ffn``) for ``fused_ffn``, and the attention
module's separate-q/k/v route (``PLANKTON_ATTN_QKV_PACKED=0`` or
``PLANKTON_ATTN_STACKED=0``); checkpoints (``train.checkpoint``: top-k
retention, ``load_from_checkpoint``) and serving from them
(``retrieval.encode.encode_dataset`` / ``encode_split``,
``scripts/encode_torch.py``; ``scripts/checkpoint_from_jax.py`` carries
an orbax checkpoint over), the packed input cache (``data.packed``, read
with numpy alone) and the device augmentation of the train step
(``ops.augment``, ``make_multi_steps(..., augment_fn=...)``); and the
train driver (``train.drivers.train_multi``, ``scripts/train_multi_torch.py``)
with the CSV path's random train transforms and a seeded init in the
Flax initialisers' distributions (``models.initializers``). Kernels:
``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``, ``csrc/clip_loss.cu``, ``csrc/siglip_loss.cu``,
``csrc/mbconv_fwd.cu``, ``csrc/mbconv_bwd.cu`` and ``csrc/ffn.cu``.
"""

__version__ = "0.1.0"
