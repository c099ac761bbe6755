#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card: the ViT flagship's encode and train step, the ViT-S SigLIP model
card's train path, also with global negatives (one bucket of 64), the B0
flagship's encode and the B0 CLIP model card's train path with
``fused_mbconv``, the ViT flagship's train step with global negatives
(one bucket of 256), the same ViT paths with ``fused_ffn``,
the attention module's unpacked (separate q, k, v) route and its fused
attention-block route (``PLANKTON_ATTN_FUSE_PROJ=1``).

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --kernel-profile   # kernels 5-10, 13-16 alone

Needs a CUDA card (device 0) and ``nvcc``; there is no CPU path. Phases, each
fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles every kernel of the paths from ``csrc/`` (one ``nvcc``
   per source, all at once) and prints the build seconds and ptxas'
   register / spill report; the attention backward's 12 instances (two
   kernels, six head dims), the shared Hopper GEMM's 9 instances
   (``gemm_rows_kernel``, ``wgrad_kernel`` of ``csrc/hopper_gemm.cuh``:
   wgmma and TMA) in each of the five libraries that include it, its 3
   column-sum instances (``gemm_sums``) in ``mbconv_fwd`` and
   ``hopper_gemm``, kernel 10's 8 ``ffn_bwd_rows_kernel`` instances,
   kernel 9's 8 ``ffn_fwd_rows_kernel``, kernel 15's 3 ``kb_pass_kernel``
   and kernels 13-14's ``ka_a1_kernel``, 2 ``ka_dw_kernel``,
   ``kb_squeeze_kernel``, ``se_fwd_kernel`` and 2 ``kb_proj_kernel``,
   kernels 5-6's 10 instances (``CLIP_ENTRIES``) and kernels 7-8's 10
   (``SIGLIP_ENTRIES``) must spill 0 bytes;
3. kernels against their plain versions, on the same inputs at the shapes
   the paths run (the ViT flagship, B=256: ViT-T L=197 H=3 D=64 no mask,
   profile L=225 H=8 D=24 random key padding, CLS kept; the SigLIP card,
   B=64: ViT-S L=197 H=6 D=64, profile L=225 H=4 D=32 with padding), with
   max abs error, its tolerance, no NaN, median device ms of kernel and
   plain version (CUDA events around 3 back-to-back calls, queued behind a
   sleep kernel so the host's time per call stays off the clock; after
   warm-up), and the kernel's bound: the larger
   of its bytes (inputs read once, outputs written once) over 3.35 TB/s and
   its products over 989 TFLOP/s (bf16), from the H100 SXM's data sheet:
   * attention forward (``mha_qkv`` vs ``mha_qkv_reference``), eval mode at
     every shape and train mode (dropout 0.1) at the profile shapes, within
     2e-2, beside ``F.scaled_dot_product_attention`` on the same inputs (the
     library's time; the port never calls it), and also within a relative
     L2 error of 1e-3 (``FWD_REL_L2_TOL``); and train mode on inputs
     whose every sum is exact (q = k = 0, v = ±1), where kernel and plain
     version must agree bit for bit, so a single mask bit that differs
     would show (D = 24 and D = 32); kernels 1 and 3 also at the edges of
     the forward's tiles (``EDGE_SHAPES``: L 64, 65 and 577 at B 16, ViT-T
     and profile widths, with the exact-sum check at the profile's);
   * attention backward (``mha_qkv_bwd`` vs ``mha_qkv_bwd_reference``) at
     the ViT shapes and at the profile shapes with mask and dropout 0.1,
     within 1e-2 of the largest |dqkv| and a relative L2 error of 1e-2
     (``BWD_REL_L2_TOL``), a second call bit for bit equal to the first,
     beside SDPA's backward; at the masked shapes an exact-sum check
     (q = k = 0, v = ±1, dO = ±1: dV is a sum of ±pd, exact in f32) whose
     dV must equal the plain version's bit for bit; kernels 2 and 4 also
     at ``EDGE_SHAPES``, as kernels 1 and 3;
   * CLIP loss forward and backward (``clip_fwd`` / ``clip_bwd`` vs
     ``clip_loss_fused_reference`` / ``clip_loss_bwd_reference``) at
     ``CLIP_SHAPES`` (16 buckets of 16, 4 of 16, 1 of 64, 1 of 256) and one
     bucket of 512 (no cap), width 512, bf16: loss within 1e-5 relative,
     gradients within 1e-2 of the largest, d logit_scale within 1e-3
     relative; a second call of each, and the backward recomputing the
     forward's statistics, bit for bit equal to the backward given them;
     both backward forms timed in turns; bounds by operand type (the
     forward's and a recomputing backward's 2 N^2 D products of bf16 rows
     at the bf16 tensor rate, exact in f32; the backward's 4 N^2 D
     products of f32 ds at the f32 rate); one profiled call of each by
     CUDA kernel at 1 x 256 and 16 x 16;
   * SigLIP loss forward and backward (``siglip_fwd`` / ``siglip_bwd`` vs
     ``siglip_loss_fused_reference`` / ``siglip_loss_bwd_reference``) at
     ``SIGLIP_SHAPES`` (4 buckets of 16, the card; 16 of 16; 1 of 64, the
     card with global negatives; 1 of 256) and one bucket of 512 (no
     cap), width 512, bf16, at the head's init (scale 1, bias −10) and at
     scale 5 with bias ±30: the CLIP tolerances, d logit_bias like
     d logit_scale, a second call of each bit for bit equal to the first,
     the bounds as CLIP's; one profiled call of each by CUDA kernel at 4 x
     16 and 1 x 256 must show one forward kernel, one backward kernel at N
     <= 16 and two above, and no PyTorch kernel;
   * MBConv kernels 13-16 (``ka_fwd``, ``kb_fwd``, ``kb_bwd``, ``ka_bwd`` vs
     their ``*_reference``) at each of the 8 distinct shapes of B0's
     stride-1 blocks at B 64, every output within 2e-2 of max(1,
     max|plain|) and 1e-3 relative L2, a second call of each bit for bit
     equal to the first, and one profiled call of each by CUDA kernel at
     ``KA_BWD_PROFILED`` (stage2_block1, stage1_block0);
   * attention on separate q, k, v (kernels 3 and 4: ``mha`` / ``mha_bwd``
     vs ``mha_reference`` / ``mha_bwd_reference``) at the flagship's two
     shapes as kernels 1-2 above, the exact-sum mask check at D = 24, and
     bit for bit against kernels 1-2 on the same operands packed;
   * the fused FFN (kernels 9 and 10: ``ffn_fwd`` / ``ffn_bwd`` vs
     ``ffn_reference`` / ``ffn_bwd_reference``) at the four FFN shapes of
     the paths (``FFN_SHAPES``: ViT-T, the flagship's profile encoder, ViT-S,
     the card's profile encoder), eval and train (p 0.1), ReLU at the ViT-T
     shape and f32 x at the card's profile shape, every output within
     ``FFN_TOL`` of max(1, max|plain|) and 2e-3 relative L2, beside the
     unfused route's time (``F.linear`` → GELU → ``F.linear`` on cuBLAS, no
     single library call computes the block), a second forward and a
     second backward call bit for bit equal to the first, and one
     torch.profiler pass over one forward and one backward call at ViT-T
     (p 0 and 0.1) by CUDA kernel; and at each shape an exact-sum check
     (ReLU, integer inputs) that must agree bit for bit;
   * the fused attention block (kernels 11 and 12: ``attn_block_fwd`` /
     ``attn_block_bwd`` vs ``attn_block_reference`` /
     ``attn_block_bwd_reference``) at the four attention shapes above, eval
     and train (p 0.1) at the profile shapes, y and dx within
     ``KERNEL_TOL`` of max(1, max|plain|) and ``BLOCK_REL_TOL`` relative
     L2, the weight and bias gradients within ``BWD_TOL`` of their largest
     value, beside ``nn.MultiheadAttention``'s forward and backward on the
     same bf16 weights and key padding, at the row's dropout (the
     library's time; the port never calls it; the eval forward both on
     its fast path, where it takes it, and on its standard path); kernel
     12 on the autograd path (given kernel 11's q|k|v and o, ``keep``),
     its time beside the recomputing call's (no residuals), the two
     equal bit for bit and a second call equal to the first (fails
     otherwise); one torch.profiler pass over one call of each at ViT-T,
     device ms by CUDA kernel (the GEMM stages against the attention
     stage); and under identity projections (q =
     k = 0, v = x = ±1, out the identity) bit for bit against kernel 1's
     output and kernel 2's dv at D = 24 and 32, which pins the mask;
4. encode: the full-width ViT flagship (bf16, dim_embed 512, random weights
   from a seeded torch.Generator) encodes a synthetic gallery of 2,048
   pairs in batches of 256 through ``retrieval.encode.encode_arrays``; the
   attention kernel must launch exactly 14 times per batch (12 ViT + 2
   profile layers); embeddings must be finite with unit norm and within
   5e-2 of the same weights on the plain attention; then ``ANNClassifier``
   classifies the gallery against itself in four setups (image, profile,
   image->profile, fused image+profile), and the self-matching ones
   (k = 1) must be >= 99% right. "Plain" here and in 5. and 6. is the same
   model with the kernel wrappers swapped for their plain versions
   (``_plain_attention``, which fails if a kernel launched inside it), so
   the kernels are held to their own math (``fused_attention=False`` is
   flax's attention, other rounding points, driven in 14.);
5. train: the same flagship with f32 master weights initialised from a
   seeded f32 model takes 20 ``train_step``s (SGD lr 5e-3, momentum 0.9,
   nesterov, weight decay 1e-3, buckets 16, dropout 0.1 in the profile
   encoder and on the image feature) on one synthetic batch of 256; per
   step the attention forward and backward kernels must launch 14 times
   each and the CLIP kernels once each; every loss finite, the least of the
   last 5 below the first, the masters f32 and every one moved; train
   pairs/s over steps 4-20. Then one step from the same weights with
   dropout 0 on the kernel path and on the plain path (the attention
   kernels' plain versions, unfused CLIP loss): losses within 1e-2, named gradients within 5e-2
   relative (L2); and the plain path's train pairs/s;
5b. global: ``negatives: global`` (model_cards/example_multi.yaml): the
   flagship of 5. with the same weights and f32 masters through
   ``make_multi_steps(..., buckets=1)``, one bucket of 256, takes 5
   train steps; per step 14 + 14 attention and 1 + 1 CLIP launches;
   losses finite, the least of the last 4 below the first, every master
   moved; one dropout-0 step against the CLIP kernels' plain versions
   (``_plain_loss``): loss within 1e-2, named gradients within 5e-2; a
   ``summary:`` line of train pairs/s at buckets 16 and 1, timed in turns
   (16, 1, 1, 16);
6. card: ``CARD`` (the dict of model_cards/multi/
   vit_s_16_transformer_2_512_siglip.yaml: ViT-S/16, ProfileTransformer
   128 wide with 4 heads of 32, SigLIP, bs 64 in 4 buckets, accumulation
   4, bf16) through ``ModelCard.from_dict`` -> ``build_multi_model``,
   f32 masters from a seeded f32 init, the card's optimizer; ``Fitter``
   runs 2 epochs of 20 micro-steps on one synthetic batch of 64 with 2
   eval steps an epoch. Per micro-step the attention kernels must launch
   14 + 14 times and the SigLIP kernels once each, per eval step 14 + 1
   forward launches; losses finite, the least of the last 5 below the
   first, every master moved (``coordination.logit_bias`` among them);
   train pairs/s over micro-steps 4-20 of epoch 1. Then one dropout-0
   micro-step on the kernel and on the plain path (the attention kernels'
   plain versions, unfused SigLIP): losses within 1e-2, named gradients within 5e-2
   relative; and the plain path's train pairs/s;
6b. siglip_global: ``CARD`` with ``negatives: global``, so
   ``step_buckets`` makes each micro-step's 64 pairs one bucket (the
   SigLIP backward's two-kernel path), the card's masters and optimizer
   through ``make_multi_steps``: 5 micro-steps at 14 + 14 attention and
   1 + 1 SigLIP launches each; losses finite, the least of the last 4
   below the first, every master moved (``coordination.logit_bias``
   among them); one dropout-0 micro-step against the SigLIP kernels'
   plain versions (``_plain_loss``): loss within 1e-2, named gradients
   within 5e-2;
7. B0 encode: the full-width B0 flagship (bf16, dim_embed 512, seeded
   random weights; its BatchNorm statistics set by one momentum-0
   train-mode pass over a seeded batch) encodes 2,048 pairs in batches of
   256 in eval mode (cuDNN; no kernel of the port may launch); embeddings
   finite, unit norm, self-gallery k = 1 >= 99% for image and profile;
8. B0 card: ``B0_CARD`` (model_cards/multi/efficientnet_b0_cnn_2_512_
   clip.yaml with ``fused_mbconv: true``: EfficientNet-B0 + ProfileCNN
   2-2-2-2, CLIP, bs 64 in 4 buckets, accumulation 4, bf16) through
   ``Fitter`` as in 6: per micro-step 12 launches of each MBConv kernel and
   1 + 1 CLIP, per eval step 0 MBConv and 1 CLIP forward; every master and
   running statistic moved, the statistics f32. Then one dropout-0
   micro-step on the kernel route, the plain ``mbconv_core`` route and the
   cuDNN route (``fused_mbconv: false``), held within 1e-2 (loss) and the
   JAX package's statistical bounds (named gradients: correlation > 0.95,
   relative L2 each < 0.3), beside the plain route on nudged images (the
   step's own sensitivity); train pairs/s on the three routes;
9. ffn encode: ``flagship_vit(fused_ffn=True)`` on the weights of 4.
   encodes the gallery (14 FFN-forward and 14 attention launches a batch),
   beside the unfused flagship: embeddings within 5e-2 of it, self-gallery
   k = 1 >= 99%, pairs/s of both;
10. ffn train: 20 train steps of the fused-FFN flagship as in 5. (14 + 14
   FFN, 14 + 14 attention and 1 + 1 CLIP launches a step) and the peak
   ``torch.cuda.max_memory_allocated`` of one more; then dropout-0
   steps against ``ffn_core``'s plain versions on the card (loss 1e-2,
   named gradients 5e-2) and against the unfused route, held to the JAX
   package's statistical bounds beside the unfused route's nudged-input
   floor; a ``summary:`` line of train pairs/s of both routes, timed in
   turns (fused, unfused, unfused, fused);
11. ffn card: ``CARD`` with ``fused_ffn: true`` on both encoders through
   ``Fitter`` as in 6. (14 + 14 FFN launches a micro-step, 14 an eval step);
12. unpacked: ``PLANKTON_ATTN_QKV_PACKED=0`` (set in the phase, restored
   after): the flagship's encode runs kernel 3 only (14 a batch), 3 train
   steps kernels 3 and 4 only (14 + 14 a step), never kernels 1 and 2;
   encodings within 5e-2 of the packed route's;
13. fuse_proj: ``PLANKTON_ATTN_FUSE_PROJ=1`` (set in the phase, restored
   after): the flagship encodes the gallery through kernel 11 only (14 a
   batch) and takes 3 train steps (dropout 0.1) through kernels 11 and 12
   only (14 + 14 a step, 0 of kernels 1-4); embeddings within 5e-2 of the
   packed route's and self-gallery k = 1 >= 99%, losses finite and
   falling, every master moved; encode and train pairs/s of both routes
   in 3 rounds of turns (packed, block, block, packed) and their
   ratio, and the peak
   device memory (``torch.cuda.max_memory_allocated``) of one train step
   on each and on the block route with kernel 12 rebuilding q|k|v and o;
14. flax attention: ``fused_attention=False`` (flax's attention, no
   kernel) at full width: the flagship's encode (0 launches) within 5e-2
   of the kernels' plain versions and self-gallery k = 1 >= 99%; 3 train
   steps at dropout 0.1 (only the CLIP kernels launch), losses finite and
   falling, every master moved; one dropout-0 step against the kernels'
   plain versions (loss 1e-2, named gradients held statistically as in 8.,
   beside the plain route's nudged-input floor; the largest relative L2
   printed against 5e-2); encode and train pairs/s, and a ``summary:``
   line of encode and train pairs/s on the packed kernel route and on
   this one, timed in turns (packed, flax, flax, packed);
15. profile (only with ``--profile``): 8 encode batches of 256 of the ViT
   flagship after a warm-up pass and an unprofiled one, 8 of its train
   steps after 3 warm-up and 8 unprofiled ones (both on the packed route,
   then on the fused block's; the train steps also with ``fused_ffn``),
   then 8 micro-steps of each
   card on two
   routes (the SigLIP card also with and without ``fused_ffn``) under
   torch.profiler after 4 warm-up and 8 unprofiled ones:
   device ms per batch or micro-step by kernel, and the idle share, 1 −
   device busy / unprofiled wall.

Then a ``ranking:`` line: for each kernel, the sum over the paths of its
launches there × (device ms − bound ms) at the shapes each path runs
(``_rank_table``), largest first: the order in which the kernels lose the
most time. The line before the last is a JSON record of the kernels; the
last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed.

``--kernel-profile`` runs phase 1 and the build of kernels 5-10 and 13-16
only, times them at every ``CLIP_SHAPES``, ``SIGLIP_SHAPES``,
``FFN_SHAPES`` and ``MBCONV_SHAPES`` row (kernels 5-8 beside their plain
versions, kernel 6 also given the forward's statistics where the commit
takes them, kernels 7-8 also at ``SIGLIP_UNCAPPED`` unless the commit
caps the bucket, both sides of the commit's CLIP and SigLIP tile choices
in turns;
kernel 9 beside the unfused cuBLAS forward, kernels 13-15 beside their
plain versions, each beside its bound; the MBConv kernels summed over
B0's stride-1 blocks), profiles one call of each by CUDA kernel and takes
the peak memory of one fused-FFN flagship train step; it prints no
result line. Run from a copy of this script in a checkout of another
commit, it times that commit's kernels, so two commits compare in one
call.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "multimodal_plankton_recognition_torch"
PALLAS = "multimodal_plankton_recognition_tpu/ops/pallas"
SOURCES = ("attention_fwd", "attention_bwd", "clip_loss", "siglip_loss",
           "mbconv_fwd", "mbconv_bwd", "ffn", "attention_block",
           "hopper_gemm")
BATCH = 256
BUCKETS = 16
GALLERY = 2048
TRAIN_STEPS = 20
WARMUP_STEPS = 3
PLAIN_STEPS = 8
KERNEL_TOL = 2e-2
# the attention forward's ||kernel - plain|| / ||plain|| besides KERNEL_TOL:
# the H100 read at most 1e-4 at SHAPES and EDGE_SHAPES, where an absolute
# 2e-2 alone could hide a wrong key chunk
FWD_REL_L2_TOL = 1e-3
SLEEP_MAX_MS = 50.0  # the longest head start cuda_ms gives the host
BWD_TOL = 1e-2    # of the largest |dqkv|
# the attention backward's ||kernel - plain|| / ||plain|| besides BWD_TOL:
# both round ds and pd to bf16 at the same points, so a wrong tile or
# chunk of the query or the key side moves it by far more
BWD_REL_L2_TOL = 1e-2
# the backward's two kernels (csrc/attention_bwd.cuh) at every head dim:
# ptxas must report 0 spill bytes for each
BWD_ENTRIES = ("mha_bwd_q_kernel", "mha_bwd_kv_kernel")
BWD_INSTANCES = 2 * 6
# kernels 5-6 (csrc/clip_loss.cu), bf16 and f32 each: the forward at 16-
# and 32-row tiles, the one-block backward (16-row tiles), the two-kernel
# backward's dz and dx kernels; 0 spill bytes each (mangled names with
# their length prefixes)
CLIP_ENTRIES = ("15clip_fwd_kernel", "21clip_bwd_small_kernel",
                "14clip_dz_kernel", "14clip_dx_kernel")
CLIP_INSTANCES = 2 * (2 + 1 + 1 + 1)
# kernels 7-8 (csrc/siglip_loss.cu), the same layout: 0 spill bytes each
SIGLIP_ENTRIES = ("17siglip_fwd_kernel", "23siglip_bwd_small_kernel",
                  "16siglip_dz_kernel", "16siglip_dx_kernel")
SIGLIP_INSTANCES = 2 * (2 + 1 + 1 + 1)
# the shared Hopper GEMM (csrc/hopper_gemm.cuh: three column slices x two
# weight layouts of gemm_rows_kernel, three weight-gradient tiles) in every
# library that includes it, and its three column-sum instances (gemm_sums)
# where they are called; kernel 10's row kernel (four widths x two dx
# types) and kernel 9's (four widths, each in its one tile layout, x two
# y types) in csrc/ffn.cu; kernel 15's three passes in csrc/mbconv_bwd.cu;
# kernel 13's a1 pass and depthwise pass (k 3 and 5), kernel 14's
# squeeze, SE step and projection (its weight slice resident or streamed)
# in csrc/mbconv_fwd.cu; 0 spill bytes each. Matched in the
# mangled names with their length prefixes, so that mbconv_bwd's
# se_wgrad_kernel is not taken for one.
GEMM_ENTRIES = ("16gemm_rows_kernel", "12wgrad_kernel",
                "19ffn_bwd_rows_kernel", "19ffn_fwd_rows_kernel",
                "14kb_pass_kernel", "12ka_a1_kernel", "12ka_dw_kernel",
                "17kb_squeeze_kernel", "13se_fwd_kernel", "14kb_proj_kernel")
GEMM_INSTANCES = {"attention_block": 9, "mbconv_bwd": 9 + 3,
                  "mbconv_fwd": 9 + 3 + 1 + 2 + 1 + 1 + 2,
                  "hopper_gemm": 9 + 3,
                  "ffn": 9 + 8 + 8}
CLIP_LOSS_TOL = 1e-5   # relative
CLIP_GRAD_TOL = 1e-2   # of the largest |gradient|
CLIP_SCALE_TOL = 1e-3  # relative
# (buckets, N) of the CLIP kernels, width 512: the flagship (16 x 16), the
# cards (4 x 16), a card with global negatives (1 x 64) and the flagship's
# global-negatives phase (1 x 256)
CLIP_SHAPES = ((16, 16), (4, 16), (1, 64), (1, 256))
CLIP_UNCAPPED = (1, 512)  # past the old 256-row cap: checked and timed
CLIP_PROFILED = ((1, 256), (16, 16))  # profiled by CUDA kernel
# where --kernel-profile times both sides of the CLIP kernels' tile choices
CLIP_REGIME_SHAPES = ((16, 16), (4, 16), (1, 32), (1, 64), (1, 128),
                      (1, 256), (1, 512))
GLOBAL_STEPS = 5  # train steps (micro-steps) of the global phases
# SigLIP (scale, bias): the head's init and the saturated ends where a
# naive softplus would overflow
SIGLIP_SCALARS = ((1.0, -10.0), (5.0, 30.0), (5.0, -30.0))
# (buckets, N) of the SigLIP kernels, width 512: the card (4 x 16), 16 x
# 16, the card with global negatives (1 x 64) and one bucket of 256
SIGLIP_SHAPES = ((4, 16), (16, 16), (1, 64), (1, 256))
SIGLIP_UNCAPPED = (1, 512)  # past the old 256-row cap: checked and timed
# profiled by CUDA kernel: the one-block backward and the two kernels
SIGLIP_PROFILED = ((4, 16), (1, 256))
SLICE_TOL = 5e-2
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 5e-2
ATTENTION_LAYERS = 12 + 2  # ViT blocks + ProfileTransformer layers
# B, L, H, E, mask: the ViT flagship's layers, then the SigLIP card's
SHAPES = {"vit": (256, 197, 3, 192, False),
          "profile": (256, 225, 8, 192, True),
          "card vit": (64, 197, 6, 384, False),
          "card profile": (64, 225, 4, 128, True)}
# kernels 3-4 (separate q, k, v) run at the flagship's shapes
SEPARATE_SHAPES = ("vit", "profile")
# kernels 1-4 at the edges of their 16-row warp tiles and their 256-row
# shared-memory chunks (577: a ViT at 384 px), at the flagship's widths
# (ViT-T D 64 unmasked, the profile encoder D 24 masked), B 16
EDGE_SHAPES = [(name, (16, l) + SHAPES[name][2:])
               for name in SEPARATE_SHAPES for l in (64, 65, 577)]
# B, L, E, F, activation: the fused-FFN layers of the ViT flagship (ViT-T,
# profile), then of the SigLIP card (ViT-S, profile)
FFN_SHAPES = {"vit": (256, 197, 192, 768, "gelu"),
              "profile": (256, 225, 192, 2024, "gelu"),
              "card vit": (64, 197, 384, 1536, "gelu"),
              "card profile": (64, 225, 128, 1024, "gelu")}
# of max(1, the largest |plain value|), each output: GELU one bf16 step;
# ReLU's derivative jumps at 0, so an h_pre that the two sides sum to
# opposite sides of 0 flips a whole dpre unit (|dh . w1|, up to about 0.2
# in dx at these scales; the exact-sum check pins ReLU bit for bit)
FFN_TOL = {"gelu": 2e-2, "relu": 0.25}
FFN_REL_TOL = 2e-3  # relative L2 of each output
FFN_LAYERS = ATTENTION_LAYERS  # one feed-forward block per attention layer
UNPACKED_STEPS = 3  # train steps on the unpacked attention route
FUSE_PROJ_STEPS = 3  # train steps on the fused attention-block route
# rounds of (packed, block, block, packed) that time the two routes: the
# host's share spreads by 10-20% within one call on the H100
FUSE_PROJ_ROUNDS = 3
FLAX_STEPS = 3  # train steps of fused_attention=False (flax's attention)
BLOCK_REL_TOL = 2e-3  # relative L2 of the attention block's y and dx
# the least time of a kernel: NVIDIA's data sheet for one H100 SXM (dense,
# at 700 W); bytes over the HBM rate, products of bf16 operands over the
# tensor rate, products with an f32 operand over the CUDA cores' rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# the 8 distinct shapes of B0's 12 stride-1 MBConv blocks, which the kernel
# phase checks at the card's batch of 64: first block of that shape ->
# (H = W, cin, mid, cout, k, SE width)
MBCONV_SHAPES = {"stage1_block0": (112, 32, 32, 16, 3, 8),
                 "stage2_block1": (56, 24, 144, 24, 3, 6),
                 "stage3_block1": (28, 40, 240, 40, 5, 10),
                 "stage4_block1": (14, 80, 480, 80, 3, 20),
                 "stage5_block0": (14, 80, 480, 112, 5, 20),
                 "stage5_block1": (14, 112, 672, 112, 5, 28),
                 "stage6_block1": (7, 192, 1152, 192, 5, 48),
                 "stage7_block0": (7, 192, 1152, 320, 3, 48)}
MBCONV_TOL = 2e-2  # of max(1, the largest |plain value|), each output
MBCONV_REL_TOL = 1e-3  # relative L2 of each output (measured: <= 2e-4)
MBCONV_BLOCKS = 12  # B0's stride-1 blocks: each MBConv kernel per micro-step
# how many of B0's 12 stride-1 blocks run at each MBCONV_SHAPES shape
B0_BLOCKS = {"stage1_block0": 1, "stage2_block1": 1, "stage3_block1": 1,
             "stage4_block1": 2, "stage5_block0": 1, "stage5_block1": 2,
             "stage6_block1": 3, "stage7_block0": 1}
# the MBConv kernels' shapes broken down by CUDA kernel (one profiled call
# each): the widest expand and the block without one
KA_BWD_PROFILED = ("stage2_block1", "stage1_block0")
STAT_CORR, STAT_RMS = 0.95, 0.3  # the JAX package's fused-vs-unfused bounds
CARD_STEPS = 20    # micro-steps of 64 pairs per epoch
CARD_EPOCHS = 2
CARD_VALID = 2     # eval steps per epoch
PROFILE_STEPS = 8  # two SGD updates at accumulation 4
PROFILE_ROWS = 30  # kernels printed per path
# the host's calls that start work on the card, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
COPY_CALLS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
#: model_cards/multi/vit_s_16_transformer_2_512_siglip.yaml as a dict
#: literal (the card's machine has no PyYAML); tests/test_torch_card.py
#: holds it equal to the file
CARD = {
    "precision": "medium", "dim_embedding": 512, "max_len": 256,
    "target_size": 224, "bs": 64, "buckets": 4, "num_workers": 8,
    "patience": 20, "save_top_k": 5, "parallel": "shard_map",
    "image_encoder_args": {
        "name": "vit_small_patch16_224", "pretrained": False,
        "num_classes": 0, "metadata": True, "in_chans": 1, "dropout": 0.1,
        "fused_attention": True},
    "profile_encoder_args": {
        "kind": "transformer", "dim_in": 6, "dim_hidden": 128,
        "num_head": 4, "num_layers": 2, "dim_feedforward": 1024,
        "dropout": 0.1, "activation": "gelu", "target_size": 224,
        "metadata": True, "fused_attention": True},
    "coordination_args": {"method": "siglip", "negatives": "bucketed",
                          "fused": True},
    "optim_args": {"lr": 5.0e-3, "momentum": 0.9, "weight_decay": 1.0e-3,
                   "nesterov": True},
    "trainer_args": {"precision": "16-mixed", "min_epochs": 40,
                     "max_epochs": 200, "accumulate_grad_batches": 4,
                     "check_val_every_n_epoch": 1},
}
#: model_cards/multi/efficientnet_b0_cnn_2_512_clip.yaml as a dict literal
#: with ``fused_mbconv: true`` added; tests/test_torch_card.py holds it
#: equal to the file but for that key
B0_CARD = {
    "precision": "medium", "dim_embedding": 512, "max_len": 256,
    "target_size": 224, "bs": 64, "buckets": 4, "num_workers": 8,
    "patience": 20, "save_top_k": 5,
    "image_encoder_args": {
        "name": "efficientnet_b0", "pretrained": False, "num_classes": 0,
        "metadata": True, "in_chans": 1, "dropout": 0.1,
        "fused_mbconv": True},
    "profile_encoder_args": {
        "kind": "cnn", "dim_in": 6, "blocks": [2, 2, 2, 2],
        "base_channels": 32, "dropout": 0.1, "metadata": True},
    "coordination_args": {"method": "clip", "negatives": "bucketed",
                          "fused": True},
    "optim_args": {"lr": 5.0e-3, "momentum": 0.9, "weight_decay": 1.0e-3,
                   "nesterov": True},
    "trainer_args": {"precision": "16-mixed", "min_epochs": 40,
                     "max_epochs": 200, "accumulate_grad_batches": 4,
                     "check_val_every_n_epoch": 1},
}
# (not logit_scale: at the init the loss sits at ln 16, a bucket of 16, and
# d logit_scale is one sum that nearly cancels)
B0_NAMED_GRADS = (
    "image_projection.weight",
    "profile_projection.weight",
    "image_encoder.backbone.head_conv.weight",
    "image_encoder.backbone.stage7_block0.project_conv.weight",
    "image_encoder.backbone.stage5_block1.dw_conv.weight",
    "image_encoder.backbone.stage2_block1.expand_conv.weight",
    "image_encoder.backbone.stage2_block1.se.reduce.weight",
    "image_encoder.backbone.stage1_block0.dw_conv.weight",
    "image_encoder.backbone.stage1_block0.dw_bn.weight",
    "profile_encoder.stage4_block1.conv2.weight",
)
NAMED_GRADS = (
    "coordination.logit_scale",
    "image_projection.weight",
    "profile_projection.weight",
    "image_encoder.backbone.blocks.11.attn.qkv.weight",
    "image_encoder.backbone.blocks.0.attn.qkv.weight",
    "image_encoder.backbone.patch_embed.weight",
    "profile_encoder.layers.1.attn.qkv.weight",
    "profile_encoder.layers.0.ff1.weight",
)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` in one millisecond."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)  # warm-up
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return 10 ** 7 / start.elapsed_time(end)


def cuda_ms(fn, reps: int = 10, warmup: int = 3, calls: int = 3) -> float:
    """Median device milliseconds of one ``fn()`` on the current stream:
    each sample times ``calls`` back-to-back calls between two events,
    queued behind a sleep kernel long enough for the host to enqueue them
    all, so the host's time per call (wrapper, checks, launch) stays off
    the clock unless ``fn`` synchronises."""
    import torch

    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3  # the last call's
    torch.cuda.synchronize()
    sleep_ms = min(SLEEP_MAX_MS, 0.1 + 2 * calls * host_ms)
    sleep = int(_sleep_cycles_per_ms() * sleep_ms)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card, there is no CPU path")
    if not (REPO / PACKAGE / "csrc").is_dir():
        fail(f"{PACKAGE}/csrc not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # full-f32 products for the plain versions and the kNN distances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    return torch.device("cuda", 0)


def phase_build():
    from multimodal_plankton_recognition_torch.ops import (
        attention, attention_block, build, contrastive, ffn, hopper_gemm,
        mbconv)

    t0 = time.perf_counter()
    libs = build.build_all(SOURCES)
    hopper_gemm._lib()
    attention._fwd_lib()
    attention._bwd_lib()
    attention_block._lib()
    contrastive._lib()
    contrastive._siglip_lib()
    mbconv._fwd_lib()
    mbconv._bwd_lib()
    ffn._lib()
    print(f"build: {', '.join(SOURCES)} in parallel, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, lib in libs.items():
        print(f"  {name} -> {lib.relative_to(REPO)}", flush=True)
        log = lib.with_suffix(".log")
        # {entry: [st, ld]}
        func, spills, gemms, losses = "", {}, {}, {}
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                print(f"  ptxas: {entry[:96]}", flush=True)
            elif "Function properties for" in line:
                func = line.split("Function properties for")[1].strip()
            elif "warning" in line.lower():
                print(f"  ptxas: {line.strip()}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"  ptxas:   {line.strip()}", flush=True)
                if "spill" in line:
                    counts = [int(w) for w in line.split()
                              if w.isdigit()][1:]
                    if any(k in func for k in BWD_ENTRIES):
                        spills[func] = counts
                    if any(k in func for k in GEMM_ENTRIES):
                        gemms[func] = counts
                    if any(k in func for k in CLIP_ENTRIES
                           + SIGLIP_ENTRIES):
                        losses[func] = counts
        if name == "attention_bwd":
            if len(spills) != BWD_INSTANCES:
                fail(f"ptxas reported {len(spills)} backward kernel "
                     f"instances, expected {BWD_INSTANCES}")
            spilled = {e: n for e, n in spills.items() if any(n)}
            if spilled:
                fail(f"backward kernels spill registers: {spilled}")
            print(f"  ptxas: {len(spills)} backward instances, 0 spill "
                  f"bytes", flush=True)
        if name in ("clip_loss", "siglip_loss"):
            loss, want = (("CLIP", CLIP_INSTANCES) if name == "clip_loss"
                          else ("SigLIP", SIGLIP_INSTANCES))
            if len(losses) != want:
                fail(f"ptxas reported {len(losses)} {loss} kernel instances, "
                     f"expected {want}")
            spilled = {e: n for e, n in losses.items() if any(n)}
            if spilled:
                fail(f"{loss} kernels spill registers: {spilled}")
            print(f"  ptxas: {len(losses)} {loss} kernel instances, 0 spill "
                  f"bytes", flush=True)
        if name in GEMM_INSTANCES:
            if len(gemms) != GEMM_INSTANCES[name]:
                fail(f"ptxas reported {len(gemms)} Hopper GEMM instances in "
                     f"{name}, expected {GEMM_INSTANCES[name]}")
            spilled = {e: n for e, n in gemms.items() if any(n)}
            if spilled:
                fail(f"Hopper GEMMs of {name} spill registers: {spilled}")
            print(f"  ptxas: {len(gemms)} Hopper GEMM instances in {name} "
                  f"(wgmma, TMA), 0 spill bytes", flush=True)


def _check(label: str, got, want, tol: float, scale: float = 1.0) -> float:
    """max |got - want| / scale; fails on NaN or above ``tol``."""
    import torch

    got, want = (t.float() for t in (got, want))
    if not torch.isfinite(got).all():
        fail(f"{label}: kernel produced non-finite values")
    err = (got - want).abs().max().item() / scale
    if not err <= tol:
        fail(f"{label}: kernel disagrees with its plain version: error "
             f"{err!r} > {tol}")
    return err


def _rel_l2(label: str, got, want, tol: float = FWD_REL_L2_TOL) -> float:
    """||got - want|| / ||want||; fails above ``tol``."""
    got, want = (t.float() for t in (got, want))
    err = ((got - want).norm() / want.norm()).item()
    if not err <= tol:
        fail(f"{label}: kernel disagrees with its plain version: relative "
             f"L2 error {err!r} > {tol}")
    return err


def _attention_inputs(gen, device, b, l, e, masked):
    import torch

    qkv = torch.randn((b, l, 3 * e), generator=gen, device=device
                      ).to(torch.bfloat16)
    bias = None
    if masked:
        pad = torch.rand((b, l), generator=gen, device=device) < 0.3
        pad[:, 0] = False  # CLS is never masked
        bias = torch.where(pad, -1e9, 0.0).to(torch.float32)
    return qkv, bias


def _nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (nested in tuples too)."""
    import torch

    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += _nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _bound(inputs, outputs, flops, rate=BF16_FLOPS, f32_flops=0):
    """(ms, "bytes" or "operations"): the least time of a function on this
    card, the larger of its bytes (each input read once, each output
    written once) over the HBM rate and its operations: ``flops`` over
    ``rate`` (bf16 on the tensor cores unless given) plus ``f32_flops``
    (products with an f32 operand) over the CUDA cores' f32 rate."""
    by_bytes = _nbytes(inputs, outputs) / HBM_BYTES_PER_S * 1e3
    by_ops = (flops / rate + f32_flops / F32_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _report(records, name, label, err, tol, ms, plain_ms, bound,
            library_ms=None, **extra):
    """Print one kernel measurement and keep it; ``extra``: more timings
    (e.g. ``unfused_ms``)."""
    more = "".join(f", {k} {v!r}" for k, v in extra.items())
    print(f"kernel {name} [{label}]: max_abs_err {err!r} (tol {tol}), "
          f"kernel {ms!r} ms, plain {plain_ms!r} ms, bound {bound[0]!r} ms "
          f"({bound[1]}), library {library_ms!r} ms{more}", flush=True)
    records.setdefault(name, {})[label] = {
        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": library_ms, **extra}


def _sdpa_ms(qkv, bias, heads, p, dout=None):
    """Milliseconds of ``F.scaled_dot_product_attention`` on the kernel's
    inputs (q, k, v: views of a packed ``qkv``, or a tuple of the three;
    ``bias`` as an additive key mask): the forward, or with ``dout`` its
    backward alone."""
    import torch
    import torch.nn.functional as F

    parts = qkv if isinstance(qkv, tuple) else qkv.chunk(3, dim=-1)
    b, l, e = parts[0].shape
    q, k, v = (t.reshape(b, l, heads, e // heads).transpose(1, 2)
               for t in parts)
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    if dout is None:
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=p))
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         dropout_p=p)
    dout = dout.reshape(b, l, heads, e // heads).transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), dout,
                                               retain_graph=True))


def phase_kernel(device):
    """Every kernel against its plain version; returns {name: {shape:
    numbers}}."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    records = {}
    seed = 1234
    for name, (b, l, heads, e, masked) in SHAPES.items():
        qkv, bias = _attention_inputs(gen, device, b, l, e, masked)
        _forward_rows(records, name, qkv, bias, heads, masked, seed,
                      name in SEPARATE_SHAPES)
        if masked:  # exact sums: the masks must agree bit for bit
            _mask_check(gen, name, qkv, bias, heads, seed,
                        name in SEPARATE_SHAPES)
        _backward_rows(records, gen, name, qkv, bias, heads, masked, seed,
                       name in SEPARATE_SHAPES)
    edge_gen = torch.Generator(device=device).manual_seed(7)
    for name, (b, l, heads, e, masked) in EDGE_SHAPES:
        qkv, bias = _attention_inputs(edge_gen, device, b, l, e, masked)
        _forward_rows(records, name, qkv, bias, heads, masked, seed, True)
        if masked:
            _mask_check(edge_gen, name, qkv, bias, heads, seed, True)
        _backward_rows(records, edge_gen, name, qkv, bias, heads, masked,
                       seed, True)
    _clip_kernels(gen, device, records)
    _ffn_kernels(gen, device, records)
    _siglip_kernels(gen, device, records)
    _mbconv_kernels(gen, device, records)
    _block_kernels(gen, device, records)
    return records


def _forward_rows(records, name, qkv, bias, heads, masked, seed, separate):
    """Kernel 1 (and kernel 3 with ``separate``) against its plain version
    in eval mode, and in train mode (p 0.1) when ``masked``: the error
    (absolute and relative L2), the device time beside the plain
    version's, the bound and SDPA's."""
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_qkv, mha_qkv_reference)

    b, l, e3 = qkv.shape
    e = e3 // 3
    modes = [("eval", 0.0)] + ([("train p=0.1", 0.1)] if masked else [])
    for mode, p in modes:
        label = f"{name} B={b} L={l} H={heads} mask={masked} {mode}"
        out = mha_qkv(qkv, bias, heads, p, seed)
        want = mha_qkv_reference(qkv, bias, heads, p, seed)
        err = _check(f"mha_qkv_fwd {label}", out, want, KERNEL_TOL)
        # QK^T and PV: 4 B L^2 E
        _report(records, "mha_qkv_fwd", label, err, KERNEL_TOL,
                cuda_ms(lambda: mha_qkv(qkv, bias, heads, p, seed)),
                cuda_ms(lambda: mha_qkv_reference(qkv, bias, heads, p,
                                                  seed)),
                _bound((qkv, bias), out, 4 * b * l * l * e),
                _sdpa_ms(qkv, bias, heads, p),
                rel_l2=_rel_l2(f"mha_qkv_fwd {label}", out, want))
        if separate:
            _separate_fwd(records, label, qkv, bias, heads, p, seed, out)


def _mask_check(gen, name, qkv, bias, heads, seed, separate):
    """Train mode on inputs whose every sum is exact (q = k = 0, v = ±1):
    kernel 1 (and kernel 3 with ``separate``) must equal its plain version
    bit for bit, so one dropout-mask bit that differs would show."""
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha, mha_qkv, mha_qkv_reference, mha_reference)

    b, l, e3 = qkv.shape
    e = e3 // 3
    exact = torch.zeros_like(qkv)
    exact[..., 2 * e:] = torch.where(
        torch.rand((b, l, e), generator=gen, device=qkv.device) < 0.5,
        -1.0, 1.0)
    err = _check(f"mha_qkv_fwd {name} mask check",
                 mha_qkv(exact, bias, heads, 0.1, seed),
                 mha_qkv_reference(exact, bias, heads, 0.1, seed), 0.0)
    print(f"kernel mha_qkv_fwd [{name} L={l} D={e // heads} train p=0.1, "
          f"q=k=0, v=+-1]: max_abs_err {err!r} (must be 0: same dropout "
          f"mask)", flush=True)
    if separate:
        q, k, v = (t.contiguous() for t in exact.chunk(3, dim=-1))
        err = _check(f"mha_fwd {name} mask check",
                     mha(q, k, v, bias, heads, 0.1, seed),
                     mha_reference(q, k, v, bias, heads, 0.1, seed), 0.0)
        print(f"kernel mha_fwd [{name} L={l} D={e // heads} train p=0.1, "
              f"q=k=0, v=+-1]: max_abs_err {err!r} (must be 0)", flush=True)


def _backward_rows(records, gen, name, qkv, bias, heads, masked, seed,
                   separate):
    """Kernel 2 (and kernel 4 with ``separate``) against its plain version
    at dropout 0.1 when ``masked``, else 0: the error (absolute, of the
    largest |dqkv|, and relative L2), a second call bit for bit equal to
    the first, the device time beside the plain version's, the bound and
    SDPA's backward; and, when ``masked``, the exact-sum dV check."""
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_qkv_bwd, mha_qkv_bwd_reference)

    b, l, e3 = qkv.shape
    e = e3 // 3
    p = 0.1 if masked else 0.0
    dout = torch.randn((b, l, e), generator=gen, device=qkv.device
                       ).to(torch.bfloat16)
    label = f"{name} B={b} L={l} H={heads} mask={masked} p={p}"
    got = mha_qkv_bwd(qkv, bias, dout, heads, p, seed)
    want = mha_qkv_bwd_reference(qkv, bias, dout, heads, p, seed)
    scale = want.float().abs().max().item()
    err = _check(f"mha_qkv_bwd {label}", got, want, BWD_TOL, scale)
    if not torch.equal(mha_qkv_bwd(qkv, bias, dout, heads, p, seed), got):
        fail(f"mha_qkv_bwd {label}: two calls differ")
    # S recomputed, dV, dP, dQ, dK: 10 B L^2 E
    _report(records, "mha_qkv_bwd", label, err * scale, BWD_TOL * scale,
            cuda_ms(lambda: mha_qkv_bwd(qkv, bias, dout, heads, p, seed)),
            cuda_ms(lambda: mha_qkv_bwd_reference(qkv, bias, dout, heads, p,
                                                  seed)),
            _bound((qkv, bias, dout), want, 10 * b * l * l * e),
            _sdpa_ms(qkv, bias, heads, p, dout),
            rel_l2=_rel_l2(f"mha_qkv_bwd {label}", got, want,
                           BWD_REL_L2_TOL))
    if separate:
        _separate_bwd(records, label, qkv, bias, dout, heads, p, seed, got)
    if masked:
        _bwd_mask_check(gen, name, bias, heads, e // heads, seed, separate)


def _bwd_mask_check(gen, name, bias, heads, d, seed, separate):
    """q = k = 0, v = ±1, dO = ±1: p is uniform over the unmasked keys, pd
    is 0 or one bf16 constant and dV, a sum of ±pd, is exact in f32, so
    kernel 2's dV (and kernel 4's with ``separate``) must equal the plain
    version's bit for bit iff the dropout masks agree."""
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_bwd, mha_qkv_bwd, mha_qkv_bwd_reference)

    b, l = bias.shape
    e = heads * d
    signs = torch.rand((b, l, 2 * e), generator=gen, device=bias.device)
    pm = torch.where(signs < 0.5, -1.0, 1.0).to(torch.bfloat16)
    exact = torch.zeros((b, l, 3 * e), dtype=torch.bfloat16,
                        device=bias.device)
    exact[..., 2 * e:] = pm[..., :e]
    dout = pm[..., e:].contiguous()
    want = mha_qkv_bwd_reference(exact, bias, dout, heads, 0.1, seed)
    err = _check(f"mha_qkv_bwd {name} L={l} dV mask check",
                 mha_qkv_bwd(exact, bias, dout, heads, 0.1, seed)[..., 2 * e:],
                 want[..., 2 * e:], 0.0)
    print(f"kernel mha_qkv_bwd [{name} L={l} D={d} p=0.1, q=k=0, v=+-1, "
          f"dO=+-1]: dV max_abs_err {err!r} (must be 0: same dropout mask)",
          flush=True)
    if separate:
        q, k, v = (t.contiguous() for t in exact.chunk(3, dim=-1))
        err = _check(f"mha_bwd {name} L={l} dV mask check",
                     mha_bwd(q, k, v, bias, dout, heads, 0.1, seed)[2],
                     want[..., 2 * e:], 0.0)
        print(f"kernel mha_bwd [{name} L={l} D={d} p=0.1, q=k=0, v=+-1, "
              f"dO=+-1]: dV max_abs_err {err!r} (must be 0)", flush=True)


def _separate_fwd(records, label, qkv, bias, heads, p, seed, packed_out):
    """Kernel 3 on the q, k, v of ``qkv`` against its plain version, and bit
    for bit against kernel 1's ``packed_out`` (the same device code)."""
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha, mha_reference)

    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    b, l, e = q.shape
    out = mha(q, k, v, bias, heads, p, seed)
    want = mha_reference(q, k, v, bias, heads, p, seed)
    err = _check(f"mha_fwd {label}", out, want, KERNEL_TOL)
    if not torch.equal(out, packed_out):
        fail(f"mha_fwd {label}: differs from mha_qkv_fwd on the same "
             f"operands")
    _report(records, "mha_fwd", label, err, KERNEL_TOL,
            cuda_ms(lambda: mha(q, k, v, bias, heads, p, seed)),
            cuda_ms(lambda: mha_reference(q, k, v, bias, heads, p, seed)),
            _bound((q, k, v, bias), out, 4 * b * l * l * e),
            _sdpa_ms((q, k, v), bias, heads, p),
            rel_l2=_rel_l2(f"mha_fwd {label}", out, want))


def _separate_bwd(records, label, qkv, bias, dout, heads, p, seed,
                  packed_grad):
    """Kernel 4 against its plain version (each of dq, dk, dv, absolute and
    relative L2) and bit for bit against kernel 2's ``packed_grad`` on the
    same operands packed."""
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_bwd, mha_bwd_reference)

    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    b, l, e = q.shape
    got = mha_bwd(q, k, v, bias, dout, heads, p, seed)
    want = mha_bwd_reference(q, k, v, bias, dout, heads, p, seed)
    scale = max(w.float().abs().max().item() for w in want)
    what = ("dq", "dk", "dv")
    err = max(_check(f"mha_bwd {n} {label}", g, w, BWD_TOL, scale)
              for n, g, w in zip(what, got, want))
    rel_l2 = max(_rel_l2(f"mha_bwd {n} {label}", g, w, BWD_REL_L2_TOL)
                 for n, g, w in zip(what, got, want))
    if not torch.equal(torch.cat(got, dim=-1), packed_grad):
        fail(f"mha_bwd {label}: differs from mha_qkv_bwd on the same "
             f"operands")
    _report(records, "mha_bwd", label, err * scale, BWD_TOL * scale,
            cuda_ms(lambda: mha_bwd(q, k, v, bias, dout, heads, p, seed)),
            cuda_ms(lambda: mha_bwd_reference(q, k, v, bias, dout, heads, p,
                                              seed)),
            _bound((q, k, v, bias, dout), got, 10 * b * l * l * e),
            _sdpa_ms((q, k, v), bias, heads, p, dout), rel_l2=rel_l2)


def _ffn_close(label, got, want, tol):
    """Each output within ``tol`` of max(1, its largest plain value) and
    ``FFN_REL_TOL`` relative L2; returns the largest absolute error."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{label} output {i}: {tuple(g.shape)} {g.dtype}, plain "
                 f"{tuple(w.shape)} {w.dtype}")
        scale = max(1.0, w.float().abs().max().item())
        err = max(err, scale * _check(f"{label} output {i}", g, w, tol,
                                      scale))
        rel = ((g.float() - w.float()).norm()
               / max(w.float().norm().item(), 1e-30)).item()
        if not rel <= FFN_REL_TOL:
            fail(f"{label} output {i}: relative L2 error {rel!r} > "
                 f"{FFN_REL_TOL}")
    return err


def _repeats(label, got, again):
    """A second call's outputs ``again`` must equal ``got`` bit for bit
    (the kernel sums in a fixed order, with no float atomics)."""
    import torch

    same = all((g is None and a is None) or torch.equal(g, a)
               for g, a in zip(got, again))
    print(f"kernel {label}: two calls bit for bit {same} (must be True)",
          flush=True)
    if not same:
        fail(f"{label}: two calls differ")


def _call_profile(name, label, call, launches=None):
    """Device ms of one call by CUDA kernel (torch.profiler, after a
    warm-up call): the breakdown of one wrapper launch; returns the
    total. With ``launches``, fails unless the call launched exactly that
    many kernels, all the wrapper's own (``_check_launches``: no PyTorch
    kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = _device_ms(prof, 1)
    total = sum(ms for ms, _ in rows.values())
    print(f"profile {name} [{label}]: device ms {total!r} in "
          f"{sum(n for _, n in rows.values()):.0f} launches", flush=True)
    for key, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"  {ms:9.4f} ms {n:4.0f}x {key[:110]}", flush=True)
    if launches is not None:
        _check_launches(name, label, prof, rows, launches)
    return total



def _check_launches(name, label, prof, rows, launches):
    """Fails unless the profiled call made exactly ``launches`` kernel
    launches (counted on the host, where the profiler records every
    launch call, PyTorch's among them), no copy or fill, and every
    device-side kernel the profiler recorded is the wrapper's own (its
    name holds the loss's). The device-side records of a kernel of a few
    microseconds can be missing from a short profile after earlier ones
    in the same process; the host's launch calls are not."""
    own = name.split("_")[0] + "_"
    host = {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(LAUNCH_CALLS + COPY_CALLS)}
    made = sum(n for k, n in host.items() if k.startswith(LAUNCH_CALLS))
    copies = {k: n for k, n in host.items() if k.startswith(COPY_CALLS)}
    foreign = [key for key in rows if own not in key]
    seen = sum(n for _, n in rows.values())
    print(f"profile {name} [{label}]: {made} launches on the host "
          f"(expected {launches}), {seen:.0f} kernels recorded on the "
          f"device, all its own: {not foreign}", flush=True)
    if made != launches or copies or foreign or seen > launches:
        fail(f"profile {name} [{label}]: {made} launches, expected "
             f"{launches}; copies {copies}; other kernels {foreign}")


def _unfused_ms(x, w1, b1, w2, b2, activation, p, dy=None):
    """Milliseconds of the unfused route on the same inputs: ``F.linear``
    → activation → dropout → ``F.linear`` in x's dtype (cuBLAS; no single
    PyTorch call computes the block), or with ``dy`` its backward alone."""
    import torch
    import torch.nn.functional as F

    params = [t.to(x.dtype) for t in (w1.t().contiguous(), b1,
                                      w2.t().contiguous(), b2)]

    def block(x, w1t, b1, w2t, b2):
        h = F.linear(x, w1t, b1)
        h = F.relu(h) if activation == "relu" else F.gelu(
            h, approximate="tanh")
        return F.linear(F.dropout(h, p), w2t, b2)

    if dy is None:
        return cuda_ms(lambda: block(x, *params))
    leaves = [t.detach().requires_grad_() for t in (x, *params)]
    out = block(*leaves)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, dy,
                                               retain_graph=True))


def _ffn_kernels(gen, device, records):
    """Kernels 9 and 10 against their plain versions at ``FFN_SHAPES``,
    eval and train (p 0.1), ReLU at the ViT shape and f32 x at the card's
    profile shape; then the exact-sum dropout-mask check at each shape."""
    import torch
    from multimodal_plankton_recognition_torch.ops import ffn

    seed = 4321
    for name, (b, l, e, f, activation) in FFN_SHAPES.items():
        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=device) * scale

        x, dy = rnd(b, l, e), rnd(b, l, e)
        w1, b1 = rnd(e, f, scale=e ** -0.5), rnd(f, scale=0.1)
        w2, b2 = rnd(f, e, scale=f ** -0.5), rnd(e, scale=0.1)
        cases = [(activation, torch.bfloat16)]
        if name == "vit":
            cases.append(("relu", torch.bfloat16))
        if name == "card profile":
            cases.append((activation, torch.float32))
        for act, dtype in cases:
            args = (x.to(dtype), w1, b1, w2, b2)
            dyt = dy.to(dtype)
            for p in (0.0, 0.1):
                label = (f"{name} B={b} L={l} E={e} F={f} {act} "
                         f"{str(dtype)[6:]} p={p}")
                got = ffn.ffn_fwd(*args, act, p, seed)
                tol = FFN_TOL[act]
                err = _ffn_close(f"ffn_fwd {label}", [got],
                                 [ffn.ffn_reference(*args, act, p, seed)],
                                 tol)
                _repeats(f"ffn_fwd {label}", [got],
                         [ffn.ffn_fwd(*args, act, p, seed)])
                _report(records, "ffn_fwd", label, err,
                        f"{tol} of max(1, max|plain|); relative L2 "
                        f"{FFN_REL_TOL}",
                        cuda_ms(lambda: ffn.ffn_fwd(*args, act, p, seed)),
                        cuda_ms(lambda: ffn.ffn_reference(*args, act, p,
                                                          seed)),
                        _bound(args, got, 4 * b * l * e * f), None,
                        unfused_ms=_unfused_ms(*args, act, p))
                got = ffn.ffn_bwd(*args, dyt, act, p, seed)
                err = _ffn_close(f"ffn_bwd {label}", got,
                                 ffn.ffn_bwd_reference(*args, dyt, act, p,
                                                       seed), tol)
                _repeats(f"ffn_bwd {label}", got,
                         ffn.ffn_bwd(*args, dyt, act, p, seed))
                _report(records, "ffn_bwd", label, err,
                        f"{tol} of max(1, max|plain|) per output; "
                        f"relative L2 {FFN_REL_TOL}",
                        cuda_ms(lambda: ffn.ffn_bwd(*args, dyt, act, p,
                                                    seed)),
                        cuda_ms(lambda: ffn.ffn_bwd_reference(
                            *args, dyt, act, p, seed)),
                        _bound((args, dyt), got, 10 * b * l * e * f), None,
                        unfused_ms=_unfused_ms(*args, act, p, dyt))
                if name == "vit" and act == activation and \
                        dtype == torch.bfloat16:
                    _call_profile("ffn_fwd", label, lambda: ffn.ffn_fwd(
                        *args, act, p, seed))
                    _call_profile("ffn_bwd", label, lambda: ffn.ffn_bwd(
                        *args, dyt, act, p, seed))
        _ffn_mask_check(gen, device, name, b, l, e, f)


def _ffn_mask_check(gen, device, name, b, l, e, f):
    """ReLU on integer x and w1, ±1 w2 and dy, zero biases, p 0.1: every
    sum of y, dx, dw1, dw2 and db2 is exact in f32 in any order, so kernel
    and plain version agree bit for bit iff their dropout masks do."""
    import torch
    from multimodal_plankton_recognition_torch.ops import ffn

    def ints(*shape, lo=-1):
        return torch.randint(lo, 2, shape, generator=gen,
                             device=device).float()

    def signs(*shape):
        return torch.where(ints(*shape, lo=0) > 0, 1.0, -1.0)

    args = (ints(b, l, e).to(torch.bfloat16), ints(e, f),
            torch.zeros(f, device=device), signs(f, e),
            torch.zeros(e, device=device))
    dy = signs(b, l, e).to(torch.bfloat16)
    exact = [torch.equal(ffn.ffn_fwd(*args, "relu", 0.1, 99),
                         ffn.ffn_reference(*args, "relu", 0.1, 99))]
    got = ffn.ffn_bwd(*args, dy, "relu", 0.1, 99)
    want = ffn.ffn_bwd_reference(*args, dy, "relu", 0.1, 99)
    exact += [torch.equal(got[i], want[i]) for i in (0, 1, 3, 4)]
    print(f"kernel ffn [{name} relu p=0.1, integer inputs]: y, dx, dw1, dw2, "
          f"db2 bit for bit {exact} (must all be True: same dropout mask)",
          flush=True)
    if not all(exact):
        fail(f"ffn {name}: the kernels' dropout mask differs from the plain "
             f"version's")


def _clip_rate(emb):
    """The rate of the CLIP logits' products on ``emb``'s rows: bf16
    products are exact in f32, so the tensor cores' bf16 rate; f32 rows
    at the CUDA cores' rate."""
    import torch

    return BF16_FLOPS if emb.dtype == torch.bfloat16 else F32_FLOPS


def _clip_inputs(gen, device, buckets, n):
    """Seeded bf16 embeddings of ``buckets`` x ``n`` rows, width 512, and
    the scale and cotangent every CLIP row uses."""
    import torch

    img, prof = (torch.randn((buckets * n, 512), generator=gen,
                             device=device).to(torch.bfloat16)
                 for _ in range(2))
    return (img, prof, torch.full((), 0.7, device=device),
            torch.full((), 1.3, device=device))


def _clip_kernels(gen, device, records):
    """Kernels 5 and 6 against their plain versions at ``CLIP_SHAPES`` and
    ``CLIP_UNCAPPED``: the loss within 1e-5 relative, the gradients within
    1e-2 of the largest, d logit_scale within 1e-3 relative; a second call
    of each and the backward recomputing the forward's statistics equal
    to the backward given them, bit for bit; device ms of each, the plain
    versions' and the recomputing backward's (the two backward forms in
    turns); one profiled call of each by CUDA kernel at
    ``CLIP_PROFILED``."""
    import torch
    from multimodal_plankton_recognition_torch.ops.contrastive import (
        clip_bwd, clip_fwd, clip_loss_bwd_reference,
        clip_loss_fused_reference)

    for buckets, n in CLIP_SHAPES + (CLIP_UNCAPPED,):
        img, prof, scale, g = _clip_inputs(gen, device, buckets, n)
        label = f"buckets={buckets} N={n} D=512"
        loss, stats = clip_fwd(img, prof, scale, buckets, keep=True)
        want = clip_loss_fused_reference(img, prof, scale, buckets)
        err = _check(f"clip_fwd {label}", loss, want, CLIP_LOSS_TOL,
                     want.abs().item())
        got = clip_bwd(img, prof, scale, g, buckets, stats)
        ref = clip_loss_bwd_reference(img, prof, scale, g, buckets)
        top = max(w.float().abs().max().item() for w in ref[:2])
        gerr = max(_check(f"clip_bwd {what} {label}", got[i], ref[i],
                          CLIP_GRAD_TOL, top)
                   for i, what in enumerate(("d_image", "d_profile")))
        _check(f"clip_bwd d_logit_scale {label}", got[2], ref[2],
               CLIP_SCALE_TOL, ref[2].abs().item())
        exact = {"fwd again": torch.equal(loss, clip_fwd(img, prof, scale,
                                                         buckets)),
                 "bwd again": all(map(torch.equal, got, clip_bwd(
                     img, prof, scale, g, buckets, stats))),
                 "bwd recomputing": all(map(torch.equal, got, clip_bwd(
                     img, prof, scale, g, buckets)))}
        print(f"kernel clip [{label}]: bit for bit {exact} (must all be "
              f"True)", flush=True)
        if not all(exact.values()):
            fail(f"clip {label}: a second call or the recomputing backward "
                 f"differs from the first call: {exact}")
        # the logits of each bucket: 2 N^2 D products of the embeddings;
        # the backward's d_in and d_pn as many again each, of f32 ds
        flops = 2 * buckets * n * n * 512
        rate = _clip_rate(img)
        _report(records, "clip_fwd", label, err * want.abs().item(),
                CLIP_LOSS_TOL * want.abs().item(),
                cuda_ms(lambda: clip_fwd(img, prof, scale, buckets)),
                cuda_ms(lambda: clip_loss_fused_reference(img, prof, scale,
                                                          buckets)),
                _bound((img, prof, scale), (loss, stats), flops, rate))
        given = functools.partial(clip_bwd, img, prof, scale, g, buckets,
                                  stats)
        recomputing = functools.partial(clip_bwd, img, prof, scale, g,
                                        buckets)
        turns = [cuda_ms(f) for f in (given, recomputing, recomputing,
                                      given)]
        _report(records, "clip_bwd", label, gerr * top, CLIP_GRAD_TOL * top,
                (turns[0] + turns[3]) / 2,
                cuda_ms(lambda: clip_loss_bwd_reference(img, prof, scale, g,
                                                        buckets)),
                _bound((img, prof, scale, g, stats), got, flops, rate,
                       2 * flops),
                recomputing_ms=(turns[1] + turns[2]) / 2)
        if (buckets, n) in CLIP_PROFILED:
            _call_profile("clip_fwd", label, lambda: clip_fwd(
                img, prof, scale, buckets))
            _call_profile("clip_bwd", label, given)


def _siglip_inputs(gen, device, buckets, n):
    """Seeded bf16 embeddings of ``buckets`` x ``n`` rows, width 512."""
    import torch

    return [torch.randn((buckets * n, 512), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2)]


def _siglip_kernels(gen, device, records):
    """Kernels 7 and 8 against their plain versions at ``SIGLIP_SHAPES``
    and ``SIGLIP_UNCAPPED``, each at the three ``SIGLIP_SCALARS``: the CLIP
    tolerances, d logit_bias like d logit_scale; a second call of each bit
    for bit equal to the first; device ms of each and its plain version at
    the head's init scalars, beside the bound (the forward's and the
    backward's recomputed 2 N^2 D products of bf16 rows at the bf16 tensor
    rate, the backward's 4 N^2 D products of f32 ds at the f32 rate); one
    profiled call of each by CUDA kernel at ``SIGLIP_PROFILED``: one
    forward kernel, one backward kernel for a bucket of 16 rows or fewer
    and two above, and no PyTorch kernel."""
    import torch
    from multimodal_plankton_recognition_torch.ops.contrastive import (
        siglip_bwd, siglip_fwd, siglip_loss_bwd_reference,
        siglip_loss_fused_reference)

    g = torch.full((), 1.3, device=device)
    for buckets, n in SIGLIP_SHAPES + (SIGLIP_UNCAPPED,):
        img, prof = _siglip_inputs(gen, device, buckets, n)
        for i, (s, b) in enumerate(SIGLIP_SCALARS):
            scale = torch.full((), s, device=device)
            bias = torch.full((), b, device=device)
            args = (img, prof, scale, bias)
            label = f"buckets={buckets} N={n} D=512" + (
                f" scale={s} bias={b}" if i else "")
            loss = siglip_fwd(*args, buckets)
            want = siglip_loss_fused_reference(*args, buckets)
            loss_scale = want.abs().item()
            loss_err = _check(f"siglip_fwd {label}", loss, want,
                              CLIP_LOSS_TOL, loss_scale)
            got = siglip_bwd(*args, g, buckets)
            want = siglip_loss_bwd_reference(*args, g, buckets)
            top = max(w.float().abs().max().item() for w in want[:2])
            err = max(_check(f"siglip_bwd {what} {label}", got[k], want[k],
                             CLIP_GRAD_TOL, top)
                      for k, what in enumerate(("d_image", "d_profile")))
            for k, what in ((2, "d_logit_scale"), (3, "d_logit_bias")):
                _check(f"siglip_bwd {what} {label}", got[k], want[k],
                       CLIP_SCALE_TOL, want[k].abs().item())
            exact = {"fwd again": torch.equal(loss, siglip_fwd(*args,
                                                                buckets)),
                     "bwd again": all(map(torch.equal, got, siglip_bwd(
                         *args, g, buckets)))}
            print(f"kernel siglip [{label}]: loss err {loss_err!r} "
                  f"(relative, tol {CLIP_LOSS_TOL}), grad err {err!r} (of "
                  f"the largest, tol {CLIP_GRAD_TOL}), finite; bit for bit "
                  f"{exact} (must all be True)", flush=True)
            if not all(exact.values()):
                fail(f"siglip {label}: a second call differs from the "
                     f"first: {exact}")
            if i:
                continue
            flops = 2 * buckets * n * n * 512
            rate = _clip_rate(img)
            _report(records, "siglip_fwd", label, loss_err * loss_scale,
                    CLIP_LOSS_TOL * loss_scale,
                    cuda_ms(lambda: siglip_fwd(*args, buckets)),
                    cuda_ms(lambda: siglip_loss_fused_reference(*args,
                                                                buckets)),
                    _bound(args, loss, flops, rate))
            _report(records, "siglip_bwd", label, err * top,
                    CLIP_GRAD_TOL * top,
                    cuda_ms(lambda: siglip_bwd(*args, g, buckets)),
                    cuda_ms(lambda: siglip_loss_bwd_reference(*args, g,
                                                              buckets)),
                    _bound((args, g), got, flops, rate, 2 * flops))
            if (buckets, n) in SIGLIP_PROFILED:
                _call_profile("siglip_fwd", label,
                              lambda: siglip_fwd(*args, buckets), 1)
                _call_profile("siglip_bwd", label,
                              lambda: siglip_bwd(*args, g, buckets),
                              1 if n <= 16 else 2)


def _mbconv_kernels(gen, device, records):
    """MBConv kernels 13-16 against their plain versions at B0's blocks of
    ``MBCONV_SHAPES``, each on the inputs its plain version gets (kernel
    14 and 16 on the plain y2, m1, v1)."""
    import torch
    from multimodal_plankton_recognition_torch.ops import mbconv as mb

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale \
            + shift

    b = B0_CARD["bs"]
    for block, (hw, cin, mid, cout, k, r) in MBCONV_SHAPES.items():
        expand = mid != cin
        x = rnd(b, hw, hw, cin).to(torch.bfloat16)
        wexp = rnd(cin, mid, scale=cin ** -0.5) if expand else None
        g1 = rnd(mid, scale=0.1, shift=1.0) if expand else None
        b1 = rnd(mid, scale=0.1) if expand else None
        wdw = rnd(k, k, mid, scale=1.0 / k)
        g2, b2 = rnd(mid, scale=0.1, shift=1.0), rnd(mid, scale=0.1)
        wr, br = rnd(mid, r, scale=mid ** -0.5), rnd(r, scale=0.1)
        we, be = rnd(r, mid, scale=r ** -0.5), rnd(mid, scale=0.1)
        wproj = rnd(mid, cout, scale=mid ** -0.5)
        dy3 = rnd(b, hw, hw, cout).to(torch.bfloat16)
        dy2 = rnd(b, hw, hw, mid).to(torch.bfloat16)
        y2, m1, v1, m2, v2 = mb.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
        n = b * hw * hw
        se = 4 * b * mid * r  # the SE products, per pass
        # (name, wrapper, plain version, arguments, bf16 products)
        cases = (
            ("mbconv_ka_fwd", mb.ka_fwd, mb.ka_fwd_reference,
             (x, wexp, g1, b1, wdw, k),
             2 * n * cin * mid * expand + 2 * n * mid * k * k),
            ("mbconv_kb_fwd", mb.kb_fwd, mb.kb_fwd_reference,
             (y2, g2, b2, m2, v2, wr, br, we, be, wproj),
             2 * n * mid * cout + se),
            ("mbconv_kb_bwd", mb.kb_bwd, mb.kb_bwd_reference,
             (y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj),
             4 * n * mid * cout + 3 * se),
            ("mbconv_ka_bwd", mb.ka_bwd, mb.ka_bwd_reference,
             (x, dy2, wexp, g1, b1, wdw, m1, v1, k),
             6 * n * cin * mid * expand + 4 * n * mid * k * k))
        label = (f"{block} B={b} H=W={hw} cin={cin} mid={mid} cout={cout} "
                 f"k={k} r={r}")
        for name, fn, plain, args, flops in cases:
            want = plain(*args)
            got = fn(*args)
            err = rel = 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                if (g is None) != (w is None):
                    fail(f"{name} {label}: output {i} is None on one side")
                if w is None:
                    continue
                scale = max(1.0, w.float().abs().max().item())
                err = max(err, scale * _check(f"{name} {label} output {i}",
                                              g, w, MBCONV_TOL, scale))
                diff = (g.float() - w.float()).norm().item()
                rel = max(rel, diff / max(w.float().norm().item(), 1e-30))
            if not rel <= MBCONV_REL_TOL:
                fail(f"{name} {label}: relative L2 error {rel!r} > "
                     f"{MBCONV_REL_TOL}")
            _repeats(f"{name} {label}", got, fn(*args))
            if block in KA_BWD_PROFILED:
                _call_profile(name, label, lambda: fn(*args))
            _report(records, name, label, err,
                    f"{MBCONV_TOL} of max(1, max|plain|) per output; "
                    f"relative L2 {rel!r} (tol {MBCONV_REL_TOL})",
                    cuda_ms(lambda: fn(*args)), cuda_ms(lambda: plain(*args)),
                    _bound(args, want, flops))


def _mha_module_ms(args, heads, p=0.0, dy=None, fast=True):
    """Milliseconds of ``nn.MultiheadAttention(batch_first=True,
    dropout=p)`` on the block's inputs and bf16 weights
    (``key_padding_mask`` from the bias rows). The forward: with ``fast``
    and p 0 in eval under ``inference_mode``, where the layer takes its
    fast path if it can (even heads), else in train mode under
    ``no_grad``, its standard path (SDPA, dropout p). With ``dy``: its
    backward alone, in train mode at dropout p."""
    import torch

    x, wqkv, bqkv, wo, bo, bias = args
    e = x.shape[-1]
    layer = torch.nn.MultiheadAttention(e, heads, dropout=p,
                                        batch_first=True, device=x.device,
                                        dtype=x.dtype)
    with torch.no_grad():
        for param, value in ((layer.in_proj_weight, wqkv),
                             (layer.in_proj_bias, bqkv),
                             (layer.out_proj.weight, wo),
                             (layer.out_proj.bias, bo)):
            param.copy_(value)
    pad = None if bias is None else bias < 0
    if dy is None:
        layer.train(not (fast and p == 0.0))
        with (torch.inference_mode() if not layer.training
              else torch.no_grad()):
            return cuda_ms(lambda: layer(x, x, x, key_padding_mask=pad,
                                         need_weights=False))
    leaf = x.detach().requires_grad_()
    out = layer(leaf, leaf, leaf, key_padding_mask=pad, need_weights=False)[0]
    leaves = [leaf, *layer.parameters()]
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, dy,
                                               retain_graph=True))


def _block_close(label, got, want):
    """y and dx (outputs 0): ``KERNEL_TOL`` of max(1, their largest plain
    value) and ``BLOCK_REL_TOL`` relative L2; weight and bias gradients:
    ``BWD_TOL`` of their largest plain value. Returns the largest
    absolute error."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{label} output {i}: {tuple(g.shape)} {g.dtype}, plain "
                 f"{tuple(w.shape)} {w.dtype}")
        top = w.float().abs().max().item()
        if i == 0:
            scale = max(1.0, top)
            err = max(err, scale * _check(f"{label} output 0", g, w,
                                          KERNEL_TOL, scale))
            rel = ((g.float() - w.float()).norm()
                   / max(w.float().norm().item(), 1e-30)).item()
            if not rel <= BLOCK_REL_TOL:
                fail(f"{label} output 0: relative L2 error {rel!r} > "
                     f"{BLOCK_REL_TOL}")
        else:
            err = max(err, top * _check(f"{label} output {i}", g, w,
                                        BWD_TOL, top))
    return err


def _block_kernels(gen, device, records):
    """Kernels 11 and 12 against their plain versions at the attention
    shapes (``SHAPES``), eval and train (p 0.1) at the masked ones; kernel
    12 on the residual path (the autograd path's: kernel 11's q|k|v and
    o given), beside the recomputing call, the two bit for bit and a
    second call bit for bit; a profile of one call of each at ViT-T; then
    the identity-projection mask check against kernels 1-2."""
    import torch
    from multimodal_plankton_recognition_torch.ops import attention_block as ab

    seed = 2468
    for name, (b, l, heads, e, masked) in SHAPES.items():
        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=device) * scale

        bias = None
        if masked:
            pad = torch.rand((b, l), generator=gen, device=device) < 0.3
            pad[:, 0] = False
            bias = torch.where(pad, -1e9, 0.0).to(torch.float32)
        args = (rnd(b, l, e).to(torch.bfloat16),
                rnd(3 * e, e, scale=e ** -0.5).to(torch.bfloat16),
                rnd(3 * e, scale=0.1),
                rnd(e, e, scale=e ** -0.5).to(torch.bfloat16),
                rnd(e, scale=0.1), bias)
        dy = rnd(b, l, e).to(torch.bfloat16)
        # the products the block needs: projections 8 B L E^2 (q, k, v and
        # out), attention 4 B L^2 E; the backward twice both
        flops = 8 * b * l * e * e + 4 * b * l * l * e
        for p in (0.0, 0.1) if masked else (0.0,):
            label = (f"{name} B={b} L={l} H={heads} E={e} mask={masked} "
                     f"p={p}")
            got = ab.attn_block_fwd(*args, heads, p, seed)
            err = _block_close(f"attn_block_fwd {label}", [got],
                               [ab.attn_block_reference(*args, heads, p,
                                                        seed)])
            _report(records, "attn_block_fwd", label, err,
                    f"{KERNEL_TOL} of max(1, max|plain|); relative L2 "
                    f"{BLOCK_REL_TOL}",
                    cuda_ms(lambda: ab.attn_block_fwd(*args, heads, p,
                                                      seed)),
                    cuda_ms(lambda: ab.attn_block_reference(*args, heads, p,
                                                            seed)),
                    _bound(args, got, flops), _mha_module_ms(args, heads, p),
                    **({"library_standard_ms": _mha_module_ms(
                        args, heads, fast=False)} if p == 0.0 else {}))
            _, qkv, o = ab.attn_block_fwd(*args, heads, p, seed, keep=True)
            res = {"qkv": qkv, "o": o}
            got = ab.attn_block_bwd(*args, dy, heads, p, seed, **res)
            err = _block_close(f"attn_block_bwd {label}", got,
                               ab.attn_block_bwd_reference(*args, dy, heads,
                                                           p, seed, **res))
            _block_repeats(label, got, [
                ab.attn_block_bwd(*args, dy, heads, p, seed),
                ab.attn_block_bwd(*args, dy, heads, p, seed, **res)])
            _report(records, "attn_block_bwd", label, err,
                    f"dx {KERNEL_TOL} of max(1, max|plain|), relative L2 "
                    f"{BLOCK_REL_TOL}; weight and bias gradients {BWD_TOL} "
                    f"of their largest",
                    cuda_ms(lambda: ab.attn_block_bwd(*args, dy, heads, p,
                                                      seed, **res)),
                    cuda_ms(lambda: ab.attn_block_bwd_reference(
                        *args, dy, heads, p, seed, **res)),
                    _bound((args, dy, qkv, o), got, 2 * flops),
                    _mha_module_ms(args, heads, p, dy),
                    recompute_ms=cuda_ms(lambda: ab.attn_block_bwd(
                        *args, dy, heads, p, seed)))
            if name == "vit":
                _block_profile(label, args, dy, heads, p, seed, res)
        if masked:
            _block_mask_check(gen, device, name, b, l, heads, e, bias)


def _block_repeats(label, got, again):
    """Kernel 12's outputs ``got`` (given the residuals) against, bit for
    bit, the recomputing call's and a second call's (``again``)."""
    import torch

    same = [all(torch.equal(g, a) for g, a in zip(got, other))
            for other in again]
    print(f"kernel attn_block_bwd [{label}]: with and without residuals "
          f"bit for bit {same[0]}, two calls bit for bit {same[1]} (must "
          f"both be True)", flush=True)
    if not all(same):
        fail(f"attn_block_bwd {label}: the residual path, the recomputing "
             f"path and a second call are not bit for bit equal: {same}")


def _block_profile(label, args, dy, heads, p, seed, res):
    """Device ms of one call of kernel 11 and one of kernel 12 (residual
    path) by CUDA kernel: the GEMM stages (``gemm_rows_kernel``,
    ``wgrad_kernel``, ``reduce_kernel``) against the attention stage
    (``attn_fwd`` / ``attn_bwd``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_plankton_recognition_torch.ops import attention_block as ab

    for name, call in (
            ("attn_block_fwd", lambda: ab.attn_block_fwd(*args, heads, p,
                                                         seed)),
            ("attn_block_bwd", lambda: ab.attn_block_bwd(*args, dy, heads, p,
                                                         seed, **res))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        rows = _device_ms(prof, 1)
        stages = {"attention": 0.0, "gemm": 0.0}
        for key, (ms, _) in rows.items():
            stages["attention" if "attn_" in key else "gemm"] += ms
        print(f"profile {name} [{label}]: device ms {stages!r}", flush=True)
        for key, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
            print(f"  {ms:9.4f} ms {n:4.0f}x {key[:110]}", flush=True)


def _block_mask_check(gen, device, name, b, l, heads, e, bias):
    """Identity projections (q = k = 0, v = x = ±1, out the identity, zero
    biases), p 0.1: kernel 11's y must equal kernel 1's output and kernel
    12's dx kernel 2's dv bit for bit, so the masks agree."""
    import torch
    from multimodal_plankton_recognition_torch.ops import attention_block as ab
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_qkv, mha_qkv_bwd)

    def signs(*shape):
        return torch.where(torch.rand(shape, generator=gen, device=device)
                           < 0.5, -1.0, 1.0).to(torch.bfloat16)

    x, dy = signs(b, l, e), signs(b, l, e)
    wqkv = torch.zeros((3 * e, e), device=device)
    wqkv[2 * e:] = torch.eye(e, device=device)
    args = (x, wqkv, torch.zeros(3 * e, device=device),
            torch.eye(e, device=device), torch.zeros(e, device=device), bias)
    qkv = torch.cat([torch.zeros_like(x), torch.zeros_like(x), x], dim=-1)
    exact = [torch.equal(ab.attn_block_fwd(*args, heads, 0.1, 99),
                         mha_qkv(qkv, bias, heads, 0.1, 99)),
             torch.equal(ab.attn_block_bwd(*args, dy, heads, 0.1, 99)[0],
                         mha_qkv_bwd(qkv, bias, dy, heads, 0.1,
                                     99)[..., 2 * e:])]
    print(f"kernel attn_block [{name} D={e // heads} train p=0.1, identity "
          f"projections]: y = kernel 1, dx = kernel 2's dv bit for bit "
          f"{exact} (must both be True: same dropout mask)", flush=True)
    if not all(exact):
        fail(f"attn_block {name}: kernels 11-12 differ from kernels 1-2 "
             f"under identity projections")


@contextlib.contextmanager
def _plain_attention():
    """Every attention core of the module (kernels 1-4, 11-12) on its plain
    version, under the kernels' own autograd functions, on the card's
    tensors: the comparison route of the encode, train and card phases.
    The kernel wrappers are back on exit, and it fails if any attention
    kernel launched inside, so the plain route never ran a kernel."""
    from multimodal_plankton_recognition_torch.ops import (
        attention, attention_block)

    names = ("mha_qkv_fwd", "mha_qkv_bwd", "mha_fwd", "mha_bwd",
             "attn_block_fwd", "attn_block_bwd")
    # the wrappers' counts, set to 0 inside (a phase may reset them there)
    # and put back after
    saved = {n: _counts()[n] for n in names}
    for n in names:
        _counters()[n].launches = 0
    swaps = ((attention, "_fwd", attention.mha_qkv_reference),
             (attention, "mha_qkv_bwd", attention.mha_qkv_bwd_reference),
             (attention, "_mha_fwd", attention.mha_reference),
             (attention, "mha_bwd", attention.mha_bwd_reference),
             (attention_block, "attn_block_fwd",
              attention_block.attn_block_reference),
             (attention_block, "attn_block_bwd",
              attention_block.attn_block_bwd_reference))
    kernels = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(swaps, kernels):
            setattr(module, name, fn)
    inside = {n: _counts()[n] for n in names}
    for n in names:
        _counters()[n].launches = saved[n]
    if any(inside.values()):
        fail(f"the plain attention route launched kernels: {inside}")


def phase_slice(device):
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier

    model = init_weights_(flagship_vit(), torch.Generator().manual_seed(0))
    model.to(device).eval()

    gallery = synthetic_batch_vit(GALLERY, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, GALLERY)
    emb, rate, launches = _encode_timed(model, gallery, labels, device)
    n_batches = GALLERY // BATCH
    print(f"slice: encoded {GALLERY} pairs in {n_batches} batches of "
          f"{BATCH}: {rate!r} pairs/s, launches {launches}", flush=True)
    want = {n: c * n_batches
            for n, c in _per_step(mha_qkv_fwd=ATTENTION_LAYERS).items()}
    if launches != want:
        fail(f"encode: expected launches {want}, got {launches}")
    with _plain_attention():
        ref, plain_rate, _ = _encode_timed(model, gallery, labels, device)
    print(f"slice: plain attention (the kernels' plain versions) "
          f"{plain_rate!r} pairs/s", flush=True)
    _check_embeddings("slice (reference: plain attention)", emb, labels,
                      device, ref)

    image, profile = emb["image"], emb["profile"]
    setups = {
        "image": (ANNClassifier(image, labels, device), (image,)),
        "profile": (ANNClassifier(profile, labels, device), (profile,)),
        "image->profile": (ANNClassifier(profile, labels, device), (image,)),
        "image+profile": (ANNClassifier(np.concatenate([image, profile]),
                                        np.tile(labels, 2), device),
                          (image, profile)),
    }
    for name, (clf, queries) in setups.items():
        acc = float((clf.predict(*queries, k=1) == labels).mean())
        print(f"retrieval {name}: self-gallery k=1 accuracy {acc!r}",
              flush=True)
        if name != "image->profile" and acc < 0.99:
            fail(f"retrieval {name}: self-gallery accuracy {acc} < 0.99")
    return launches


def _train_state(model, state_dict, device, buckets=BUCKETS):
    from multimodal_plankton_recognition_torch.config import OptimConfig
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_multi_steps, make_optimizer)

    tx = make_optimizer(OptimConfig(lr=5e-3, momentum=0.9, weight_decay=1e-3,
                                    nesterov=True))
    model.to(device)
    state = create_train_state(model, state_dict, tx)
    train_step, _ = make_multi_steps(model, tx, buckets=buckets)
    return state, train_step


@functools.cache
def _counters():
    """{kernel name: wrapper}, each wrapper with its ``.launches`` count
    (taken once, so a phase that swaps a wrapper for its plain version
    still reads the wrapper's count)."""
    from multimodal_plankton_recognition_torch.ops import (
        attention, attention_block, contrastive, ffn, mbconv)

    return {"mha_qkv_fwd": attention.mha_qkv,
            "mha_qkv_bwd": attention.mha_qkv_bwd,
            "mha_fwd": attention.mha,
            "mha_bwd": attention.mha_bwd,
            "ffn_fwd": ffn.ffn_fwd,
            "ffn_bwd": ffn.ffn_bwd,
            "clip_fwd": contrastive.clip_fwd,
            "clip_bwd": contrastive.clip_bwd,
            "siglip_fwd": contrastive.siglip_fwd,
            "siglip_bwd": contrastive.siglip_bwd,
            "mbconv_ka_fwd": mbconv.ka_fwd,
            "mbconv_kb_fwd": mbconv.kb_fwd,
            "mbconv_kb_bwd": mbconv.kb_bwd,
            "mbconv_ka_bwd": mbconv.ka_bwd,
            "attn_block_fwd": attention_block.attn_block_fwd,
            "attn_block_bwd": attention_block.attn_block_bwd}


def _per_step(**counts):
    """Launches per step of every counted kernel: ``counts``, else 0."""
    return {name: counts.get(name, 0) for name in _counters()}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _pairs_per_s(state, train_step, batch, steps):
    """Train pairs/s over ``steps`` steps, ended by a synchronize."""
    import torch

    bs = batch["image"].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = train_step(state, batch, 0)
    torch.cuda.synchronize()
    return bs * steps / (time.perf_counter() - t0)


def phase_train(device):
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    # the CLIP flagship never routes through SigLIP or an MBConv kernel
    per_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                         mha_qkv_bwd=ATTENTION_LAYERS, clip_fwd=1,
                         clip_bwd=1)
    # f32 masters from an f32 model: never from one already rounded to bf16
    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    model = flagship_vit()
    state, train_step = _train_state(model, init, device)

    _reset_counts()
    torch.cuda.synchronize()
    losses = []
    for i in range(TRAIN_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = train_step(state, batch, 0)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    timed = TRAIN_STEPS - WARMUP_STEPS
    losses = [float(x) for x in losses]
    print(f"train: {TRAIN_STEPS} steps of {BATCH} pairs, buckets {BUCKETS}: "
          f"{BATCH * timed / seconds!r} pairs/s over steps "
          f"{WARMUP_STEPS + 1}-{TRAIN_STEPS} ({seconds / timed * 1e3!r} ms "
          f"per step); launches {launches}", flush=True)
    print(f"train: losses {losses}", flush=True)
    for name, n in per_step.items():
        if launches[name] != n * TRAIN_STEPS:
            fail(f"expected {n} {name} launches per train step, got "
                 f"{launches[name]} over {TRAIN_STEPS} steps")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite train loss: {losses}")
    if not min(losses[-5:]) < losses[0]:
        fail(f"train loss did not fall: first {losses[0]}, last five "
             f"{losses[-5:]}")
    if any(m.dtype != torch.float32 for m in state.params.values()):
        fail("master weights are not all f32")
    if any(p.dtype != torch.bfloat16 for n, p in model.named_parameters()
           if not n.startswith("coordination.")):
        fail("the compute module is not bf16")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved:
        fail(f"master weights that did not move: {unmoved}")

    # one step from the same weights, dropout 0: kernel path vs plain path
    grads = {}
    step_losses = {}
    for path, kw in (("kernel", {}), ("plain", {"fused_loss": False})):
        m = flagship_vit(dropout=0.0, **kw)
        st, step = _train_state(m, init, device)
        with (_plain_attention() if path == "plain"
              else contextlib.nullcontext()):
            _, loss = step(st, batch, 0)
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in NAMED_GRADS}
        del m, st
    loss_err = abs(step_losses["kernel"] - step_losses["plain"])
    print(f"train step, dropout 0: loss kernel {step_losses['kernel']!r} "
          f"plain {step_losses['plain']!r} (|diff| {loss_err!r}, tol "
          f"{STEP_LOSS_TOL})", flush=True)
    if not loss_err <= STEP_LOSS_TOL:
        fail(f"kernel and plain train steps disagree on the loss: {loss_err}")
    _grad_diffs("train", grads, NAMED_GRADS, STEP_GRAD_TOL)

    plain = flagship_vit(fused_loss=False)
    pstate, pstep = _train_state(plain, init, device)
    with _plain_attention():
        _pairs_per_s(pstate, pstep, batch, WARMUP_STEPS)
        plain_rate = _pairs_per_s(pstate, pstep, batch, PLAIN_STEPS)
    print(f"train: plain path {plain_rate!r} pairs/s over {PLAIN_STEPS} "
          f"steps", flush=True)
    return launches


@contextlib.contextmanager
def _plain_loss(loss):
    """The ``loss`` wrappers (``"clip"`` or ``"siglip"``) swapped for their
    plain versions under the same autograd function, on the card's
    tensors: the global phases' comparison route; fails if a kernel of
    that loss launched inside."""
    from multimodal_plankton_recognition_torch.ops import contrastive

    names = (f"{loss}_fwd", f"{loss}_bwd")
    plain = {"clip": (contrastive.clip_loss_fused_reference,
                      contrastive.clip_loss_bwd_reference),
             "siglip": (contrastive.siglip_loss_fused_reference,
                        contrastive.siglip_loss_bwd_reference)}[loss]
    before = {n: _counts()[n] for n in names}
    kernels = [getattr(contrastive, n) for n in names]
    for n, fn in zip(names, plain):
        setattr(contrastive, n, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, kernels):
            setattr(contrastive, n, fn)
    after = {n: _counts()[n] for n in before}
    if after != before:
        fail(f"the plain {loss} route launched kernels: {before} -> {after}")


def phase_global(device):
    """``negatives: global`` on the ViT flagship: phase 5's weights and f32
    masters through ``make_multi_steps(..., buckets=1)`` (one bucket of
    256, as ``step_buckets`` gives a card with global negatives):
    ``GLOBAL_STEPS`` train steps with 14 + 14 attention and 1 + 1 CLIP
    launches each, finite losses, the least of the last steps below the
    first, every master moved; one dropout-0 step against the CLIP
    kernels' plain versions (loss 1e-2, named gradients 5e-2); a
    ``summary:`` line of train pairs/s at buckets 16 and 1 in turns (16,
    1, 1, 16). Returns the launches of the ``GLOBAL_STEPS`` steps."""
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    per_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                         mha_qkv_bwd=ATTENTION_LAYERS, clip_fwd=1,
                         clip_bwd=1)
    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    state, train_step = _train_state(flagship_vit(), init, device, buckets=1)
    _reset_counts()
    losses = []
    for _ in range(GLOBAL_STEPS):
        state, loss = train_step(state, batch, 0)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = _counts()
    losses = [float(x) for x in losses]
    print(f"global: {GLOBAL_STEPS} steps of {BATCH} pairs in one bucket: "
          f"losses {losses}; launches {launches}", flush=True)
    want = {n: c * GLOBAL_STEPS for n, c in per_step.items()}
    if launches != want:
        fail(f"global: expected launches {want}, got {launches}")
    if not all(map(math.isfinite, losses)):
        fail(f"global: non-finite train loss: {losses}")
    if not min(losses[1:]) < losses[0]:
        fail(f"global: train loss did not fall: {losses}")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved:
        fail(f"global: master weights that did not move: {unmoved}")
    del state, train_step

    grads, step_losses = {}, {}
    for path in ("kernel", "plain"):
        m = flagship_vit(dropout=0.0)
        st, step = _train_state(m, init, device, buckets=1)
        with (_plain_loss("clip") if path == "plain"
              else contextlib.nullcontext()):
            _, loss = step(st, batch, 0)
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in NAMED_GRADS}
        del m, st
    loss_err = abs(step_losses["kernel"] - step_losses["plain"])
    print(f"global step, dropout 0: loss kernel {step_losses['kernel']!r} "
          f"plain CLIP {step_losses['plain']!r} (|diff| {loss_err!r}, tol "
          f"{STEP_LOSS_TOL})", flush=True)
    if not loss_err <= STEP_LOSS_TOL:
        fail(f"global: kernel and plain CLIP steps disagree on the loss: "
             f"{loss_err}")
    _grad_diffs("global", grads, NAMED_GRADS, STEP_GRAD_TOL)

    routes = {b: _train_state(flagship_vit(), init, device, buckets=b)
              for b in (BUCKETS, 1)}
    rates = {b: [] for b in routes}
    for b in routes:
        _pairs_per_s(*routes[b], batch, WARMUP_STEPS)
    for b in (BUCKETS, 1, 1, BUCKETS):
        rates[b].append(_pairs_per_s(*routes[b], batch, PLAIN_STEPS))
    mean = {b: statistics.mean(r) for b, r in rates.items()}
    print(f"summary: global negatives, train pairs/s over {PLAIN_STEPS} "
          f"steps in turns (16, 1, 1, 16): buckets {BUCKETS} "
          f"{rates[BUCKETS]!r}, buckets 1 {rates[1]!r}; ratio 1 / {BUCKETS} "
          f"{mean[1] / mean[BUCKETS]!r}", flush=True)
    return launches


def _card(base=CARD, **overrides):
    """A card (the SigLIP one unless ``base`` is given) and the port's
    train-step pieces built from it: (card, bf16 model on the CPU,
    optimizer, train_step, eval_step). ``overrides``: encoder and head
    keys to change."""
    import copy
    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model, step_buckets)
    from multimodal_plankton_recognition_torch.train import (
        make_multi_steps, make_optimizer)

    d = copy.deepcopy(base)
    for field in ("image_encoder_args", "profile_encoder_args",
                  "coordination_args"):
        d[field].update(overrides.get(field, {}))
    card = ModelCard.from_dict(d)
    model = build_multi_model(card)
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    train_step, eval_step = make_multi_steps(model, tx, step_buckets(card))
    return card, model, tx, train_step, eval_step


CARD_NAMED_GRADS = ("coordination.logit_bias",) + NAMED_GRADS
# the plain path of a card: unfused SigLIP, and the attention kernels'
# plain versions (``_plain_attention``) around its steps
PLAIN_CARD = {"coordination_args": {"fused": False}}


def _fit_card(what, card, state, train_step, eval_step, batch, per_step,
              per_eval):
    """``Fitter`` for ``CARD_EPOCHS`` epochs of ``CARD_STEPS`` micro-steps
    on ``batch`` with ``CARD_VALID`` eval steps each, asserting the kernel
    launches of every micro-step (``per_step``) and eval step
    (``per_eval``), finite and falling losses and f32 masters; returns
    (state, launches, train pairs/s over micro-steps 4-20 of epoch 1)."""
    import torch
    from multimodal_plankton_recognition_torch.train import Fitter

    def delta(before, want, step):
        got = {n: c - before[n] for n, c in _counts().items()}
        if got != want:
            fail(f"{what} {step}: expected launches {want}, got {got}")

    losses, clock = [], {}

    def counted_train_step(state, batch, seed):
        i = len(losses)
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            clock["t0"] = time.perf_counter()
        before = _counts()
        state, loss = train_step(state, batch, seed)
        delta(before, per_step, f"train micro-step {i + 1}")
        losses.append(loss)
        if i == CARD_STEPS - 1:
            torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
        return state, loss

    def counted_eval_step(state, batch):
        before = _counts()
        out = eval_step(state, batch)
        delta(before, per_eval, "eval step")
        return out

    fitter = Fitter(counted_train_step, counted_eval_step,
                    max_epochs=CARD_EPOCHS,
                    check_val_every_n_epoch=(
                        card.trainer_args.check_val_every_n_epoch),
                    seed=card.seed, put_fn=lambda b: b)
    bs = card.bs
    _reset_counts()
    torch.cuda.synchronize()
    state = fitter.fit(state, [batch] * CARD_STEPS, [batch] * CARD_VALID)
    torch.cuda.synchronize()
    launches = _counts()
    timed = CARD_STEPS - WARMUP_STEPS
    rate = bs * timed / (clock["t1"] - clock["t0"])
    losses = [float(x) for x in losses]
    print(f"{what}: {CARD_EPOCHS} epochs of {CARD_STEPS} micro-steps of "
          f"{bs} pairs, buckets {card.buckets}, accumulation "
          f"{card.trainer_args.accumulate_grad_batches}: {rate!r} train "
          f"pairs/s over micro-steps {WARMUP_STEPS + 1}-{CARD_STEPS} of "
          f"epoch 1 ({(clock['t1'] - clock['t0']) / timed * 1e3!r} ms per "
          f"micro-step); launches {launches}", flush=True)
    print(f"{what}: history {fitter.history}", flush=True)
    print(f"{what}: micro-step losses {losses}", flush=True)
    want = {n: CARD_EPOCHS * (CARD_STEPS * per_step[n] + CARD_VALID
                              * per_eval[n]) for n in per_step}
    if launches != want:
        fail(f"{what}: expected launches {want}, got {launches}")
    if not all(map(math.isfinite, losses)) or not all(
            math.isfinite(h["train_loss"]) and math.isfinite(h["valid_loss"])
            for h in fitter.history) or len(fitter.history) != CARD_EPOCHS:
        fail(f"{what}: non-finite losses or history: {fitter.history}")
    if not min(losses[-5:]) < losses[0]:
        fail(f"{what}: train loss did not fall: first {losses[0]}, last "
             f"five {losses[-5:]}")
    if any(m.dtype != torch.float32 for m in state.params.values()):
        fail(f"{what}: master weights are not all f32")
    return state, launches, rate


def _grad_diffs(what, grads, names, tol):
    """Relative L2 difference of each named gradient, kernel path against
    ``grads["plain"]``, all printed; fails if one is above ``tol``."""
    worst = {}
    for n in names:
        k, p = grads["kernel"][n], grads["plain"][n]
        rel = ((k - p).norm() / p.norm()).item()
        print(f"  grad {n}: relative L2 diff {rel!r} (tol {tol})",
              flush=True)
        if not rel <= tol:
            worst[n] = rel
    if worst:
        fail(f"{what}: kernel and plain steps disagree on {worst}")


def phase_card(device):
    """The SigLIP card's train path: card dict -> ModelCard ->
    build_multi_model -> train step with accumulation 4 -> Fitter."""
    import torch
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model)
    from multimodal_plankton_recognition_torch.models.flagships import (
        init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.train import (
        create_train_state)

    per_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                         mha_qkv_bwd=ATTENTION_LAYERS, siglip_fwd=1,
                         siglip_bwd=1)
    per_eval = _per_step(mha_qkv_fwd=ATTENTION_LAYERS, siglip_fwd=1)
    card, model, tx, train_step, eval_step = _card()
    bs = card.bs
    # f32 masters from an f32 model: never from one already rounded to bf16
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    model.to(device)
    state = create_train_state(model, init, tx)
    batch = synthetic_batch_vit(bs, seed=4, device=device)
    state, launches, rate = _fit_card("card", card, state, train_step,
                                      eval_step, batch, per_step, per_eval)
    if any(p.dtype != torch.bfloat16 for n, p in model.named_parameters()
           if not n.startswith("coordination.")):
        fail("card: the compute module is not bf16")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved or "coordination.logit_bias" not in state.params:
        fail(f"card: master weights that did not move: {unmoved}")
    bias = state.params["coordination.logit_bias"].item()
    print(f"card: logit_bias -10.0 -> {bias!r}, logit_scale 1.0 -> "
          f"{state.params['coordination.logit_scale'].item()!r}", flush=True)
    del model, state

    # one micro-step from the same weights, dropout 0: kernel path (attention
    # and SigLIP kernels) vs plain path (plain attention, unfused SigLIP)
    no_drop = {"image_encoder_args": {"dropout": 0.0},
               "profile_encoder_args": {"dropout": 0.0}}
    grads, step_losses = {}, {}
    for path, over in (("kernel", {}), ("plain", PLAIN_CARD)):
        merged = {k: {**no_drop.get(k, {}), **over.get(k, {})}
                  for k in (*no_drop, "coordination_args")}
        _, m, tx, step, _ = _card(**merged)
        m.to(device)
        st = create_train_state(m, init, tx)
        with (_plain_attention() if path == "plain"
              else contextlib.nullcontext()):
            _, loss = step(st, batch, 0)
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in CARD_NAMED_GRADS}
        del m, st
    loss_err = abs(step_losses["kernel"] - step_losses["plain"])
    print(f"card step, dropout 0: loss kernel {step_losses['kernel']!r} "
          f"plain {step_losses['plain']!r} (|diff| {loss_err!r}, tol "
          f"{STEP_LOSS_TOL})", flush=True)
    if not loss_err <= STEP_LOSS_TOL:
        fail(f"card: kernel and plain steps disagree on the loss: "
             f"{loss_err}")
    _grad_diffs("card", grads, CARD_NAMED_GRADS, STEP_GRAD_TOL)

    _, plain, tx, pstep, _ = _card(**PLAIN_CARD)
    plain.to(device)
    pstate = create_train_state(plain, init, tx)
    with _plain_attention():
        _pairs_per_s(pstate, pstep, batch, WARMUP_STEPS)
        plain_rate = _pairs_per_s(pstate, pstep, batch,
                                  CARD_STEPS - WARMUP_STEPS)
    print(f"card: plain path {plain_rate!r} train pairs/s over "
          f"{CARD_STEPS - WARMUP_STEPS} micro-steps", flush=True)
    return launches


def phase_siglip_global(device):
    """``negatives: global`` on the SigLIP card: ``CARD`` with
    ``coordination_args.negatives: global``, whose ``step_buckets`` is 1,
    so each micro-step's 64 pairs are one bucket (kernel 8 on its
    two-kernel path); the card's f32 masters and optimizer (accumulation
    4) through ``make_multi_steps``: ``GLOBAL_STEPS`` micro-steps with 14 +
    14 attention and 1 + 1 SigLIP launches each, finite losses, the least
    of the last below the first, every master moved (one update, after
    micro-step 4; ``coordination.logit_bias`` among them); one dropout-0
    micro-step against the SigLIP kernels' plain versions
    (``_plain_loss``): loss within 1e-2, named gradients within 5e-2.
    Returns the launches of the ``GLOBAL_STEPS`` micro-steps."""
    import torch
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model, step_buckets)
    from multimodal_plankton_recognition_torch.models.flagships import (
        init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.train import (
        create_train_state)

    per_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                         mha_qkv_bwd=ATTENTION_LAYERS, siglip_fwd=1,
                         siglip_bwd=1)
    glob = {"coordination_args": {"negatives": "global"}}
    card, model, tx, train_step, _ = _card(**glob)
    if step_buckets(card) != 1:
        fail(f"siglip_global: step_buckets gives {step_buckets(card)}, "
             f"not one bucket")
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    model.to(device)
    state = create_train_state(model, init, tx)
    batch = synthetic_batch_vit(card.bs, seed=4, device=device)
    _reset_counts()
    losses = []
    for _ in range(GLOBAL_STEPS):
        state, loss = train_step(state, batch, card.seed)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = _counts()
    losses = [float(x) for x in losses]
    print(f"siglip_global: {GLOBAL_STEPS} micro-steps of {card.bs} pairs in "
          f"one bucket, accumulation "
          f"{card.trainer_args.accumulate_grad_batches}: losses {losses}; "
          f"launches {launches}", flush=True)
    want = {n: c * GLOBAL_STEPS for n, c in per_step.items()}
    if launches != want:
        fail(f"siglip_global: expected launches {want}, got {launches}")
    if not all(map(math.isfinite, losses)):
        fail(f"siglip_global: non-finite train loss: {losses}")
    if not min(losses[1:]) < losses[0]:
        fail(f"siglip_global: train loss did not fall: {losses}")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved or "coordination.logit_bias" not in state.params:
        fail(f"siglip_global: master weights that did not move: {unmoved}")
    del model, state

    no_drop = {"image_encoder_args": {"dropout": 0.0},
               "profile_encoder_args": {"dropout": 0.0}, **glob}
    grads, step_losses = {}, {}
    for path in ("kernel", "plain"):
        _, m, tx, step, _ = _card(**no_drop)
        m.to(device)
        st = create_train_state(m, init, tx)
        with (_plain_loss("siglip") if path == "plain"
              else contextlib.nullcontext()):
            _, loss = step(st, batch, card.seed)
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in CARD_NAMED_GRADS}
        del m, st
    loss_err = abs(step_losses["kernel"] - step_losses["plain"])
    print(f"siglip_global micro-step, dropout 0: loss kernel "
          f"{step_losses['kernel']!r} plain SigLIP {step_losses['plain']!r} "
          f"(|diff| {loss_err!r}, tol {STEP_LOSS_TOL})", flush=True)
    if not loss_err <= STEP_LOSS_TOL:
        fail(f"siglip_global: kernel and plain SigLIP micro-steps disagree "
             f"on the loss: {loss_err}")
    _grad_diffs("siglip_global", grads, CARD_NAMED_GRADS, STEP_GRAD_TOL)
    return launches


@contextlib.contextmanager
def _plain_mbconv():
    """``mbconv_core`` on the plain versions of kernels 13-16 (on the card's
    tensors), the comparison route of the B0 card phase; the kernel
    wrappers are back on exit."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    names = ("ka_fwd", "kb_fwd", "kb_bwd", "ka_bwd")
    kernels = {n: getattr(mbconv, n) for n in names}
    for n in names:
        setattr(mbconv, n, getattr(mbconv, f"{n}_reference"))
    try:
        yield
    finally:
        for n, fn in kernels.items():
            setattr(mbconv, n, fn)


def phase_b0_encode(device):
    """The B0 flagship's serving path: eval mode, cuDNN convolutions, no
    kernel of the port."""
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models.batchnorm import (
        MOMENTUM, BatchNorm)
    from multimodal_plankton_recognition_torch.models.dropout import (
        dropout_rng)
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_b0, init_weights_, synthetic_batch_b0)

    model = init_weights_(flagship_b0(), torch.Generator().manual_seed(0))
    model.to(device)
    # running statistics for the random weights: one train-mode forward
    # with momentum 0 sets each BatchNorm's to its batch's (with the init's
    # 0 / 1, the image features shrink to about 1e-7 through B0's blocks
    # and the metadata alone tells the images apart)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    model.train()
    with torch.no_grad(), dropout_rng(torch.Generator().manual_seed(1)):
        model.encode(**synthetic_batch_b0(BATCH, seed=9, device=device))
    for m in norms:
        m.momentum = MOMENTUM
    model.eval()

    gallery = synthetic_batch_b0(GALLERY, seed=5, device=device)
    labels = np.random.RandomState(6).randint(0, 16, GALLERY)
    emb, rate, launches = _encode_timed(model, gallery, labels, device)
    print(f"b0 encode: {GALLERY} pairs in batches of {BATCH}: {rate!r} "
          f"pairs/s; launches {launches}", flush=True)
    if any(launches.values()):
        fail(f"b0 encode: eval mode launched kernels of the port: "
             f"{launches}")
    _check_embeddings("b0 encode", emb, labels, device)
    return launches


B0_CUDNN = {"image_encoder_args": {"fused_mbconv": False}}


def phase_b0_card(device):
    """The B0 CLIP card with ``fused_mbconv``: card dict -> ModelCard ->
    build_multi_model -> train step with accumulation 4 -> Fitter; then one
    dropout-0 micro-step on the kernel route, the plain ``mbconv_core``
    route and the cuDNN route (``fused_mbconv: false``)."""
    import torch
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model)
    from multimodal_plankton_recognition_torch.models.flagships import (
        init_weights_, synthetic_batch_b0)
    from multimodal_plankton_recognition_torch.train import (
        create_train_state)

    mbconv = {f"mbconv_{n}": MBCONV_BLOCKS
              for n in ("ka_fwd", "kb_fwd", "kb_bwd", "ka_bwd")}
    per_step = _per_step(clip_fwd=1, clip_bwd=1, **mbconv)
    per_eval = _per_step(clip_fwd=1)
    card, model, tx, train_step, eval_step = _card(B0_CARD)
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    model.to(device)
    state = create_train_state(model, init, tx)
    batch = synthetic_batch_b0(card.bs, seed=7, device=device)
    state, launches, rate = _fit_card("b0 card", card, state, train_step,
                                      eval_step, batch, per_step, per_eval)
    if any(p.dtype != (torch.float32 if "bn" in n or n.startswith(
            "coordination.") else torch.bfloat16)
           for n, p in model.named_parameters()):
        fail("b0 card: the compute module is not bf16 (norms f32)")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved:
        fail(f"b0 card: master weights that did not move: {unmoved}")
    stats = state.batch_stats
    still = [n for n, b in stats.items() if torch.equal(b, init[n].to(device))]
    if still or any(b.dtype != torch.float32 for b in stats.values()):
        fail(f"b0 card: running statistics not f32 or not moved: {still}")
    print(f"b0 card: {len(stats)} running statistics moved, all f32; "
          f"logit_scale 1.0 -> "
          f"{state.params['coordination.logit_scale'].item()!r}", flush=True)
    del model, state

    # one micro-step from the same weights, dropout 0, on each route, and
    # on the plain route once more with the images nudged by a relative
    # 1e-3: at this init the step's gradients move by 5-20% under such a
    # nudge, so the routes are held statistically (JAX's fused-vs-unfused
    # bounds), the kernels themselves to 1e-3 in the kernel phase
    g = torch.Generator(device=device).manual_seed(8)
    nudged = dict(batch, image=batch["image"] * (1 + 1e-3 * torch.randn(
        batch["image"].shape, generator=g, device=device)))
    grads, step_losses = {}, {}
    for path, cudnn, data in (("kernel", False, batch),
                              ("plain", False, batch),
                              ("cudnn", True, batch),
                              ("nudged plain", False, nudged)):
        over = {"image_encoder_args": {"dropout": 0.0,
                                       "fused_mbconv": not cudnn},
                "profile_encoder_args": {"dropout": 0.0}}
        _, m, tx, step, _ = _card(B0_CARD, **over)
        m.to(device)
        st = create_train_state(m, init, tx)
        _reset_counts()
        with (_plain_mbconv() if path.endswith("plain")
              else contextlib.nullcontext()):
            _, loss = step(st, data, 0)
        got = _counts()
        want = per_step if path == "kernel" else _per_step(clip_fwd=1,
                                                            clip_bwd=1)
        if got != want:
            fail(f"b0 card {path} step: expected launches {want}, got {got}")
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in B0_NAMED_GRADS}
        del m, st
    _held_statistically("b0 card step, dropout 0", step_losses, grads,
                        B0_NAMED_GRADS, (("kernel", "plain"),
                                         ("kernel", "cudnn")),
                        ("plain", "nudged plain"))

    rates = {"kernel": rate}
    for path, over in (("plain", {}), ("cudnn", B0_CUDNN)):
        _, m, tx, step, _ = _card(B0_CARD, **over)
        m.to(device)
        st = create_train_state(m, init, tx)
        with _plain_mbconv() if path == "plain" else contextlib.nullcontext():
            _pairs_per_s(st, step, batch, WARMUP_STEPS)
            rates[path] = _pairs_per_s(st, step, batch,
                                       CARD_STEPS - WARMUP_STEPS)
        del m, st
    print(f"b0 card: train pairs/s over micro-steps {WARMUP_STEPS + 1}-"
          f"{CARD_STEPS}: kernel route {rates['kernel']!r}, plain "
          f"mbconv_core {rates['plain']!r}, cuDNN route (fused_mbconv "
          f"false) {rates['cudnn']!r}", flush=True)
    return launches


def _held_statistically(what, step_losses, grads, names, held, floor):
    """Routes ``held`` (pairs of route names) within the loss tolerance and
    the JAX package's fused-vs-unfused bounds on the named gradients
    (correlation > ``STAT_CORR``, relative L2 each < ``STAT_RMS``); the
    ``floor`` pair (a route against itself on nudged inputs, the step's own
    sensitivity) is printed, not held."""
    import numpy as np
    import torch

    for a, b in (*held, floor):
        loss_err = abs(step_losses[a] - step_losses[b])
        rels = {n: ((grads[a][n] - grads[b][n]).norm()
                    / grads[b][n].norm()).item() for n in names}
        x, y = (torch.cat([grads[p][n].flatten() for n in names])
                .cpu().numpy() for p in (a, b))
        corr = float(np.corrcoef(x, y)[0, 1])
        print(f"{what}, {a} against {b}: loss "
              f"{step_losses[a]!r} / {step_losses[b]!r} (|diff| {loss_err!r}, "
              f"tol {STEP_LOSS_TOL}); named gradients: correlation {corr!r} "
              f"(> {STAT_CORR}), relative L2 each (< {STAT_RMS})", flush=True)
        for n, rel in rels.items():
            print(f"  grad {n}: {rel!r}", flush=True)
        if (a, b) == floor:  # the noise floor: printed, not held
            continue
        if not (loss_err <= STEP_LOSS_TOL and corr > STAT_CORR
                and max(rels.values()) < STAT_RMS):
            fail(f"{what}: {a} and {b} differ beyond the bounds: loss "
                 f"{loss_err}, correlation {corr}, relative L2 {rels}")


@contextlib.contextmanager
def _plain_ffn():
    """``ffn_core`` on the plain versions of kernels 9 and 10 (on the card's
    tensors), a comparison route of the fused-FFN train phase; the kernel
    wrappers are back on exit."""
    from multimodal_plankton_recognition_torch.ops import ffn

    kernels = ffn.ffn_fwd, ffn.ffn_bwd
    ffn.ffn_fwd, ffn.ffn_bwd = ffn.ffn_reference, ffn.ffn_bwd_reference
    try:
        yield
    finally:
        ffn.ffn_fwd, ffn.ffn_bwd = kernels


def _encode_timed(model, gallery, labels, device):
    """(embeddings, pairs/s, launches) of one ``encode_arrays`` pass over
    the gallery after a warm-up batch, the counts set to 0 just before."""
    import torch
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_arrays)

    warm = {k: v[:BATCH] for k, v in gallery.items()}
    encode_arrays(model, warm, labels[:BATCH], BATCH, device)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = encode_arrays(model, gallery, labels, BATCH, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return emb, GALLERY / seconds, _counts()


def _check_embeddings(what, emb, labels, device, ref=None, tol=SLICE_TOL):
    """Finite unit-norm (GALLERY, 512) embeddings whose self-gallery k = 1
    is >= 99% right; with ``ref``, within ``tol`` of it."""
    import numpy as np
    from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier

    for key in ("image", "profile"):
        x = emb[key]
        if x.shape != (GALLERY, 512) or not np.isfinite(x).all():
            fail(f"{what} {key} embeddings: shape {x.shape} or non-finite")
        norm_err = float(np.abs(np.linalg.norm(x, axis=1) - 1.0).max())
        diff = None if ref is None else float(np.abs(x - ref[key]).max())
        acc = float((ANNClassifier(x, labels, device).predict(x, k=1)
                     == labels).mean())
        print(f"{what}: {key} embeddings |norm-1| max {norm_err!r}, max abs "
              f"diff to the reference route {diff!r} (tol {tol}), "
              f"self-gallery k=1 accuracy {acc!r}", flush=True)
        if not norm_err <= 1e-2:
            fail(f"{what} {key} embeddings are not unit-norm ({norm_err})")
        if diff is not None and not diff <= tol:
            fail(f"{what} {key} embeddings disagree with the reference "
                 f"route: {diff}")
        if acc < 0.99:
            fail(f"{what} {key}: self-gallery accuracy {acc} < 0.99")


def phase_ffn_encode(device):
    """``flagship_vit(fused_ffn=True)`` encodes the gallery: 14 FFN-forward
    and 14 attention launches a batch; beside the unfused flagship on the
    same weights."""
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    model = init_weights_(flagship_vit(fused_ffn=True),
                          torch.Generator().manual_seed(0))
    unfused = flagship_vit()
    unfused.load_state_dict(model.state_dict())
    model.to(device).eval()
    unfused.to(device).eval()
    gallery = synthetic_batch_vit(GALLERY, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, GALLERY)
    emb, rate, launches = _encode_timed(model, gallery, labels, device)
    ref, unfused_rate, _ = _encode_timed(unfused, gallery, labels, device)
    print(f"ffn encode: {GALLERY} pairs in batches of {BATCH}: fused FFN "
          f"{rate!r} pairs/s, unfused FFN {unfused_rate!r} pairs/s; "
          f"launches {launches}", flush=True)
    want = {n: c * (GALLERY // BATCH) for n, c in _per_step(
        mha_qkv_fwd=ATTENTION_LAYERS, ffn_fwd=FFN_LAYERS).items()}
    if launches != want:
        fail(f"ffn encode: expected launches {want}, got {launches}")
    _check_embeddings("ffn encode", emb, labels, device, ref)
    return launches


FFN_NAMED_GRADS = NAMED_GRADS + (
    "image_encoder.backbone.blocks.0.mlp1.weight",
    "image_encoder.backbone.blocks.11.mlp2.weight",
    "image_encoder.backbone.blocks.5.mlp1.bias",
    "profile_encoder.layers.1.ff2.bias")


def phase_ffn_train(device):
    """20 full-width train steps of ``flagship_vit(fused_ffn=True)``; then
    dropout-0 steps against ``ffn_core``'s plain versions on the card (the
    same math) and against the unfused route (other bf16 rounding points,
    held statistically beside the nudged-input floor); then train pairs/s
    of the fused and the unfused route in turns."""
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    per_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                         mha_qkv_bwd=ATTENTION_LAYERS, ffn_fwd=FFN_LAYERS,
                         ffn_bwd=FFN_LAYERS, clip_fwd=1, clip_bwd=1)
    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    model = flagship_vit(fused_ffn=True)
    state, train_step = _train_state(model, init, device)
    _reset_counts()
    torch.cuda.synchronize()
    losses = []
    for i in range(TRAIN_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = train_step(state, batch, 0)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    timed = TRAIN_STEPS - WARMUP_STEPS
    losses = [float(x) for x in losses]
    print(f"ffn train: {TRAIN_STEPS} steps of {BATCH} pairs: fused FFN "
          f"{BATCH * timed / seconds!r} pairs/s over steps "
          f"{WARMUP_STEPS + 1}-{TRAIN_STEPS} ({seconds / timed * 1e3!r} ms "
          f"per step); launches {launches}", flush=True)
    print(f"ffn train: losses {losses}", flush=True)
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    if launches != want:
        fail(f"ffn train: expected launches {want}, got {launches}")
    if not all(map(math.isfinite, losses)) or not min(losses[-5:]) \
            < losses[0]:
        fail(f"ffn train: non-finite or not falling losses {losses}")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved or any(m.dtype != torch.float32
                      for m in state.params.values()):
        fail(f"ffn train: masters not f32 or not moved: {unmoved}")
    # kernel 10 keeps bf16 dpre and h of a layer in scratch for its weight
    # gradients (4 rows Fp bytes: 472 MB at the profile encoder's layer)
    state, (peak, rise) = _peak_step(state, train_step, batch)
    print(f"ffn train: peak device memory of one train step "
          f"(max_memory_allocated) {peak!r} MiB, {rise!r} MiB above the "
          f"step's start", flush=True)
    del model, state

    g = torch.Generator(device=device).manual_seed(8)
    nudged = dict(batch, image=batch["image"] * (1 + 1e-3 * torch.randn(
        batch["image"].shape, generator=g, device=device)))
    plain_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                           mha_qkv_bwd=ATTENTION_LAYERS, clip_fwd=1,
                           clip_bwd=1)
    grads, step_losses = {}, {}
    for path, fused, plain, data in (
            ("kernel", True, False, batch), ("plain", True, True, batch),
            ("unfused", False, False, batch),
            ("nudged unfused", False, False, nudged)):
        m = flagship_vit(fused_ffn=fused, dropout=0.0)
        st, step = _train_state(m, init, device)
        _reset_counts()
        with _plain_ffn() if plain else contextlib.nullcontext():
            _, loss = step(st, data, 0)
        got = _counts()
        if got != (per_step if path == "kernel" else plain_step):
            fail(f"ffn train {path} step: launches {got}")
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in FFN_NAMED_GRADS}
        del m, st
    loss_err = abs(step_losses["kernel"] - step_losses["plain"])
    print(f"ffn train step, dropout 0: loss kernel {step_losses['kernel']!r} "
          f"plain ffn_core {step_losses['plain']!r} (|diff| {loss_err!r}, "
          f"tol {STEP_LOSS_TOL})", flush=True)
    if not loss_err <= STEP_LOSS_TOL:
        fail(f"ffn train: kernel and plain steps disagree on the loss: "
             f"{loss_err}")
    _grad_diffs("ffn train", grads, FFN_NAMED_GRADS, STEP_GRAD_TOL)
    _held_statistically("ffn train step, dropout 0", step_losses, grads,
                        FFN_NAMED_GRADS, (("kernel", "unfused"),),
                        ("unfused", "nudged unfused"))

    # the fused and the unfused route in turns (fused, unfused, unfused,
    # fused), each after its own warm-up, so that a wall that drifts within
    # the call moves both alike
    routes = {}
    for name, fused in (("fused FFN", True), ("unfused FFN", False)):
        st, step = _train_state(flagship_vit(fused_ffn=fused), init, device)
        _pairs_per_s(st, step, batch, WARMUP_STEPS)
        routes[name] = [st, step]
    rates = {name: [] for name in routes}
    for name in ("fused FFN", "unfused FFN", "unfused FFN", "fused FFN"):
        st, step = routes[name]
        rates[name].append(_pairs_per_s(st, step, batch, PLAIN_STEPS))
    del routes
    mean = statistics.fmean
    print(f"summary: ffn train, fused against unfused FFN in turns (fused, "
          f"unfused, unfused, fused): {mean(rates['fused FFN'])!r} against "
          f"{mean(rates['unfused FFN'])!r} pairs/s over {PLAIN_STEPS} steps "
          f"({rates['fused FFN']} / {rates['unfused FFN']})", flush=True)
    return launches


FFN_CARD = {"image_encoder_args": {"fused_ffn": True},
            "profile_encoder_args": {"fused_ffn": True}}


def phase_ffn_card(device):
    """The ViT-S SigLIP card with ``fused_ffn: true`` on both encoders:
    card dict -> ModelCard -> build_multi_model -> Fitter."""
    import torch
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model)
    from multimodal_plankton_recognition_torch.models.flagships import (
        init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.train import (
        create_train_state)

    per_step = _per_step(mha_qkv_fwd=ATTENTION_LAYERS,
                         mha_qkv_bwd=ATTENTION_LAYERS, ffn_fwd=FFN_LAYERS,
                         ffn_bwd=FFN_LAYERS, siglip_fwd=1, siglip_bwd=1)
    per_eval = _per_step(mha_qkv_fwd=ATTENTION_LAYERS, ffn_fwd=FFN_LAYERS,
                         siglip_fwd=1)
    card, model, tx, train_step, eval_step = _card(**FFN_CARD)
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    model.to(device)
    state = create_train_state(model, init, tx)
    batch = synthetic_batch_vit(card.bs, seed=4, device=device)
    state, launches, _ = _fit_card("ffn card", card, state, train_step,
                                   eval_step, batch, per_step, per_eval)
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved or "coordination.logit_bias" not in state.params:
        fail(f"ffn card: master weights that did not move: {unmoved}")
    return launches


def phase_unpacked(device):
    """The attention module's unpacked route (``PLANKTON_ATTN_QKV_PACKED=0``,
    set here and restored): the flagship encodes through kernel 3 and
    trains through kernels 3 and 4, never kernels 1 and 2."""
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    model = init_weights_(flagship_vit(), torch.Generator().manual_seed(0))
    model.to(device).eval()
    gallery = synthetic_batch_vit(GALLERY, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, GALLERY)
    packed, packed_rate, _ = _encode_timed(model, gallery, labels, device)
    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    with _env("PLANKTON_ATTN_QKV_PACKED", "0"):
        emb, rate, launches = _encode_timed(model, gallery, labels, device)
        state, train_step = _train_state(flagship_vit(), init, device)
        _reset_counts()
        losses = []
        for _ in range(UNPACKED_STEPS):
            state, loss = train_step(state, batch, 0)
            losses.append(float(loss))
        torch.cuda.synchronize()
        train_launches = _counts()
    print(f"unpacked: encode {rate!r} pairs/s (packed route {packed_rate!r}); "
          f"launches {launches}; {UNPACKED_STEPS} train steps, losses "
          f"{losses}, launches {train_launches}", flush=True)
    want = {n: c * (GALLERY // BATCH) for n, c in _per_step(
        mha_fwd=ATTENTION_LAYERS).items()}
    if launches != want:
        fail(f"unpacked encode: expected launches {want}, got {launches}")
    want = {n: c * UNPACKED_STEPS for n, c in _per_step(
        mha_fwd=ATTENTION_LAYERS, mha_bwd=ATTENTION_LAYERS, clip_fwd=1,
        clip_bwd=1).items()}
    if train_launches != want:
        fail(f"unpacked train: expected launches {want}, got "
             f"{train_launches}")
    if not all(map(math.isfinite, losses)):
        fail(f"unpacked train: non-finite losses {losses}")
    # the same math as the packed route; the q, k, v GEMMs may sum in
    # another order than the packed one, as any two routes of bf16 math
    _check_embeddings("unpacked encode", emb, labels, device, packed)
    return {n: launches[n] + train_launches[n] for n in launches}


@contextlib.contextmanager
def _env(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside the block,
    restored after."""
    import os

    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def phase_fuse_proj(device):
    """The attention module's fused-block route
    (``PLANKTON_ATTN_FUSE_PROJ=1``, set here and restored): the flagship
    encodes through kernel 11 and trains through kernels 11 and 12, never
    kernels 1-4; pairs/s beside the packed route in ``FUSE_PROJ_ROUNDS``
    rounds of turns (packed, block, block, packed), and the peak memory of
    a train step on each, and on the block route with kernel 12
    rebuilding q|k|v and o (the forward keeps nothing)."""
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models import (
        attention as attention_module)
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.ops import attention_block

    fuse = functools.partial(_env, "PLANKTON_ATTN_FUSE_PROJ", "1")
    model = init_weights_(flagship_vit(), torch.Generator().manual_seed(0))
    model.to(device).eval()
    gallery = synthetic_batch_vit(GALLERY, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, GALLERY)
    packed, _, _ = _encode_timed(model, gallery, labels, device)
    with fuse():
        emb, _, launches = _encode_timed(model, gallery, labels, device)
    packed_rates, rates = [], []
    for _ in range(FUSE_PROJ_ROUNDS):
        packed_rates.append(_encode_timed(model, gallery, labels, device)[1])
        with fuse():
            rates += [_encode_timed(model, gallery, labels, device)[1]
                      for _ in range(2)]
        packed_rates.append(_encode_timed(model, gallery, labels, device)[1])
    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    with fuse():
        state, train_step = _train_state(flagship_vit(), init, device)
        _reset_counts()
        losses = []
        for _ in range(FUSE_PROJ_STEPS):
            state, loss = train_step(state, batch, 0)
            losses.append(float(loss))
        torch.cuda.synchronize()
        train_launches = _counts()
    pstate, pstep = _train_state(flagship_vit(), init, device)
    _pairs_per_s(pstate, pstep, batch, WARMUP_STEPS)
    packed_train, train_rates = [], []
    for _ in range(FUSE_PROJ_ROUNDS):
        packed_train.append(_pairs_per_s(pstate, pstep, batch, PLAIN_STEPS))
        with fuse():
            train_rates += [_pairs_per_s(state, train_step, batch,
                                         PLAIN_STEPS) for _ in range(2)]
        packed_train.append(_pairs_per_s(pstate, pstep, batch, PLAIN_STEPS))
    pstate, packed_peak = _peak_step(pstate, pstep, batch)
    with fuse():
        state, peak = _peak_step(state, train_step, batch)
        # the same step with kernel 12 rebuilding q|k|v and o
        kept = attention_module.attn_block
        attention_module.attn_block = (
            lambda *a: attention_block._AttnBlock.apply(*a, False))
        try:
            state, rebuilt_peak = _peak_step(state, train_step, batch)
        finally:
            attention_module.attn_block = kept
    del pstate, pstep
    mean = statistics.fmean
    rate, train_rate = mean(rates), mean(train_rates)
    print(f"fuse_proj: in {FUSE_PROJ_ROUNDS} rounds of turns (packed, "
          f"block, block, packed): encode "
          f"{rate!r} pairs/s against the packed route's "
          f"{mean(packed_rates)!r} ({packed_rates} / {rates}), ratio "
          f"{rate / mean(packed_rates)!r}; launches {launches}; "
          f"{FUSE_PROJ_STEPS} train steps, losses {losses}, launches "
          f"{train_launches}; train {train_rate!r} pairs/s over "
          f"{PLAIN_STEPS} steps against {mean(packed_train)!r} "
          f"({packed_train} / {train_rates}), ratio "
          f"{train_rate / mean(packed_train)!r}", flush=True)
    print(f"fuse_proj: peak memory of one train step, and its rise above "
          f"the step's start, MiB: block route {peak!r}, packed route "
          f"{packed_peak!r}, block route rebuilding q|k|v and o "
          f"{rebuilt_peak!r}", flush=True)
    want = {n: c * (GALLERY // BATCH) for n, c in _per_step(
        attn_block_fwd=ATTENTION_LAYERS).items()}
    if launches != want:
        fail(f"fuse_proj encode: expected launches {want}, got {launches}")
    want = {n: c * FUSE_PROJ_STEPS for n, c in _per_step(
        attn_block_fwd=ATTENTION_LAYERS, attn_block_bwd=ATTENTION_LAYERS,
        clip_fwd=1, clip_bwd=1).items()}
    if train_launches != want:
        fail(f"fuse_proj train: expected launches {want}, got "
             f"{train_launches}")
    if not all(map(math.isfinite, losses)) or not min(losses[1:]) \
            < losses[0]:
        fail(f"fuse_proj train: non-finite or not falling losses {losses}")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved or any(m.dtype != torch.float32
                      for m in state.params.values()):
        fail(f"fuse_proj train: masters not f32 or not moved: {unmoved}")
    # other rounding points than the packed route (one rounding of the
    # projections, not two), so held to the encode tolerance
    _check_embeddings("fuse_proj encode", emb, labels, device, packed)
    return {n: launches[n] + train_launches[n] for n in launches}


def _peak_step(state, train_step, batch):
    """One train step; returns (state, (the peak of
    ``torch.cuda.max_memory_allocated`` over it, its rise above what was
    allocated before the step) in MiB): the rise is the step's own
    (activations kept for the backward, gradients), whatever else the
    process holds."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state, _ = train_step(state, batch, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return state, (peak / 2 ** 20, (peak - before) / 2 ** 20)


def phase_flax_attention(device):
    """``fused_attention=False`` (flax ``MultiHeadDotProductAttention``'s
    math, no kernel) at full width: the flagship's encode against the
    kernels' plain versions (``_plain_attention``), 3 train steps at
    dropout 0.1, a dropout-0 step against the plain versions, and pairs/s
    of both routes."""
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    model = init_weights_(flagship_vit(), torch.Generator().manual_seed(0))
    flax = flagship_vit(fused_attention=False)
    flax.load_state_dict(model.state_dict())
    model.to(device).eval()
    flax.to(device).eval()
    gallery = synthetic_batch_vit(GALLERY, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, GALLERY)
    with _plain_attention():
        ref, plain_rate, _ = _encode_timed(model, gallery, labels, device)
    # the packed kernel route and flax's in turns: packed, flax, flax, packed
    packed_rates = [_encode_timed(model, gallery, labels, device)[1]]
    emb, rate, launches = _encode_timed(flax, gallery, labels, device)
    if launches != _per_step():
        fail(f"flax attention encode: expected no launches, got {launches}")
    rates = [rate, _encode_timed(flax, gallery, labels, device)[1]]
    packed_rates.append(_encode_timed(model, gallery, labels, device)[1])

    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    state, train_step = _train_state(flagship_vit(fused_attention=False),
                                     init, device)
    _reset_counts()
    losses = []
    for _ in range(FLAX_STEPS):
        state, loss = train_step(state, batch, 0)
        losses.append(float(loss))
    torch.cuda.synchronize()
    train_launches = _counts()
    pstate, pstep = _train_state(flagship_vit(), init, device)
    _pairs_per_s(pstate, pstep, batch, WARMUP_STEPS)
    packed_train = [_pairs_per_s(pstate, pstep, batch, PLAIN_STEPS)]
    train_rates = [_pairs_per_s(state, train_step, batch, PLAIN_STEPS)
                   for _ in range(2)]
    packed_train.append(_pairs_per_s(pstate, pstep, batch, PLAIN_STEPS))
    del pstate, pstep
    train_rate = train_rates[0]
    print(f"flax attention: encode {rate!r} pairs/s (the kernels' plain "
          f"versions {plain_rate!r}); {FLAX_STEPS} train steps, losses "
          f"{losses}, launches {train_launches}; train {train_rate!r} "
          f"pairs/s over {PLAIN_STEPS} steps", flush=True)
    mean = statistics.fmean
    print(f"summary: ViT flagship, packed kernel route against "
          f"fused_attention=false, in turns (packed, flax, flax, packed): "
          f"encode {mean(packed_rates)!r} against {mean(rates)!r} pairs/s "
          f"({packed_rates} / {rates}); train {mean(packed_train)!r} "
          f"against {mean(train_rates)!r} pairs/s over {PLAIN_STEPS} steps "
          f"({packed_train} / {train_rates})", flush=True)
    want = {n: c * FLAX_STEPS for n, c in _per_step(clip_fwd=1,
                                                     clip_bwd=1).items()}
    if train_launches != want:
        fail(f"flax attention train: expected launches {want}, got "
             f"{train_launches}")
    if not all(map(math.isfinite, losses)) or not min(losses[1:]) \
            < losses[0]:
        fail(f"flax attention train: non-finite or not falling losses "
             f"{losses}")
    unmoved = [n for n, m in state.params.items()
               if torch.equal(m, init[n].to(device))]
    if unmoved or any(m.dtype != torch.float32
                      for m in state.params.values()):
        fail(f"flax attention train: masters not f32 or not moved: "
             f"{unmoved}")

    # dropout 0, one step: flax's rounding points (bf16 softmax) against
    # the kernels' plain versions, held to the JAX package's statistical
    # bounds beside the plain route's nudged-input floor; the train phase's
    # 5e-2 on each gradient, which this route met before it had flax's
    # semantics, is read and printed
    g = torch.Generator(device=device).manual_seed(8)
    nudged = dict(batch, image=batch["image"] * (1 + 1e-3 * torch.randn(
        batch["image"].shape, generator=g, device=device)))
    grads, step_losses = {}, {}
    for path, fused, data in (("flax", False, batch), ("plain", True, batch),
                              ("nudged plain", True, nudged)):
        m = flagship_vit(fused_attention=fused, dropout=0.0)
        st, step = _train_state(m, init, device)
        with (_plain_attention() if fused else contextlib.nullcontext()):
            _, loss = step(st, data, 0)
        step_losses[path] = float(loss)
        grads[path] = {n: m.get_parameter(n).grad.float()
                       for n in NAMED_GRADS}
        del m, st
    _held_statistically("flax attention step, dropout 0", step_losses, grads,
                        NAMED_GRADS, (("flax", "plain"),),
                        ("plain", "nudged plain"))
    worst = max(((grads["flax"][n] - grads["plain"][n]).norm()
                 / grads["plain"][n].norm()).item() for n in NAMED_GRADS)
    print(f"flax attention step: largest relative L2 gradient difference "
          f"{worst!r} against the kernels' plain versions (the train "
          f"phase's {STEP_GRAD_TOL} met: {worst <= STEP_GRAD_TOL})",
          flush=True)
    _check_embeddings("flax attention encode (reference: the kernels' "
                      "plain versions)", emb, labels, device, ref)
    return {n: launches[n] + train_launches[n] for n in launches}


def _device_ms(prof, steps):
    """{kernel: [ms per step, launches per step]} of the device-side events
    only (the aten ops carry device time too and would count it twice)."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:  # older torch
            t = e.self_cuda_time_total
        row = rows.setdefault(e.key, [0.0, 0.0])
        row[0] += t / steps / 1e3
        row[1] += e.count / steps
    return rows


def phase_profile(device):
    """The ViT flagship's encode batch and train step (the train step also
    with ``fused_ffn``), and the micro-step of each card (SigLIP ViT-S; B0 CLIP; SigLIP ViT-S with and without
    ``fused_ffn``) by kernel."""
    from multimodal_plankton_recognition_torch.models.flagships import (
        synthetic_batch_b0, synthetic_batch_vit)

    _profile_encode(device)
    _profile_train(device)
    with _env("PLANKTON_ATTN_FUSE_PROJ", "1"):
        _profile_encode(device, "fuse_proj ")
        _profile_train(device, "fuse_proj ")
    _profile_train(device, "fused_ffn ", fused_ffn=True)
    _profile_card(device, "card", CARD, (("kernel", {}),
                                         ("plain", PLAIN_CARD)),
                  synthetic_batch_vit)
    _profile_card(device, "b0 card", B0_CARD, (("kernel", {}),
                                               ("cudnn", B0_CUDNN)),
                  synthetic_batch_b0)
    _profile_card(device, "ffn card", CARD, (("fused FFN", FFN_CARD),
                                             ("unfused FFN", {})),
                  synthetic_batch_vit)


def _print_profile(what, unit, prof, steps, wall):
    """Device ms per ``unit`` by kernel, the busy total and the idle share
    1 - busy / wall (``wall``: unprofiled ms per ``unit``)."""
    rows = _device_ms(prof, steps)
    busy = sum(ms for ms, _ in rows.values())
    if not busy > 0:
        fail(f"profile {what}: the profiler saw no device time")
    print(f"profile {what}: {steps} of {unit}: wall {wall!r} ms "
          f"(unprofiled), device busy {busy!r} ms, idle "
          f"{1 - busy / wall!r} per {unit}", flush=True)
    for key, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]
                               )[:PROFILE_ROWS]:
        print(f"  {ms:9.4f} ms {100 * ms / busy:5.1f}% {n:7.1f}x "
              f"{key[:120]}", flush=True)
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "kernels": rows}


def _profile_encode(device, route=""):
    """The ViT flagship's ``encode_arrays`` by kernel: ``PROFILE_STEPS``
    batches of 256 after a warm-up pass, the wall per batch of an
    unprofiled pass over the same pairs; ``route`` prefixes the label."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_arrays)

    model = init_weights_(flagship_vit(), torch.Generator().manual_seed(0))
    model.to(device).eval()
    n = PROFILE_STEPS * BATCH
    pairs = synthetic_batch_vit(n, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, n)
    encode_arrays(model, pairs, labels, BATCH, device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode_arrays(model, pairs, labels, BATCH, device)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode_arrays(model, pairs, labels, BATCH, device)
        torch.cuda.synchronize()
    out = _print_profile(f"{route}vit encode", "batch", prof, PROFILE_STEPS,
                         wall)
    print(f"profile {route}vit encode: {json.dumps(out)}", flush=True)


def _profile_train(device, route="", **model_args):
    """The ViT flagship's ``train_step`` (batch 256, buckets 16, dropout
    0.1) by kernel: ``PROFILE_STEPS`` steps after a warm-up, the wall per
    step of as many unprofiled steps of the same process and weights;
    ``route`` prefixes the label, ``model_args`` go to ``flagship_vit``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    state, step = _train_state(flagship_vit(**model_args), init, device)
    _pairs_per_s(state, step, batch, WARMUP_STEPS)
    wall = BATCH / _pairs_per_s(state, step, batch, PROFILE_STEPS) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            state, _ = step(state, batch, 0)
        torch.cuda.synchronize()
    out = _print_profile(f"{route}vit train (bs {BATCH})", "step", prof,
                         PROFILE_STEPS, wall)
    print(f"profile {route}vit train: {json.dumps(out)}", flush=True)


def _profile_card(device, what, base, paths, make_batch):
    """A card micro-step's device time by kernel (torch.profiler) on each
    of ``paths``, and the device's idle share: 1 − (device busy ms,
    profiled) / (wall ms, unprofiled), both per micro-step of the same
    process and weights. The profiler's host cost per launch inflates a
    profiled wall time, so it is not used."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model)
    from multimodal_plankton_recognition_torch.models.flagships import (
        init_weights_)
    from multimodal_plankton_recognition_torch.train import (
        create_train_state)

    card = _card(base)[0]
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = make_batch(card.bs, seed=4, device=device)
    out = {}
    for path, over in paths:
        _, model, tx, step, _ = _card(base, **over)
        model.to(device)
        state = create_train_state(model, init, tx)
        plain = _plain_attention() if over is PLAIN_CARD \
            else contextlib.nullcontext()
        with plain:
            # warm-up to an update boundary, then whole accumulation cycles
            _pairs_per_s(state, step, batch, WARMUP_STEPS + 1)
            wall = card.bs / _pairs_per_s(state, step, batch,
                                          PROFILE_STEPS) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_STEPS):
                    state, _ = step(state, batch, 0)
                torch.cuda.synchronize()
        out[path] = _print_profile(f"{what} {path} (bs {card.bs})",
                                   "micro-step", prof, PROFILE_STEPS, wall)
        del model, state
    print(f"profile {what}: {json.dumps(out)}", flush=True)


def _clip_profile(gen, device):
    """Kernels 5 and 6 at ``CLIP_SHAPES`` for ``--kernel-profile``, through
    the call every commit of the port takes (``clip_fwd(img, prof, scale,
    buckets)``, ``clip_bwd(img, prof, scale, g, buckets)``: the backward
    recomputing the forward's statistics), beside the plain versions and
    the bounds; where ``clip_bwd`` takes the forward's statistics, that
    form too (the autograd path's); where the commit chooses its tiles
    (``clip_fwd_tile``, ``clip_bwd_tile``), both sides of each choice at
    ``CLIP_REGIME_SHAPES`` (``_clip_regimes``)."""
    import inspect
    from multimodal_plankton_recognition_torch.ops import contrastive as ct

    for buckets, n in CLIP_SHAPES:
        img, prof, scale, g = _clip_inputs(gen, device, buckets, n)
        label = f"buckets={buckets} N={n} D=512"
        flops = 2 * buckets * n * n * 512
        rate = _clip_rate(img)
        fwd = functools.partial(ct.clip_fwd, img, prof, scale, buckets)
        bound = _bound((img, prof, scale), fwd(), flops, rate)
        plain = cuda_ms(functools.partial(ct.clip_loss_fused_reference, img,
                                          prof, scale, buckets))
        print(f"kernel-profile clip_fwd [{label}]: {cuda_ms(fwd)!r} ms, "
              f"plain {plain!r} ms, bound {bound[0]!r} ms ({bound[1]})",
              flush=True)
        bwd = functools.partial(ct.clip_bwd, img, prof, scale, g, buckets)
        bound = _bound((img, prof, scale, g), bwd(), flops, rate, 2 * flops)
        more = ""
        if "stats" in inspect.signature(ct.clip_bwd).parameters:
            stats = ct.clip_fwd(img, prof, scale, buckets, keep=True)[1]
            more = (f", given the forward's statistics "
                    f"{cuda_ms(functools.partial(bwd, stats=stats))!r} ms")
        plain = cuda_ms(functools.partial(ct.clip_loss_bwd_reference, img,
                                          prof, scale, g, buckets))
        print(f"kernel-profile clip_bwd [{label}]: {cuda_ms(bwd)!r} ms"
              f"{more}, plain {plain!r} ms, bound {bound[0]!r} ms "
              f"({bound[1]})", flush=True)
    if hasattr(ct, "clip_fwd_tile"):
        for buckets, n in CLIP_REGIME_SHAPES:
            _clip_regimes(ct, gen, device, buckets, n)


@contextlib.contextmanager
def _tile_as(ct, choice, tile):
    """The loss wrappers and their scratch sizes on ``tile``-row tiles at
    every N where ``choice`` (``"clip_fwd_tile"``, ``"siglip_bwd_tile"``,
    ...) is asked."""
    chosen = getattr(ct, choice)
    setattr(ct, choice, lambda n: tile)
    try:
        yield
    finally:
        setattr(ct, choice, chosen)


def _clip_regimes(ct, gen, device, buckets, n):
    """``_loss_regimes`` of the CLIP kernels at one shape, the backward
    given the forward's statistics."""
    img, prof, scale, g = _clip_inputs(gen, device, buckets, n)
    stats = ct.clip_fwd(img, prof, scale, buckets, keep=True)[1]
    _loss_regimes(ct, "clip", n, f"buckets={buckets} N={n} D=512",
                  functools.partial(ct.clip_fwd, img, prof, scale, buckets),
                  functools.partial(ct.clip_bwd, img, prof, scale, g,
                                    buckets, stats))


def _loss_regimes(ct, loss, n, label, fwd, bwd):
    """Both sides of a loss's two kernel choices at one shape, in turns
    (chosen, other, other, chosen): the forward ``fwd`` on 16- and on
    32-row tiles and, where a bucket is one 16-row tile (the one-block
    backward's only shapes), the backward ``bwd`` on one block a bucket
    and on the two kernels of 32-row tiles. The other choice agrees with
    the chosen one within the kernels' tolerances."""
    calls = {"fwd": fwd, "bwd": bwd} if n <= 16 else {"fwd": fwd}
    out, times = {}, {}
    for what, call in calls.items():
        choice = f"{loss}_{what}_tile"
        chosen = getattr(ct, choice)(n)
        other = 48 - chosen  # 16 <-> 32
        for tile in (chosen, other, other, chosen):
            with _tile_as(ct, choice, tile):
                out.setdefault((what, tile), call())
                times.setdefault((what, tile), []).append(cuda_ms(call))
        names = ({16: "16-row tiles", 32: "32-row tiles"} if what == "fwd"
                 else {16: "one block a bucket", 32: "two kernels"})
        ms = {t: sum(times[what, t]) / 2 for t in (chosen, other)}
        print(f"kernel-profile {loss} regimes {what} [{label}]: "
              f"{names[chosen]} (chosen) {ms[chosen]!r} ms, "
              f"{names[other]} {ms[other]!r} ms, in turns", flush=True)
    want, got = out["fwd", 16].item(), out["fwd", 32].item()
    if abs(got - want) > CLIP_LOSS_TOL * abs(want):
        fail(f"{loss} regimes {label}: the forward gives {want!r} on 16-row "
             f"tiles, {got!r} on 32-row tiles")
    if "bwd" in calls:
        one, two = out["bwd", 16], out["bwd", 32]
        top = max(t.float().abs().max().item() for t in one[:2])
        for a, b in zip(one[:2], two[:2]):
            if (a.float() - b.float()).abs().max().item() > \
                    CLIP_GRAD_TOL * top:
                fail(f"{loss} regimes {label}: the two-kernel backward "
                     f"differs from the one-block backward beyond "
                     f"{CLIP_GRAD_TOL}")
        for a, b in zip(one[2:], two[2:]):  # d logit_scale (, d logit_bias)
            if abs(a.item() - b.item()) > CLIP_SCALE_TOL * abs(a.item()):
                fail(f"{loss} regimes {label}: the two backwards' scalar "
                     f"gradients differ beyond {CLIP_SCALE_TOL}")


def _siglip_profile(device):
    """Kernels 7 and 8 for ``--kernel-profile`` at every ``SIGLIP_SHAPES``
    row and at ``SIGLIP_UNCAPPED``, at the head's init scalars, beside
    their plain versions and bounds (inputs from a generator of their own,
    so the other kernels' inputs do not depend on which rows ran); a
    commit whose SigLIP kernels have a bucket cap (``SIGLIP_MAX_BUCKET``)
    skips the rows above it. Where the commit chooses SigLIP's tiles
    (``siglip_fwd_tile``, ``siglip_bwd_tile``), both sides of each choice
    at ``CLIP_REGIME_SHAPES`` (``_siglip_regimes``)."""
    import torch
    from multimodal_plankton_recognition_torch.ops import contrastive as ct

    gen = torch.Generator(device=device).manual_seed(7)
    cap = getattr(ct, "SIGLIP_MAX_BUCKET", None)
    scale, bias = (torch.full((), v, device=device)
                   for v in SIGLIP_SCALARS[0])
    g = torch.full((), 1.3, device=device)
    for buckets, n in SIGLIP_SHAPES + (SIGLIP_UNCAPPED,):
        label = f"buckets={buckets} N={n} D=512"
        if cap is not None and n > cap:
            print(f"kernel-profile siglip [{label}]: skipped, above this "
                  f"commit's cap of {cap} rows", flush=True)
            continue
        img, prof = _siglip_inputs(gen, device, buckets, n)
        args = (img, prof, scale, bias)
        flops = 2 * buckets * n * n * 512
        rate = _clip_rate(img)
        fwd = functools.partial(ct.siglip_fwd, *args, buckets)
        bwd = functools.partial(ct.siglip_bwd, *args, g, buckets)
        for name, call, plain, bound in (
                ("siglip_fwd", fwd, functools.partial(
                    ct.siglip_loss_fused_reference, *args, buckets),
                 _bound(args, fwd(), flops, rate)),
                ("siglip_bwd", bwd, functools.partial(
                    ct.siglip_loss_bwd_reference, *args, g, buckets),
                 _bound((args, g), bwd(), flops, rate, 2 * flops))):
            print(f"kernel-profile {name} [{label}]: {cuda_ms(call)!r} ms, "
                  f"plain {cuda_ms(plain)!r} ms, bound {bound[0]!r} ms "
                  f"({bound[1]})", flush=True)
    if hasattr(ct, "siglip_fwd_tile"):
        for buckets, n in CLIP_REGIME_SHAPES:
            _siglip_regimes(ct, gen, device, buckets, n)


def _siglip_regimes(ct, gen, device, buckets, n):
    """``_loss_regimes`` of the SigLIP kernels at one shape, at the head's
    init scalars."""
    import torch

    img, prof = _siglip_inputs(gen, device, buckets, n)
    args = (img, prof) + tuple(torch.full((), v, device=device)
                               for v in SIGLIP_SCALARS[0])
    g = torch.full((), 1.3, device=device)
    _loss_regimes(ct, "siglip", n, f"buckets={buckets} N={n} D=512",
                  functools.partial(ct.siglip_fwd, *args, buckets),
                  functools.partial(ct.siglip_bwd, *args, g, buckets))


def phase_kernel_profile(device):
    """Kernels 5-10 and 13-16 alone (``--kernel-profile``): device ms by
    ``cuda_ms``. Kernels 5 and 6 at every ``CLIP_SHAPES`` row
    (``_clip_profile``, with both sides of their tile choices), kernels 7
    and 8 at every ``SIGLIP_SHAPES`` row (``_siglip_profile``, the same);
    kernels 9
    and 10 at every ``FFN_SHAPES`` row (GELU, bf16, p 0; ViT-T also p
    0.1; kernel 9 also f32 x at the card's profile row)
    beside the unfused cuBLAS forward or backward and the bound; kernels
    13-16 at every ``MBCONV_SHAPES`` row (B 64), each beside its bound and
    13-15 beside their plain versions, each with the sum over B0's 12
    stride-1 blocks; one profiled call by CUDA kernel of kernels 9 and 10
    at ViT-T and of kernels 13-16 at ``KA_BWD_PROFILED``; the peak device
    memory of one fused-FFN flagship train step. It drives whatever
    package lies beside this script, so a copy of the script in a checkout
    of another commit times that commit's kernels (before and after, in
    one call)."""
    import torch
    from multimodal_plankton_recognition_torch.ops import build, ffn
    from multimodal_plankton_recognition_torch.ops import mbconv as mb

    build.build_all(("ffn", "mbconv_fwd", "mbconv_bwd", "clip_loss",
                     "siglip_loss"))
    gen = torch.Generator(device=device).manual_seed(0)
    _clip_profile(gen, device)
    _siglip_profile(device)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale \
            + shift

    for name, (b, l, e, f, act) in FFN_SHAPES.items():
        w = (rnd(e, f, scale=e ** -0.5), rnd(f, scale=0.1),
             rnd(f, e, scale=f ** -0.5), rnd(e, scale=0.1))
        x = rnd(b, l, e)
        dy = rnd(b, l, e).to(torch.bfloat16)
        cases = [(torch.bfloat16, 0.0)]
        if name == "vit":
            cases.append((torch.bfloat16, 0.1))
        if name == "card profile":
            cases.append((torch.float32, 0.0))
        for dtype, p in cases:
            args = (x.to(dtype), *w)
            label = (f"{name} B={b} L={l} E={e} F={f} {act} "
                     f"{str(dtype)[6:]} p={p}")
            call = functools.partial(ffn.ffn_fwd, *args, act, p, 4321)
            bound = _bound(args, call(), 4 * b * l * e * f)
            print(f"kernel-profile ffn_fwd [{label}]: {cuda_ms(call)!r} ms, "
                  f"unfused {_unfused_ms(*args, act, p)!r} ms, bound "
                  f"{bound[0]!r} ms ({bound[1]})", flush=True)
            if name == "vit" and p == 0.0:
                _call_profile("ffn_fwd", label, call)
            if dtype != torch.bfloat16:
                continue
            call = functools.partial(ffn.ffn_bwd, *args, dy, act, p, 4321)
            bound = _bound((args, dy), call(), 10 * b * l * e * f)
            print(f"kernel-profile ffn_bwd [{label}]: {cuda_ms(call)!r} ms, "
                  f"unfused {_unfused_ms(*args, act, p, dy)!r} ms, bound "
                  f"{bound[0]!r} ms ({bound[1]})", flush=True)
            if name == "vit" and p == 0.0:
                _call_profile("ffn_bwd", label, call)
    totals = {f"mbconv_{k}": 0.0
              for k in ("ka_fwd", "kb_fwd", "kb_bwd", "ka_bwd")}
    b = B0_CARD["bs"]
    for block, (hw, cin, mid, cout, k, r) in MBCONV_SHAPES.items():
        expand = mid != cin
        x = rnd(b, hw, hw, cin).to(torch.bfloat16)
        wexp = rnd(cin, mid, scale=cin ** -0.5) if expand else None
        g1 = rnd(mid, scale=0.1, shift=1.0) if expand else None
        b1 = rnd(mid, scale=0.1) if expand else None
        wdw = rnd(k, k, mid, scale=1.0 / k)
        g2, b2 = rnd(mid, scale=0.1, shift=1.0), rnd(mid, scale=0.1)
        wr, br = rnd(mid, r, scale=mid ** -0.5), rnd(r, scale=0.1)
        we, be = rnd(r, mid, scale=r ** -0.5), rnd(mid, scale=0.1)
        wproj = rnd(mid, cout, scale=mid ** -0.5)
        dy3 = rnd(b, hw, hw, cout).to(torch.bfloat16)
        dy2 = rnd(b, hw, hw, mid).to(torch.bfloat16)
        y2, m1, v1, m2, v2 = mb.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
        n = b * hw * hw
        se = 4 * b * mid * r  # the SE products, per pass
        label = (f"{block} B={b} H=W={hw} cin={cin} mid={mid} cout={cout} "
                 f"k={k} r={r}")
        # (name, wrapper, plain version or None, arguments, bf16 products),
        # the products as _mbconv_kernels counts them
        for name, fn, plain, args, flops in (
                ("mbconv_ka_fwd", mb.ka_fwd, mb.ka_fwd_reference,
                 (x, wexp, g1, b1, wdw, k),
                 2 * n * cin * mid * expand + 2 * n * mid * k * k),
                ("mbconv_kb_fwd", mb.kb_fwd, mb.kb_fwd_reference,
                 (y2, g2, b2, m2, v2, wr, br, we, be, wproj),
                 2 * n * mid * cout + se),
                ("mbconv_kb_bwd", mb.kb_bwd, mb.kb_bwd_reference,
                 (y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj),
                 4 * n * mid * cout + 3 * se),
                ("mbconv_ka_bwd", mb.ka_bwd, None,
                 (x, dy2, wexp, g1, b1, wdw, m1, v1, k),
                 6 * n * cin * mid * expand + 4 * n * mid * k * k)):
            call = functools.partial(fn, *args)
            ms = cuda_ms(call)
            totals[name] += B0_BLOCKS[block] * ms
            more = ""
            if plain is not None:
                more = (f", plain "
                        f"{cuda_ms(functools.partial(plain, *args))!r} ms")
            bound = _bound(args, call(), flops)
            print(f"kernel-profile {name} [{label}]: {ms!r} ms{more}, bound "
                  f"{bound[0]!r} ms ({bound[1]})", flush=True)
            if block in KA_BWD_PROFILED:
                _call_profile(name, label, call)
    for name, total in totals.items():
        print(f"kernel-profile {name}: sum over B0's {MBCONV_BLOCKS} "
              f"stride-1 blocks {total!r} ms", flush=True)

    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)

    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    state, step = _train_state(flagship_vit(fused_ffn=True), init, device)
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    state, _ = step(state, batch, 0)  # warm-up
    _, (peak, rise) = _peak_step(state, step, batch)
    print(f"kernel-profile ffn train: peak device memory of one fused-FFN "
          f"flagship train step (max_memory_allocated) {peak!r} MiB, "
          f"{rise!r} MiB above the step's start", flush=True)


def _rank_table():
    """{kernel: {path: [(record label prefix, suffix, share of the path's
    launches)]}}: the shapes at which each path launches each kernel
    (suffix None: the label is the prefix). A path's ViT layers take 12 of
    its 14 attention and FFN launches, its profile encoder 2; B0's 12
    blocks take their ``MBCONV_SHAPES`` row by ``B0_BLOCKS``. Train paths
    run dropout 0.1 in the profile encoder (and the FFN), encode paths
    none; eval steps inside the card paths count as train launches. The
    loss kernels run at each path's bucket shape: the flagship's 16 x 16,
    the cards' 4 x 16, the global phase's 1 x 256 and the SigLIP card's
    global phase's 1 x 64."""
    vit, prof = 12 / ATTENTION_LAYERS, 2 / ATTENTION_LAYERS

    def pair(a, b, vit_mode, prof_mode, rows=SHAPES):
        return [(f"{a} B={rows[a][0]} ", vit_mode, vit),
                (f"{b} B={rows[b][0]} ", prof_mode, prof)]

    flag, card = ("vit", "profile"), ("card vit", "card profile")
    fwd_train = {p: pair(*flag, "eval", "train p=0.1")
                 for p in ("train", "global", "ffn_train")}
    fwd_train.update({p: pair(*card, "eval", "train p=0.1")
                      for p in ("card", "siglip_global", "ffn_card")})
    fwd = dict(fwd_train, encode=pair(*flag, "eval", "eval"),
               ffn_encode=pair(*flag, "eval", "eval"))
    bwd = {p: pair(*flag, "p=0.0", "p=0.1")
           for p in ("train", "global", "ffn_train")}
    bwd.update({p: pair(*card, "p=0.0", "p=0.1")
                for p in ("card", "siglip_global", "ffn_card")})
    ffn_rows = {"ffn_encode": pair(*flag, "gelu bfloat16 p=0.0",
                                   "gelu bfloat16 p=0.0", FFN_SHAPES),
                "ffn_train": pair(*flag, "gelu bfloat16 p=0.1",
                                  "gelu bfloat16 p=0.1", FFN_SHAPES),
                "ffn_card": pair(*card, "gelu bfloat16 p=0.1",
                                 "gelu bfloat16 p=0.1", FFN_SHAPES)}
    def loss_rows(buckets, n):
        return [(f"buckets={buckets} N={n} D=512", None, 1.0)]

    clip = {p: loss_rows(BUCKETS, BATCH // BUCKETS)
            for p in ("train", "ffn_train", "unpacked", "fuse_proj",
                      "flax_attention")}
    clip["b0_card"] = loss_rows(B0_CARD["buckets"],
                                B0_CARD["bs"] // B0_CARD["buckets"])
    clip["global"] = loss_rows(1, BATCH)
    siglip = {p: loss_rows(CARD["buckets"], CARD["bs"] // CARD["buckets"])
              for p in ("card", "ffn_card")}
    siglip["siglip_global"] = loss_rows(1, CARD["bs"])
    b0 = {"b0_card": [(f"{blk} ", "", n / MBCONV_BLOCKS)
                      for blk, n in B0_BLOCKS.items()]}
    block = {"fuse_proj": pair(*flag, "p=0.0", "p=0.1")}
    return {"mha_qkv_fwd": fwd, "mha_qkv_bwd": bwd,
            "mha_fwd": {"unpacked": pair(*flag, "eval", "train p=0.1")},
            "mha_bwd": {"unpacked": pair(*flag, "p=0.0", "p=0.1")},
            "clip_fwd": clip, "clip_bwd": clip, "siglip_fwd": siglip,
            "siglip_bwd": siglip, **{f"mbconv_{k}": b0 for k in (
                "ka_fwd", "kb_fwd", "kb_bwd", "ka_bwd")},
            "ffn_fwd": ffn_rows,
            "ffn_bwd": {k: v for k, v in ffn_rows.items()
                        if k != "ffn_encode"},
            "attn_block_fwd": block, "attn_block_bwd": block}


def _ranking(records, launches):
    """Print, for each kernel, the sum over paths of its launches there x
    (its time - its bound) at the shapes the path runs, largest first: the
    order in which the kernels lose the most time on this run's paths."""
    out = []
    for name, paths in _rank_table().items():
        by_path = {}
        for path, shapes in paths.items():
            n = launches.get(path, {}).get(name, 0)
            if not n:
                continue
            total = 0.0
            for prefix, suffix, share in shapes:
                hits = [r for label, r in records[name].items()
                        if (label == prefix if suffix is None else
                            label.startswith(prefix) and
                            label.endswith(suffix))]
                if not hits:
                    fail(f"ranking: no {name} record at {prefix!r} "
                         f"{suffix!r}")
                r = hits[0]
                total += n * share * (r["ms"] - r["bound_ms"])
            by_path[path] = total
        out.append({"name": name, "excess_ms": sum(by_path.values()),
                    "by_path": by_path})
    out.sort(key=lambda r: -r["excess_ms"])
    print("ranking: launches x (device ms - bound ms) summed over this "
          "run's paths, largest first: " + json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also break each card's micro-step device "
                             "time down by kernel (torch.profiler)")
    parser.add_argument("--kernel-profile", action="store_true",
                        help="only time and profile kernels 5-10 and "
                             "13-16 (no paths, no result line)")
    args = parser.parse_args(argv)
    device = phase_device()
    if args.kernel_profile:
        phase_kernel_profile(device)
        return
    phase_build()
    records = phase_kernel(device)
    launches = {"encode": phase_slice(device), "train": phase_train(device),
                "global": phase_global(device),
                "card": phase_card(device),
                "siglip_global": phase_siglip_global(device),
                "b0_encode": phase_b0_encode(device),
                "b0_card": phase_b0_card(device),
                "ffn_encode": phase_ffn_encode(device),
                "ffn_train": phase_ffn_train(device),
                "ffn_card": phase_ffn_card(device),
                "unpacked": phase_unpacked(device),
                "fuse_proj": phase_fuse_proj(device),
                "flax_attention": phase_flax_attention(device)}
    if args.profile:
        phase_profile(device)
    _ranking(records, launches)

    import torch

    kernels = []
    for name, source, line, first in (
            ("mha_qkv_fwd", "attention_fwd.cu", "attention.py:355",
             "vit B=256 L=197 H=3 mask=False eval"),
            ("mha_qkv_bwd", "attention_bwd.cu", "attention.py:401",
             "vit B=256 L=197 H=3 mask=False p=0.0"),
            ("mha_fwd", "attention_fwd.cu", "attention.py:233",
             "vit B=256 L=197 H=3 mask=False eval"),
            ("mha_bwd", "attention_bwd.cu", "attention.py:282",
             "vit B=256 L=197 H=3 mask=False p=0.0"),
            ("clip_fwd", "clip_loss.cu", "contrastive.py:39",
             f"buckets={BUCKETS} N={BATCH // BUCKETS} D=512"),
            ("clip_bwd", "clip_loss.cu", "contrastive.py:58",
             f"buckets={BUCKETS} N={BATCH // BUCKETS} D=512"),
            ("siglip_fwd", "siglip_loss.cu", "contrastive.py:165",
             "buckets=4 N=16 D=512"),
            ("siglip_bwd", "siglip_loss.cu", "contrastive.py:180",
             "buckets=4 N=16 D=512"),
            *((f"mbconv_{k}", f"mbconv_{k[3:]}.cu",
               f"experimental/mbconv.py:{line}", "stage2_block1 B=64 H=W=56 "
               "cin=24 mid=144 cout=24 k=3 r=6")
              for k, line in (("ka_fwd", 163), ("kb_fwd", 265),
                              ("kb_bwd", 303), ("ka_bwd", 373))),
            ("ffn_fwd", "ffn.cu", "experimental/ffn.py:116",
             "vit B=256 L=197 E=192 F=768 gelu bfloat16 p=0.0"),
            ("ffn_bwd", "ffn.cu", "experimental/ffn.py:132",
             "vit B=256 L=197 E=192 F=768 gelu bfloat16 p=0.0"),
            ("attn_block_fwd", "attention_block.cu",
             "experimental/attention_block.py:86",
             "vit B=256 L=197 H=3 E=192 mask=False p=0.0"),
            ("attn_block_bwd", "attention_block.cu",
             "experimental/attention_block.py:102",
             "vit B=256 L=197 H=3 E=192 mask=False p=0.0")):
        by_path = {path: counts[name] for path, counts in launches.items()}
        record = records[name][first]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{source}",
            "replaces": f"{PALLAS}/{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"]
                               for r in records[name].values()),
            "ms": record["ms"], "plain_ms": record["plain_ms"],
            "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
            "library_ms": record["library_ms"], "shapes": records[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
