#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Needs a CUDA card (device 0) and ``nvcc``; there is no CPU path. Phases, each
fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles every kernel of the path from ``csrc/`` and prints the
   build seconds and ptxas' register / spill report;
3. kernel against plain version: the attention kernel against
   ``mha_qkv_reference`` on the same inputs at both ViT-flagship shapes
   (B=256; ViT-T L=197 H=3 no mask; profile L=225 H=8 random key padding,
   CLS kept): max abs error <= 2e-2, no NaN, median ms of both (CUDA
   events after warm-up);
4. slice: the full-width ViT flagship (bf16, dim_embed 512, random weights
   from a seeded torch.Generator) encodes a synthetic gallery of 2,048
   pairs in batches of 256 through ``retrieval.encode.encode_arrays``; the
   attention kernel must launch exactly 14 times per batch (12 ViT + 2
   profile layers); embeddings must be finite with unit norm and within
   5e-2 of the same weights on the plain attention; then ``ANNClassifier``
   classifies the gallery against itself in four setups (image, profile,
   image->profile, fused image+profile), and the self-matching ones
   (k = 1) must be >= 99% right.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "multimodal_plankton_recognition_torch"
BATCH = 256
GALLERY = 2048
KERNEL_TOL = 2e-2
SLICE_TOL = 5e-2
ATTENTION_LAYERS = 12 + 2  # ViT-T blocks + ProfileTransformer layers


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    from multimodal_plankton_recognition_torch.ops import attention, build

    t0 = time.perf_counter()
    lib = build.build("attention_fwd")
    attention._lib()
    print(f"build: attention_fwd {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(REPO)}", flush=True)
    log = lib.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)


def phase_kernel(device):
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_qkv, mha_qkv_reference)

    gen = torch.Generator(device=device).manual_seed(0)
    e = 192
    shapes = {}
    for name, l, heads, masked in (("vit", 197, 3, False),
                                   ("profile", 225, 8, True)):
        qkv = torch.randn((BATCH, l, 3 * e), generator=gen, device=device
                          ).to(torch.bfloat16)
        bias = None
        if masked:
            pad = torch.rand((BATCH, l), generator=gen, device=device) < 0.3
            pad[:, 0] = False  # CLS is never masked
            bias = torch.where(pad, -1e9, 0.0).to(torch.float32)
        out = mha_qkv(qkv, bias, heads)
        ref = mha_qkv_reference(qkv, bias, heads)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"attention kernel ({name}) produced non-finite values")
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: mha_qkv(qkv, bias, heads))
        plain_ms = cuda_ms(lambda: mha_qkv_reference(qkv, bias, heads))
        print(f"kernel mha_qkv_fwd [{name} B={BATCH} L={l} H={heads} "
              f"D={e // heads} mask={masked}]: max_abs_err {err!r} "
              f"(tol {KERNEL_TOL}), kernel {ms!r} ms, plain {plain_ms!r} ms",
              flush=True)
        if not err <= KERNEL_TOL:
            fail(f"attention kernel ({name}) disagrees with its plain "
                 f"version: max abs error {err} > {KERNEL_TOL}")
        shapes[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    return shapes


def phase_slice(device):
    import numpy as np
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.ops.attention import mha_qkv
    from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_arrays)

    model = init_weights_(flagship_vit(), torch.Generator().manual_seed(0))
    plain = flagship_vit(fused_attention=False)
    plain.load_state_dict(model.state_dict())
    model.to(device).eval()
    plain.to(device).eval()

    gallery = synthetic_batch_vit(GALLERY, seed=1, device=device)
    labels = np.random.RandomState(2).randint(0, 16, GALLERY)
    warm = {k: v[:BATCH] for k, v in gallery.items()}
    encode_arrays(model, warm, labels[:BATCH], BATCH, device)  # warm-up

    mha_qkv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = encode_arrays(model, gallery, labels, BATCH, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mha_qkv.launches

    n_batches = GALLERY // BATCH
    print(f"slice: encoded {GALLERY} pairs in {n_batches} batches of "
          f"{BATCH}: {GALLERY / seconds!r} pairs/s ({seconds!r} s), "
          f"attention launches {launches} "
          f"({launches / n_batches!r} per batch)", flush=True)
    if launches != ATTENTION_LAYERS * n_batches:
        fail(f"expected {ATTENTION_LAYERS} attention launches per batch, got "
             f"{launches} over {n_batches} batches")

    encode_arrays(plain, warm, labels[:BATCH], BATCH, device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = encode_arrays(plain, gallery, labels, BATCH, device)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    print(f"slice: plain attention {GALLERY / plain_seconds!r} pairs/s",
          flush=True)

    for key in ("image", "profile"):
        x = emb[key]
        if x.shape != (GALLERY, 512) or not np.isfinite(x).all():
            fail(f"{key} embeddings: shape {x.shape} or non-finite values")
        norm_err = float(np.abs(np.linalg.norm(x, axis=1) - 1.0).max())
        diff = float(np.abs(x - ref[key]).max())
        print(f"slice: {key} embeddings |norm-1| max {norm_err!r}, "
              f"max abs diff to plain attention {diff!r} (tol {SLICE_TOL})",
              flush=True)
        if not norm_err <= 1e-2:
            fail(f"{key} embeddings are not unit-norm ({norm_err})")
        if not diff <= SLICE_TOL:
            fail(f"{key} embeddings disagree with plain attention: {diff}")

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


def main() -> None:
    device = phase_device()
    phase_build()
    shapes = phase_kernel(device)
    launches = phase_slice(device)

    import torch

    record = {
        "name": "mha_qkv_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/attention_fwd.cu",
        "replaces": "multimodal_plankton_recognition_tpu/ops/pallas/"
                    "attention.py:355",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        "ms": shapes["vit"]["ms"], "plain_ms": shapes["vit"]["plain_ms"],
        "shapes": shapes,
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
