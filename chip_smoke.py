#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Needs a CUDA card (device 0) and ``nvcc``; there is no CPU path. Phases, each
fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles every kernel of the paths from ``csrc/`` (one ``nvcc``
   per source, all at once) and prints the build seconds and ptxas'
   register / spill report;
3. kernels against their plain versions, on the same inputs at the ViT
   flagship's shapes (B=256; ViT-T L=197 H=3 D=64 no mask; profile L=225
   H=8 D=24 random key padding, CLS kept), with max abs error, its
   tolerance, no NaN, and median ms of kernel and plain version (CUDA
   events after warm-up):
   * attention forward (``mha_qkv`` vs ``mha_qkv_reference``), eval mode at
     both shapes and train mode (dropout 0.1) at the profile shape, within
     2e-2; and train mode on inputs whose every sum is exact (q = k = 0,
     v = ±1), where kernel and plain version must agree bit for bit, so a
     single mask bit that differs would show;
   * attention backward (``mha_qkv_bwd`` vs ``mha_qkv_bwd_reference``) at
     the ViT shape and at the profile shape with mask and dropout 0.1,
     within 1e-2 of the largest |dqkv|;
   * CLIP loss forward and backward (``clip_fwd`` / ``clip_bwd`` vs
     ``clip_loss_fused_reference`` / ``clip_loss_bwd_reference``) at 16
     buckets of 16 and 1 bucket of 256, width 512: loss within 1e-5
     relative, gradients within 1e-2 of the largest, d logit_scale within
     1e-3 relative;
4. encode: the full-width ViT flagship (bf16, dim_embed 512, random weights
   from a seeded torch.Generator) encodes a synthetic gallery of 2,048
   pairs in batches of 256 through ``retrieval.encode.encode_arrays``; the
   attention kernel must launch exactly 14 times per batch (12 ViT + 2
   profile layers); embeddings must be finite with unit norm and within
   5e-2 of the same weights on the plain attention; then ``ANNClassifier``
   classifies the gallery against itself in four setups (image, profile,
   image->profile, fused image+profile), and the self-matching ones
   (k = 1) must be >= 99% right;
5. train: the same flagship with f32 master weights initialised from a
   seeded f32 model takes 20 ``train_step``s (SGD lr 5e-3, momentum 0.9,
   nesterov, weight decay 1e-3, buckets 16, dropout 0.1 in the profile
   encoder and on the image feature) on one synthetic batch of 256; per
   step the attention forward and backward kernels must launch 14 times
   each and the CLIP kernels once each; every loss finite, the least of the
   last 5 below the first, the masters f32 and every one moved; train
   pairs/s over steps 4-20. Then one step from the same weights with
   dropout 0 on the kernel path and on the plain path (plain attention,
   unfused CLIP loss): losses within 1e-2, named gradients within 5e-2
   relative (L2); and the plain path's train pairs/s.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "multimodal_plankton_recognition_torch"
PALLAS = "multimodal_plankton_recognition_tpu/ops/pallas"
SOURCES = ("attention_fwd", "attention_bwd", "clip_loss")
BATCH = 256
BUCKETS = 16
GALLERY = 2048
TRAIN_STEPS = 20
WARMUP_STEPS = 3
PLAIN_STEPS = 8
KERNEL_TOL = 2e-2
BWD_TOL = 1e-2    # of the largest |dqkv|
CLIP_LOSS_TOL = 1e-5   # relative
CLIP_GRAD_TOL = 1e-2   # of the largest |gradient|
CLIP_SCALE_TOL = 1e-3  # relative
SLICE_TOL = 5e-2
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 5e-2
ATTENTION_LAYERS = 12 + 2  # ViT-T blocks + ProfileTransformer layers
SHAPES = {"vit": (197, 3, False), "profile": (225, 8, True)}  # L, H, mask
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
    from multimodal_plankton_recognition_torch.ops import (
        attention, build, contrastive)

    t0 = time.perf_counter()
    libs = build.build_all(SOURCES)
    attention._fwd_lib()
    attention._bwd_lib()
    contrastive._lib()
    print(f"build: {', '.join(SOURCES)} in parallel, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, lib in libs.items():
        print(f"  {name} -> {lib.relative_to(REPO)}", flush=True)
        log = lib.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)


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


def _attention_inputs(gen, device, l, heads, masked, e=192):
    import torch

    qkv = torch.randn((BATCH, l, 3 * e), generator=gen, device=device
                      ).to(torch.bfloat16)
    bias = None
    if masked:
        pad = torch.rand((BATCH, l), generator=gen, device=device) < 0.3
        pad[:, 0] = False  # CLS is never masked
        bias = torch.where(pad, -1e9, 0.0).to(torch.float32)
    return qkv, bias


def _report(records, name, label, err, tol, ms, plain_ms):
    print(f"kernel {name} [{label}]: max_abs_err {err!r} (tol {tol}), "
          f"kernel {ms!r} ms, plain {plain_ms!r} ms", flush=True)
    records.setdefault(name, {})[label] = {
        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms}


def phase_kernel(device):
    """Every kernel against its plain version; returns {name: {shape:
    numbers}}."""
    import torch
    from multimodal_plankton_recognition_torch.ops.attention import (
        mha_qkv, mha_qkv_bwd, mha_qkv_bwd_reference, mha_qkv_reference)
    from multimodal_plankton_recognition_torch.ops.contrastive import (
        clip_bwd, clip_fwd, clip_loss_bwd_reference,
        clip_loss_fused_reference)

    gen = torch.Generator(device=device).manual_seed(0)
    records = {}
    seed = 1234
    for name, (l, heads, masked) in SHAPES.items():
        qkv, bias = _attention_inputs(gen, device, l, heads, masked)
        modes = [("eval", 0.0)] + ([("train p=0.1", 0.1)] if masked else [])
        for mode, p in modes:
            label = f"{name} B={BATCH} L={l} H={heads} mask={masked} {mode}"
            err = _check(f"mha_qkv_fwd {label}",
                         mha_qkv(qkv, bias, heads, p, seed),
                         mha_qkv_reference(qkv, bias, heads, p, seed),
                         KERNEL_TOL)
            _report(records, "mha_qkv_fwd", label, err, KERNEL_TOL,
                    cuda_ms(lambda: mha_qkv(qkv, bias, heads, p, seed)),
                    cuda_ms(lambda: mha_qkv_reference(qkv, bias, heads, p,
                                                      seed)))
        if masked:  # exact sums: the masks must agree bit for bit
            e = qkv.shape[2] // 3
            exact = torch.zeros_like(qkv)
            exact[..., 2 * e:] = torch.where(
                torch.rand((BATCH, l, e), generator=gen, device=device) < 0.5,
                -1.0, 1.0)
            err = _check(f"mha_qkv_fwd {name} mask check",
                         mha_qkv(exact, bias, heads, 0.1, seed),
                         mha_qkv_reference(exact, bias, heads, 0.1, seed),
                         0.0)
            print(f"kernel mha_qkv_fwd [{name} train p=0.1, q=k=0, v=+-1]: "
                  f"max_abs_err {err!r} (must be 0: same dropout mask)",
                  flush=True)
        p = 0.1 if masked else 0.0
        dout = torch.randn(qkv.shape[:2] + (qkv.shape[2] // 3,),
                           generator=gen, device=device).to(torch.bfloat16)
        want = mha_qkv_bwd_reference(qkv, bias, dout, heads, p, seed)
        scale = want.float().abs().max().item()
        label = f"{name} B={BATCH} L={l} H={heads} mask={masked} p={p}"
        err = _check(f"mha_qkv_bwd {label}",
                     mha_qkv_bwd(qkv, bias, dout, heads, p, seed), want,
                     BWD_TOL, scale)
        _report(records, "mha_qkv_bwd", label, err * scale, BWD_TOL * scale,
                cuda_ms(lambda: mha_qkv_bwd(qkv, bias, dout, heads, p, seed)),
                cuda_ms(lambda: mha_qkv_bwd_reference(qkv, bias, dout, heads,
                                                      p, seed)))

    for buckets, n in ((BUCKETS, BATCH // BUCKETS), (1, BATCH)):
        img = torch.randn((buckets * n, 512), generator=gen, device=device
                          ).to(torch.bfloat16)
        prof = torch.randn((buckets * n, 512), generator=gen, device=device
                           ).to(torch.bfloat16)
        scale = torch.full((), 0.7, device=device)
        g = torch.full((), 1.3, device=device)
        label = f"buckets={buckets} N={n} D=512"
        want = clip_loss_fused_reference(img, prof, scale, buckets)
        err = _check(f"clip_fwd {label}", clip_fwd(img, prof, scale, buckets),
                     want, CLIP_LOSS_TOL, want.abs().item())
        _report(records, "clip_fwd", label, err * want.abs().item(),
                CLIP_LOSS_TOL * want.abs().item(),
                cuda_ms(lambda: clip_fwd(img, prof, scale, buckets)),
                cuda_ms(lambda: clip_loss_fused_reference(img, prof, scale,
                                                          buckets)))
        got = clip_bwd(img, prof, scale, g, buckets)
        want = clip_loss_bwd_reference(img, prof, scale, g, buckets)
        top = max(w.float().abs().max().item() for w in want[:2])
        err = max(_check(f"clip_bwd {what} {label}", got[i], want[i],
                         CLIP_GRAD_TOL, top)
                  for i, what in enumerate(("d_image", "d_profile")))
        _check(f"clip_bwd d_logit_scale {label}", got[2], want[2],
               CLIP_SCALE_TOL, want[2].abs().item())
        _report(records, "clip_bwd", label, err * top, CLIP_GRAD_TOL * top,
                cuda_ms(lambda: clip_bwd(img, prof, scale, g, buckets)),
                cuda_ms(lambda: clip_loss_bwd_reference(img, prof, scale, g,
                                                        buckets)))
    return records


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


def _train_state(model, state_dict, device):
    from multimodal_plankton_recognition_torch.config import OptimConfig
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_multi_steps, make_optimizer)

    tx = make_optimizer(OptimConfig(lr=5e-3, momentum=0.9, weight_decay=1e-3,
                                    nesterov=True))
    model.to(device)
    state = create_train_state(model, state_dict, tx)
    train_step, _ = make_multi_steps(model, tx, buckets=BUCKETS)
    return state, train_step


def _pairs_per_s(state, train_step, batch, steps):
    """Train pairs/s over ``steps`` steps, ended by a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = train_step(state, batch, 0)
    torch.cuda.synchronize()
    return BATCH * steps / (time.perf_counter() - t0)


def phase_train(device):
    import torch
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_vit, init_weights_, synthetic_batch_vit)
    from multimodal_plankton_recognition_torch.ops import (
        attention, contrastive)

    counters = {"mha_qkv_fwd": attention.mha_qkv,
                "mha_qkv_bwd": attention.mha_qkv_bwd,
                "clip_fwd": contrastive.clip_fwd,
                "clip_bwd": contrastive.clip_bwd}
    per_step = {"mha_qkv_fwd": ATTENTION_LAYERS,
                "mha_qkv_bwd": ATTENTION_LAYERS,
                "clip_fwd": 1, "clip_bwd": 1}
    # f32 masters from an f32 model: never from one already rounded to bf16
    init = init_weights_(flagship_vit(dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    batch = synthetic_batch_vit(BATCH, seed=3, device=device)
    model = flagship_vit()
    state, train_step = _train_state(model, init, device)

    for fn in counters.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in counters.items()}
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
    for path, kw in (("kernel", {}),
                     ("plain", {"fused_attention": False,
                                "fused_loss": False})):
        m = flagship_vit(dropout=0.0, **kw)
        st, step = _train_state(m, init, device)
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
    for n in NAMED_GRADS:
        k, p = grads["kernel"][n], grads["plain"][n]
        rel = ((k - p).norm() / p.norm()).item()
        print(f"  grad {n}: relative L2 diff {rel!r} (tol {STEP_GRAD_TOL})",
              flush=True)
        if not rel <= STEP_GRAD_TOL:
            fail(f"kernel and plain train steps disagree on {n}: {rel}")

    plain = flagship_vit(fused_attention=False, fused_loss=False)
    pstate, pstep = _train_state(plain, init, device)
    _pairs_per_s(pstate, pstep, batch, WARMUP_STEPS)
    plain_rate = _pairs_per_s(pstate, pstep, batch, PLAIN_STEPS)
    print(f"train: plain path {plain_rate!r} pairs/s over {PLAIN_STEPS} "
          f"steps", flush=True)
    return launches


def main() -> None:
    device = phase_device()
    phase_build()
    records = phase_kernel(device)
    encode_launches = phase_slice(device)
    train_launches = phase_train(device)

    import torch

    kernels = []
    for name, source, line, first in (
            ("mha_qkv_fwd", "attention_fwd.cu", "attention.py:355",
             "vit B=256 L=197 H=3 mask=False eval"),
            ("mha_qkv_bwd", "attention_bwd.cu", "attention.py:401",
             "vit B=256 L=197 H=3 mask=False p=0.0"),
            ("clip_fwd", "clip_loss.cu", "contrastive.py:39",
             f"buckets={BUCKETS} N={BATCH // BUCKETS} D=512"),
            ("clip_bwd", "clip_loss.cu", "contrastive.py:58",
             f"buckets={BUCKETS} N={BATCH // BUCKETS} D=512")):
        by_path = {"train": train_launches[name]}
        if name == "mha_qkv_fwd":
            by_path["encode"] = encode_launches
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{source}",
            "replaces": f"{PALLAS}/{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"]
                               for r in records[name].values()),
            "ms": records[name][first]["ms"],
            "plain_ms": records[name][first]["plain_ms"],
            "shapes": records[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
