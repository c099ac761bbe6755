#!/usr/bin/env python3
"""Convert timm / torch pretrained weights into the npz that a model card's
``pretrained: true, pretrained_path: <out.npz>`` loads into the PyTorch
port: the CLI and flags of ``scripts/convert_timm.py``, on the port's
``models/convert_timm.py`` (numpy; no JAX).

    python scripts/convert_timm_torch.py -a efficientnet_b0 \\
        -i efficientnet_b0.safetensors -o b0_imagenet.npz [--in-chans 1] \\
        [--prefix efficientnet_b0/backbone]

    python scripts/convert_timm_torch.py --selftest [-a ARCH] [--device cpu]

Input: a ``.safetensors`` file (read without the ``safetensors`` package)
or a ``torch.save`` checkpoint holding the backbone's state dict.

``--prefix`` defaults to ``image_encoder/backbone``, as in the JAX CLI; a
model tree names the image encoder after its backbone, so that default
loads nothing (``loaded: 0``): pass ``<arch>/backbone`` to load.

``--selftest`` (needs timm): for each architecture, builds the timm model,
converts its state dict, loads it into the port's backbone and compares
the two forwards on one random input. ``--from-hub`` (needs timm and the
network) downloads timm's ImageNet weights, checks the same parity and
writes the npz. Without timm both print why and exit 2.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from multimodal_plankton_recognition_torch.models.convert_timm import (  # noqa: E402
    ARCH_SPECS, convert_state_dict, convert_to_npz,
)

#: the forward parity both timm paths require, relative to max |timm|
PARITY_TOL = 5e-3


def _parity(arch: str, model, device: str) -> float:
    """Relative max |port - timm| of the forwards of the timm ``model``
    and the port's backbone holding its converted weights, on one random
    input (2 x 224 x 224 x 3, f32, on ``device``)."""
    import torch

    from multimodal_plankton_recognition_torch.convert import from_flax
    from multimodal_plankton_recognition_torch.models.image.registry import (
        create_backbone,
    )
    from multimodal_plankton_recognition_torch.models.pretrained import (
        unflatten_params,
    )

    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    params, stats, missing = convert_state_dict(arch, sd, in_chans=3)
    if missing:
        raise KeyError(f"{len(missing)} unmapped keys {missing[:4]}")
    variables = {"params": unflatten_params(params)}
    if stats:
        variables["batch_stats"] = unflatten_params(stats)
    port = create_backbone(arch, in_chans=3)
    port.load_state_dict(from_flax(variables), strict=True)
    x = np.random.default_rng(0).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    with torch.no_grad():
        ref = model.to(device).eval()(xt.permute(0, 3, 1, 2)).float()
        out = port.to(device).eval()(xt).float()
    err = float((out - ref).abs().max())
    return err / (float(ref.abs().max()) or 1.0)


def selftest(archs, device: str) -> int:
    try:
        import timm
    except ImportError as e:
        print(f"selftest: {e} — run this where timm is installed "
              f"(offline direction pins: tests/test_torch_convert_timm.py)")
        return 2
    failures = 0
    for arch in archs:
        model = timm.create_model(arch, pretrained=False, num_classes=0,
                                  in_chans=3)
        try:
            rel = _parity(arch, model, device)
        except KeyError as e:
            print(f"FAIL {arch}: {e}")
            failures += 1
            continue
        ok = rel < PARITY_TOL
        print(f"{'PASS' if ok else 'FAIL'} {arch}: relative max|Δ| "
              f"{rel:.2e}")
        failures += 0 if ok else 1
    return 1 if failures else 0


def from_hub(arch: str, output: str, in_chans: int, prefix: str,
             device: str) -> int:
    """timm's ImageNet weights for ``arch`` (downloaded by timm), their
    forward parity checked against the port's backbone at 3 channels,
    written to ``output`` adapted to ``in_chans``."""
    try:
        import timm
        import torch
    except ImportError as e:
        print(f"--from-hub: {e} — run this where timm is installed, e.g.\n"
              f"  pip install timm && python scripts/convert_timm_torch.py "
              f"--from-hub -a {arch} -o {output}")
        return 2
    model = timm.create_model(arch, pretrained=True, num_classes=0,
                              in_chans=3)
    try:
        rel = _parity(arch, model, device)
    except KeyError as e:
        print(f"FAIL: {e}")
        return 1
    if rel >= PARITY_TOL:
        print(f"FAIL: forward parity, relative max|Δ| {rel:.2e}")
        return 1
    print(f"parity OK: relative max|Δ| {rel:.2e}")
    with tempfile.NamedTemporaryFile(suffix=".pth") as tmp:
        torch.save(model.cpu().state_dict(), tmp.name)
        counts = convert_to_npz(arch, tmp.name, output, in_chans=in_chans,
                                prefix=prefix)
    print(f"wrote {output}: {counts['params']} params + "
          f"{counts['batch_stats']} batch_stats arrays (in_chans="
          f"{in_chans})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-a", "--arch", choices=sorted(ARCH_SPECS),
                   help="Backbone architecture (timm model name).")
    p.add_argument("-i", "--input",
                   help="Path to .safetensors or torch .pth/.bin weights.")
    p.add_argument("-o", "--output", help="Output .npz path.")
    p.add_argument("--in-chans", type=int, default=1,
                   help="Model input channels (stem kernels adapted the "
                        "timm way; default 1 = grayscale).")
    p.add_argument("--prefix", default="image_encoder/backbone",
                   help="Flax path prefix of the backbone inside the model "
                        "(the JAX CLI's default, which names no path of a "
                        "model tree; the tree's own is <arch>/backbone).")
    p.add_argument("--selftest", action="store_true",
                   help="Forward parity of every arch spec against timm "
                        "itself (requires timm).")
    p.add_argument("--from-hub", action="store_true",
                   help="Download timm's pretrained weights for -a, check "
                        "forward parity, write -o (requires timm and the "
                        "network).")
    p.add_argument("--device", default="cuda",
                   help="Device of the --selftest / --from-hub forwards "
                        "(default: the card).")
    args = p.parse_args(argv)
    if args.selftest:
        return selftest([args.arch] if args.arch else sorted(ARCH_SPECS),
                        args.device)
    if args.from_hub:
        if not (args.arch and args.output):
            p.error("--from-hub needs -a and -o")
        return from_hub(args.arch, args.output, args.in_chans, args.prefix,
                        args.device)
    if not (args.arch and args.input and args.output):
        p.error("-a, -i and -o are required unless --selftest/--from-hub")
    counts = convert_to_npz(args.arch, args.input, args.output,
                            in_chans=args.in_chans, prefix=args.prefix)
    print(f"wrote {args.output}: {counts['params']} params + "
          f"{counts['batch_stats']} batch_stats arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
