#!/usr/bin/env python3
"""The synthetic parity protocols at several model seeds, through the
JAX package on the CPU (the reference that calibrated the bands) or
through the PyTorch port (on the CPU, or on the card with ``--device
cuda`` as ``scripts/parity_gate_torch.py`` runs there): one JSON line a
draw, with the keys that leave the committed bands of
``tests/golden/parity_bands.json`` (read, never written); then, for each
protocol, the gate's rule (``parity_gate_torch.held``) over the draws at
its ``MODEL_SEEDS``, and how many single draws left the bands.

    python scripts/parity_seeds.py --package jax --protocols b0_cnn_siglip \
        --model-seeds 0 1 2 3 4
    python scripts/parity_seeds.py --package torch --protocols b0_cnn_siglip \
        --model-seeds 0 1 2 3 4 [--device cuda]

The bands were calibrated over data seeds 7-11 at the protocols' pinned
model seed 0 (``scripts/parity_gate.py --calibrate``). A model seed
replaces the card's ``seed`` (init, shuffles, dropout) and keeps the data
seed 7 of the gate. One process runs one package on one CPU thread; JAX
as its gate CLI sets it up (threefry, eight host devices, "highest"
matmul precision), the port on the card as its gate CLI does (TF32 off,
deterministic algorithms).
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "scripts"))

import parity_gate_torch as gate  # noqa: E402  (numpy only at import)


def _jax_runner():
    os.environ.setdefault("PLANKTON_PRNG", "threefry")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false"
        + " intra_op_parallelism_threads=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import test_parity_gate as jax_gate

    def run(workdir, protocol, model_seed):
        card = jax_gate.PROTOCOL_CARDS[protocol]
        pinned = card["seed"]
        card["seed"] = model_seed
        try:
            return jax_gate.run_parity_protocol(workdir, protocol)
        finally:
            card["seed"] = pinned
    return run


def _torch_runner(device):
    import torch

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)

    def run(workdir, protocol, model_seed):
        return gate.run_parity_protocol(workdir, protocol, device=device,
                                        model_seed=model_seed)
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=("jax", "torch"),
                        required=True)
    parser.add_argument("--protocols", nargs="+", required=True)
    parser.add_argument("--model-seeds", type=int, nargs="+",
                        default=[0, 1, 2, 3, 4])
    parser.add_argument("--device", default="cpu",
                        help="The port's device (JAX runs on the CPU).")
    args = parser.parse_args(argv)
    run = _jax_runner() if args.package == "jax" else \
        _torch_runner(args.device)
    outside = total = 0
    for protocol in args.protocols:
        draws = {}
        for model_seed in args.model_seeds:
            with tempfile.TemporaryDirectory() as tmp:
                acc = run(Path(tmp), protocol, model_seed)
            out = [k for k, (lo, hi) in gate.bands(protocol).items()
                   if not lo <= acc[k] <= hi]
            draws[model_seed] = acc
            total += 1
            outside += bool(out)
            print(json.dumps({"package": args.package,
                              "protocol": protocol,
                              "model_seed": model_seed, "acc": acc,
                              "outside": out}), flush=True)
        if all(s in draws for s in gate.MODEL_SEEDS):
            median, errors = gate.held(
                protocol, [draws[s] for s in gate.MODEL_SEEDS])
            print(f"{args.package} {protocol}: medians at model seeds "
                  f"{gate.MODEL_SEEDS} {json.dumps(median)}: "
                  f"{'held' if not errors else errors}", flush=True)
    print(f"{args.package}: {outside} of {total} draws outside the bands")
    return 0


if __name__ == "__main__":
    sys.exit(main())
