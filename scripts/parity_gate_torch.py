#!/usr/bin/env python3
"""The synthetic accuracy gate of ``tests/test_parity_gate.py`` and
``scripts/parity_gate.py``, run on the PyTorch port: each pinned protocol
(a synthetic corpus, a small card, a fixed train -> encode -> cross-folds
retrieval recipe) trains through the port's ``train_multi``, encodes
through its ``encode_split`` and is scored by its ``run_suite``; the
accuracies print beside the committed bands of
``tests/golden/parity_bands.json``.

    python scripts/parity_gate_torch.py [--protocols NAME ...] [--device cpu]

It runs on the card unless ``--device cpu`` is given (with TF32 off, as
the JAX CLI sets the "highest" matmul precision, and PyTorch's
deterministic algorithms, so that a protocol is a function of its seeds
as on the CPU; its ``precision:`` line says which), and exits 1 when a
protocol falls outside its bands or breaks the reference's cross-modal
pattern (P - P above I - P + 0.05). The bands are the JAX package's
record: this script reads them and never writes them (it has no
``--calibrate``).

A protocol is held by one rule: it trains at each of ``MODEL_SEEDS``,
and the median of each accuracy over those draws must lie in the bands
(``held``). One draw is one sample of the protocol's training noise. The
JAX package calibrated the bands over data seeds at its pinned model
seed, and its own single draws at other model seeds leave them, as the
port's do (``scripts/parity_seeds.py``; ``PERF.md``).

``PROTOCOL_CARDS``, ``DATA_KW``, ``GALLERY_N``, ``KNN_K``, ``REPEATS``
and ``SETUPS`` are a copy of ``tests/test_parity_gate.py``'s, held equal
to them by ``tests/test_torch_parity_gate.py``.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

GOLDEN = REPO / "tests" / "golden" / "parity_bands.json"

_BASE_OPTIM = {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4,
               "nesterov": True}
_CNN_PROFILE = {"kind": "cnn", "dim_in": 6, "blocks": [1, 1, 1, 1],
                "base_channels": 8}


def _protocol(image, profile, method, epochs):
    return {"bs": 8, "dim_embedding": 32, "target_size": 32, "buckets": 2,
            "num_workers": 2, "patience": 99, "save_top_k": 1, "seed": 0,
            "image_encoder_args": image, "profile_encoder_args": profile,
            "coordination_args": {"method": method},
            "optim_args": _BASE_OPTIM,
            "trainer_args": {"precision": "32", "min_epochs": epochs,
                             "max_epochs": epochs}}


PROTOCOL_CARDS = {
    "resnet_cnn_clip": _protocol(
        {"name": "resnet18", "metadata": True}, _CNN_PROFILE, "clip", 15),
    "b0_cnn_clip": _protocol(
        {"name": "efficientnet_b0", "metadata": True}, _CNN_PROFILE,
        "clip", 10),
    "b0_cnn_siglip": _protocol(
        {"name": "efficientnet_b0", "metadata": True}, _CNN_PROFILE,
        "siglip", 10),
    "resnet_lstm_clip": _protocol(
        {"name": "resnet18", "metadata": True},
        {"kind": "lstm", "dim_in": 6, "dim_hidden": 32, "num_layers": 1},
        "clip", 15),
    "vit_transformer_siglip": _protocol(
        {"name": "vit_tiny_patch16_224", "metadata": True,
         "fused_attention": True,
         "backbone_kwargs": {"img_size": 32, "depth": 2, "embed_dim": 32,
                             "num_heads": 4}},
        {"kind": "transformer", "dim_in": 6, "dim_hidden": 32,
         "num_head": 4, "num_layers": 2, "dim_feedforward": 64,
         "target_size": 32, "fused_attention": True},
        "siglip", 15),
}
DATA_KW = dict(n_classes=5, n_per_class=24, seed=7)
GALLERY_N = 8
KNN_K = 3
REPEATS = 3
SETUPS = ("I - I", "P - P", "I - P", "I+P - P")
#: the reference's cross-modal pattern: same-modal retrieval well above
#: cross-modal transfer (experiments.ipynb cell 22)
PATTERN_GAP = 0.05
#: the model seeds a protocol trains at; their draws' medians are held
MODEL_SEEDS = (0, 1, 2)
#: what a run on the card prints of its arithmetic
PRECISION = "precision: matmul TF32 {}, cuDNN TF32 {}, deterministic {}"


def run_parity_protocol(workdir: Path, protocol: str = "resnet_cnn_clip",
                        data_seed: int = 7, device: str = "cuda",
                        model_seed: Optional[int] = None) -> dict:
    """Train -> encode -> cross-folds retrieval on the port; the mean
    accuracy of each of ``SETUPS`` and the first and last epochs' train
    losses, as JAX's ``run_parity_protocol`` returns them. ``model_seed``
    replaces the protocol's pinned card seed (init, shuffles, dropout)."""
    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.data.synthetic import (
        make_synthetic_dataset,
    )
    from multimodal_plankton_recognition_torch.retrieval.benchmark import (
        run_suite,
    )
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_split,
    )
    from multimodal_plankton_recognition_torch.train.drivers import (
        train_multi,
    )

    workdir = Path(workdir)
    split = make_synthetic_dataset(workdir / "data",
                                   **dict(DATA_KW, seed=data_seed))
    card = copy.deepcopy(PROTOCOL_CARDS[protocol])
    if model_seed is not None:
        card["seed"] = model_seed
    card = ModelCard.from_dict(card)
    result = train_multi(split, card, logdir=workdir / "logs", device=device)
    entry = encode_split(f"{result['logdir']}/checkpoints", split,
                         batch_size=8, num_workers=1, device=device)
    results = run_suite({"gate": {1: entry}}, mode="cross_folds",
                        N=(GALLERY_N,), K=(KNN_K,), repeats=REPEATS, th=1,
                        seed=0, device=device)
    runs = results["gate"][1][GALLERY_N]
    acc = {}
    for setup in SETUPS:
        vals = [float(np.mean(np.asarray(r["pred"][KNN_K][setup]) ==
                              np.asarray(r["true"])))
                for r in runs.values()]
        acc[setup] = float(np.mean(vals))
    acc["final_train_loss"] = float(result["history"][-1]["train_loss"])
    acc["first_train_loss"] = float(result["history"][0]["train_loss"])
    return acc


def bands(protocol: str) -> dict:
    """The committed bands of ``protocol``: {key: [lo, hi]}."""
    return json.loads(GOLDEN.read_text())["protocols"][protocol]["bands"]


def held(protocol: str, draws: Sequence[dict]) -> Tuple[dict, list]:
    """(the median of each key over ``draws``, its ``violations``): the
    protocol holds when the medians of its draws at ``MODEL_SEEDS`` lie
    in the bands and show the pattern."""
    median = {k: float(np.median([d[k] for d in draws])) for k in draws[0]}
    return median, violations(protocol, median)


def violations(protocol: str, acc: dict) -> list:
    """What of ``acc`` breaks the protocol's bands or the cross-modal
    pattern, one line each (empty when it holds)."""
    errors = [f"{key}: {acc[key]:.4f} outside [{lo}, {hi}]"
              for key, (lo, hi) in bands(protocol).items()
              if not lo <= acc[key] <= hi]
    if not acc["P - P"] > acc["I - P"] + PATTERN_GAP:
        errors.append(f"cross-modal pattern: P - P {acc['P - P']:.4f} not "
                      f"above I - P {acc['I - P']:.4f} + {PATTERN_GAP}")
    return errors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--protocols", nargs="*", default=None,
                        choices=sorted(PROTOCOL_CARDS),
                        help="Protocols to run (default: all five).")
    parser.add_argument("--seed", type=int, default=DATA_KW["seed"],
                        help="Data seed (the bands hold at 7).")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on (default: the card).")
    args = parser.parse_args(argv)
    import torch

    if args.device.startswith("cuda"):
        import os

        # full-f32 products, as the JAX CLI's "highest" matmul precision,
        # and deterministic kernels (cuDNN's convolution backward adds
        # with atomics): a protocol is a function of its seeds, as in JAX
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    print(PRECISION.format(torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32,
                           torch.are_deterministic_algorithms_enabled()),
          flush=True)

    failed = []
    for protocol in args.protocols or sorted(PROTOCOL_CARDS):
        draws = []
        for model_seed in MODEL_SEEDS:
            with tempfile.TemporaryDirectory() as tmp:
                draws.append(run_parity_protocol(
                    Path(tmp), protocol, args.seed, args.device, model_seed))
            print(f"{protocol} model seed {model_seed}: "
                  f"{json.dumps(draws[-1])}", flush=True)
        acc, errors = held(protocol, draws)
        print(f"{protocol} medians: {json.dumps(acc)}")
        for key, (lo, hi) in bands(protocol).items():
            ok = lo <= acc[key] <= hi
            print(f"{'OK ' if ok else 'FAIL'} {key}: {acc[key]:.4f} "
                  f"in [{lo}, {hi}]")
        if errors:
            failed.append(protocol)
            print(f"FAIL {protocol}: " + "; ".join(errors))
    print(f"parity gate: {'FAILED ' + ' '.join(failed) if failed else 'OK'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
