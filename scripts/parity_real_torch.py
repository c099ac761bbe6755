#!/usr/bin/env python3
"""One-command real-data parity harness of the PyTorch port: the pipeline,
tables, report and exit codes of ``scripts/parity_real.py``, on the port's
``train_multi``, ``encode_split``, ``run_suite``, ``accuracy_table`` and
``cross_modal_table``, with ``--device`` (default: the card).

    python scripts/parity_real_torch.py --data /path/to/CS_103_Uto2024 \\
        [--weights-b0 b0.npz --weights-vit vit.npz] [--folds 2] \\
        [--tolerance 2.0] [-o parity_report.json] [--device cpu]

Pipeline (the reference's experiments.ipynb cells 4-24): the dataset's
``annotations.csv`` (else a pointer to ``datagen/``) -> ``--n-folds``
stratified folds by ``scripts/split_kfold.py`` (scikit-learn; where it is
absent, write ``<data>/<split-name>{1..k}/{train,test}.csv`` first and
the harness takes them) -> the two CLIP flagship cards trained on each
fold (the four cell-12 cards with ``--all-cards``) -> train and test
splits encoded -> the cell-12 protocol (fused I+P gallery, n 256 a
class, k 9, ``folds`` mode) and the cell-22 protocol (n 16, k 3, the 8
cross-modal setups, ``cross_folds`` mode) -> the accuracy tables against
the reference's saved values within ``--tolerance`` percentage points.
``--weights-b0`` / ``--weights-vit`` wire converted ImageNet weights
(``scripts/convert_timm_torch.py``, with ``--prefix <arch>/backbone``)
into the cards as ``pretrained: true``.

``--dry-run`` runs every stage on a synthetic corpus with a tiny card
and writes the report, without the tolerance check: synthetic accuracies
have nothing to do with the reference's.

Exit codes: 0 parity held (or the dry run's plumbing did), 1 a cell
outside the tolerance, 2 bad arguments.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# ---- reference expectations (BASELINE.md; experiments.ipynb cells 12/22) --
#: fused-gallery kNN accuracy, n=256/class, k=9 (cell 12), percent
CELL12_FUSED_ACC = {
    "efficientnet_b0_cnn_2_512_clip": 96.20,
    "efficientnet_b0_cnn_2_512_siglip": 96.03,
    "vit_t_16_transformer_2_512_clip": 95.99,
    "vit_t_16_transformer_2_512_siglip": 95.93,
}
#: cross-modal accuracy, n=16, k=3 (cell 22), percent, per setup
CELL22_CROSS_ACC = {
    "efficientnet_b0_cnn_2_512_clip": {
        "I - I": 72.54, "I - P": 15.62, "I - I+P": 71.35, "P - I": 14.41,
        "P - P": 86.27, "P - I+P": 85.74, "I+P - I": 72.32, "I+P - P": 86.16,
    },
    "efficientnet_b0_cnn_2_512_siglip": {
        "I - I": 71.88, "I - P": 14.81, "I - I+P": 70.79, "P - I": 16.30,
        "P - P": 86.18, "P - I+P": 85.89, "I+P - I": 71.70, "I+P - P": 85.99,
    },
    "vit_t_16_transformer_2_512_clip": {
        "I - I": 67.13, "I - P": 15.05, "I - I+P": 65.84, "P - I": 15.37,
        "P - P": 88.78, "P - I+P": 88.81, "I+P - I": 66.92, "I+P - P": 88.60,
    },
    "vit_t_16_transformer_2_512_siglip": {
        "I - I": 64.56, "I - P": 16.28, "I - I+P": 63.40, "P - I": 14.67,
        "P - P": 89.09, "P - I+P": 89.03, "I+P - I": 64.41, "I+P - P": 88.94,
    },
}
FLAGSHIP_CARDS = ("efficientnet_b0_cnn_2_512_clip",
                  "vit_t_16_transformer_2_512_clip")
ALL_CARDS = tuple(CELL12_FUSED_ACC)

REPO = Path(__file__).resolve().parent.parent

#: tiny dry-run protocol (plumbing only)
DRY_CARD = {
    "bs": 4, "dim_embedding": 16, "target_size": 32, "buckets": 2,
    "num_workers": 1, "patience": 9, "save_top_k": 1,
    "image_encoder_args": {"name": "resnet18", "metadata": True},
    "profile_encoder_args": {"kind": "cnn", "dim_in": 6,
                             "blocks": [1, 1, 1, 1], "base_channels": 8},
    "coordination_args": {"method": "clip"},
    "optim_args": {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4,
                   "nesterov": True},
    "trainer_args": {"precision": "32", "min_epochs": 2, "max_epochs": 2},
}
#: the dry run's synthetic corpus (``make_synthetic_dataset`` arguments)
DRY_DATA = dict(n_classes=3, n_per_class=10, seed=1, with_split=False)


def _prepare_card(name: str, args, workdir: Path) -> Path:
    """The shipped card ``name`` as a JSON card in ``workdir``, with the
    converted ImageNet weights wired in when given (the reference's
    parity anchor: src/image_encoder.py:16-17 hard-codes
    pretrained=True)."""
    import yaml

    card = yaml.safe_load((REPO / "model_cards" / "multi"
                           / f"{name}.yaml").read_text())
    weights = args.weights_vit if name.startswith("vit") else args.weights_b0
    if weights:
        card["image_encoder_args"]["pretrained"] = True
        card["image_encoder_args"]["pretrained_path"] = str(
            Path(weights).resolve())
    if args.max_epochs:
        card["trainer_args"]["max_epochs"] = args.max_epochs
        card["trainer_args"]["min_epochs"] = min(
            card["trainer_args"].get("min_epochs", 1), args.max_epochs)
    out = workdir / f"{name}.json"
    out.write_text(json.dumps(card))
    return out


def _ensure_dataset(args) -> Path:
    data = Path(args.data)
    if not (data / "annotations.csv").exists():
        sys.exit(
            f"{data}/annotations.csv missing — run the matching offline "
            "preprocess first, e.g.\n  python datagen/preprocess_uto2024.py "
            f"--root {data}\n(see datagen/ for CytoSense / FASTVISION-plus "
            "variants)")
    fold1 = data / f"{args.split_name}1"
    if not (fold1 / "train.csv").exists():
        print(f"== split_kfold: {args.n_folds} folds", flush=True)
        subprocess.run(
            [sys.executable, str(REPO / "scripts" / "split_kfold.py"),
             "-d", str(data), "-k", str(args.n_folds),
             "-n", args.split_name, "-s", "0"],
            check=True)
    return data


def _train_encode(card_path: Path, data: Path, folds, workdir: Path,
                  args) -> dict:
    """Train on each fold and encode its train and test splits: the
    nested embeddings entry {fold: {train, test, classes}} (the encode
    CLI's ``--train-test`` layout)."""
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_split,
    )
    from multimodal_plankton_recognition_torch.train.drivers import (
        train_multi,
    )

    entry = {}
    for fold in folds:
        fold_dir = data / f"{args.split_name}{fold}"
        print(f"== train {card_path.stem} fold {fold}", flush=True)
        result = train_multi(fold_dir, card_path,
                             logdir=workdir / "logs" / f"fold{fold}",
                             device=args.device)
        print(f"   final train_loss "
              f"{result['history'][-1]['train_loss']:.4f}", flush=True)
        entry[fold] = encode_split(f"{result['logdir']}/checkpoints",
                                   fold_dir, batch_size=args.batch_size,
                                   num_workers=args.num_workers,
                                   device=args.device)
    return entry


def _diff(measured: float, expected: float, tol: float, label: str,
          failures: list) -> dict:
    delta = measured - expected
    ok = abs(delta) <= tol
    if not ok:
        failures.append(f"{label}: {measured:.2f}% vs reference "
                        f"{expected:.2f}% (|Δ|={abs(delta):.2f} > {tol})")
    return {"measured_pct": round(measured, 2),
            "reference_pct": expected, "delta_pct": round(delta, 2),
            "within_tolerance": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", help="dataset root (with annotations.csv)")
    ap.add_argument("--weights-b0", help="converted timm efficientnet_b0 npz "
                    "(scripts/convert_timm_torch.py --prefix "
                    "efficientnet_b0/backbone)")
    ap.add_argument("--weights-vit", help="converted vit_tiny npz "
                    "(--prefix vit_tiny_patch16_224/backbone)")
    ap.add_argument("--all-cards", action="store_true",
                    help="all four cell-12 cards instead of the two CLIP "
                    "flagships")
    ap.add_argument("--folds", type=int, default=2,
                    help="how many folds to train (reference used 5)")
    ap.add_argument("--n-folds", type=int, default=5)
    ap.add_argument("--split-name", default="fold")
    ap.add_argument("--tolerance", type=float, default=2.0,
                    help="max |accuracy delta| in percentage points")
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--workdir", default="parity_real_work")
    ap.add_argument("-o", "--output", default="parity_report.json")
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic corpus + tiny card: prove the plumbing "
                    "without real data/weights (no tolerance gate)")
    ap.add_argument("--device", default="cuda",
                    help="device to train, encode and benchmark on "
                    "(default: the card)")
    args = ap.parse_args(argv)

    from multimodal_plankton_recognition_torch.retrieval.benchmark import (
        run_suite,
    )
    from multimodal_plankton_recognition_torch.retrieval.results import (
        accuracy_table, cross_modal_table,
    )

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    if args.dry_run:
        from multimodal_plankton_recognition_torch.data.synthetic import (
            make_synthetic_dataset,
        )
        print("== DRY RUN: synthetic stand-in corpus", flush=True)
        args.data = workdir / "data"
        if not (Path(args.data) / "annotations.csv").exists():
            make_synthetic_dataset(args.data, **DRY_DATA)
        args.n_folds = 2
        cards = {"dry_flagship": None}
        raw_n, raw_k, cross_n, cross_k, repeats, th = 4, 3, 2, 1, 2, 1
    elif not args.data:
        ap.error("--data is required (or --dry-run)")
    else:
        cards = {c: None for c in (ALL_CARDS if args.all_cards
                                   else FLAGSHIP_CARDS)}
        raw_n, raw_k, cross_n, cross_k, repeats, th = 256, 9, 16, 3, 10, 20

    # Validate up front: folds beyond the split count would otherwise train
    # the earlier folds for hours and die on fold{N}/train.csv at the end.
    if args.folds > args.n_folds:
        if args.dry_run:
            args.folds = args.n_folds  # dry-run forces n_folds=2 above
        else:
            ap.error(f"--folds {args.folds} exceeds --n-folds {args.n_folds}")
    if args.folds < 1:
        ap.error("--folds must be >= 1")

    data = _ensure_dataset(args)
    folds = list(range(1, args.folds + 1))

    embeddings = {}
    for name in cards:
        if args.dry_run:
            card_path = workdir / "dry_flagship.json"
            card_path.write_text(json.dumps(DRY_CARD))
        else:
            card_path = _prepare_card(name, args, workdir)
        embeddings[name] = _train_encode(card_path, data, folds, workdir,
                                         args)

    print("== benchmark_raw (cell-12 protocol)", flush=True)
    raw = run_suite(embeddings, mode="folds", N=(raw_n,), K=(raw_k,),
                    repeats=repeats, th=th, seed=0, device=args.device)
    fused = accuracy_table(raw, k=raw_k)
    print("== benchmark_cross (cell-22 protocol)", flush=True)
    cross = run_suite(embeddings, mode="cross_folds", N=(cross_n,),
                      K=(cross_k,), repeats=repeats, th=th, seed=0,
                      device=args.device)
    xtab = cross_modal_table(cross, n=cross_n, k=cross_k)

    report = {"args": {k: str(v) for k, v in vars(args).items()},
              "fused_gallery": {}, "cross_modal": {}, "failures": []}
    failures = report["failures"]
    for name in cards:
        acc_mean, acc_std = fused[name][raw_n]["acc"]
        row = {"acc_pct": round(acc_mean * 100, 2),
               "std_pct": round(acc_std * 100, 2)}
        if not args.dry_run and name in CELL12_FUSED_ACC:
            row["vs_reference"] = _diff(acc_mean * 100,
                                        CELL12_FUSED_ACC[name],
                                        args.tolerance,
                                        f"fused {name}", failures)
        report["fused_gallery"][name] = row
        xrow = {}
        for setup, (m, s) in xtab[name].items():
            cell = {"acc_pct": round(m * 100, 2), "std_pct": round(s * 100, 2)}
            if not args.dry_run and name in CELL22_CROSS_ACC:
                cell["vs_reference"] = _diff(m * 100,
                                             CELL22_CROSS_ACC[name][setup],
                                             args.tolerance,
                                             f"cross {name} {setup}",
                                             failures)
            xrow[setup] = cell
        report["cross_modal"][name] = xrow

    Path(args.output).write_text(json.dumps(report, indent=2))
    print(f"report -> {args.output}")
    for name, row in report["fused_gallery"].items():
        print(f"  fused {name}: {row['acc_pct']:.2f}% "
              f"± {row['std_pct']:.2f}")
    if args.dry_run:
        # plumbing gate: every stage produced output with all 8 setups
        if not all(len(x) == 8 for x in report["cross_modal"].values()):
            sys.exit(f"DRY-RUN: cross-modal setups missing: "
                     f"{report['cross_modal']}")
        print("DRY-RUN PLUMBING OK (tolerance gate skipped — synthetic "
              "corpus)")
        return report
    if failures:
        print("PARITY FAILURES:")
        for f in failures:
            print("  " + f)
        sys.exit(1)
    print(f"PARITY OK within ±{args.tolerance} points "
          f"({len(cards)} cards × {len(folds)} folds)")
    return report


if __name__ == "__main__":
    main()
