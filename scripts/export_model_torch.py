#!/usr/bin/env python3
"""Export a port checkpoint to a serving artifact (the CLI of
``scripts/export_model.py`` on the PyTorch port).

``torch.export`` traces the eval-mode inference function, weights held in
the program, once per platform (``model.cuda.pt2``, ``model.cpu.pt2``);
serving (``scripts/serve_torch.py``) needs torch and the port's op
registrations, no model code, card or checkpoint.

  python scripts/export_model_torch.py -c logs/<run>/checkpoints -o artifact/
  python scripts/export_model_torch.py -c ... -o ... --batch-size 256
  python scripts/export_model_torch.py -c ... -o ... --keep-fused
  python scripts/export_model_torch.py -c ... -o ... --gallery emb.pkl -k 9

Smoke-load it back (``--device cpu`` without a card):

  python scripts/export_model_torch.py --load artifact/

An orbax checkpoint of the JAX package is carried over first with
``scripts/checkpoint_from_jax.py``; a JAX artifact cannot be served here.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from multimodal_plankton_recognition_torch.retrieval import (  # noqa: E402
    export as ex,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-c", "--checkpoint", help="checkpoint directory")
    p.add_argument("-o", "--output", help="artifact output directory")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated platforms, each traced on its own "
                        "device (default cuda,cpu; cuda needs a card)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="pin the batch dimension (default: symbolic — one "
                        "artifact serves any batch size)")
    p.add_argument("--keep-fused", action="store_true",
                   help="keep the card's kernel flags: kernels 1, 3, 9 and "
                        "11 stay registered ops of the program (launched "
                        "on the card, their plain versions on the CPU)")
    p.add_argument("--gallery", metavar="EMB_PKL",
                   help="embeddings pickle (scripts/encode_torch.py "
                        "output): hold its fused gallery in the artifact "
                        "and export the end-to-end retrieval classifier "
                        "(pair in -> weighted-kNN class out) instead of "
                        "the raw encoder")
    p.add_argument("--name", help="model name inside the gallery pickle")
    p.add_argument("--fold", type=int, help="fold inside the gallery pickle")
    p.add_argument("-k", type=int, default=9,
                   help="neighbors per modality for --gallery (default 9, "
                        "the reference's best k)")
    p.add_argument("--load", metavar="DIR",
                   help="load an artifact and print its metadata instead of "
                        "exporting")
    p.add_argument("--device", default="cuda",
                   help="device whose program --load loads (default: the "
                        "card)")
    args = p.parse_args(argv)

    if args.load:
        m = ex.load_artifact(args.load, device=args.device)
        print(json.dumps(m.meta, indent=2))
        return
    if not args.checkpoint or not args.output:
        p.error("-c/--checkpoint and -o/--output are required for export")
    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    if args.gallery:
        out = ex.export_retrieval_checkpoint(
            args.checkpoint, args.gallery, args.output, name=args.name,
            fold=args.fold, k=args.k, platforms=platforms,
            batch_size=args.batch_size, keep_fused=args.keep_fused)
    else:
        out = ex.export_checkpoint(
            args.checkpoint, args.output, platforms=platforms,
            batch_size=args.batch_size, keep_fused=args.keep_fused)
    print(f"Exported serving artifact -> {out}")


if __name__ == "__main__":
    main()
