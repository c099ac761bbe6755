#!/usr/bin/env python3
"""Embedding export CLI of the PyTorch port: a port checkpoint -> the
pickle layouts of ``scripts/encode.py``, which the retrieval benchmarks
consume unchanged. Runs on the card unless ``--device cpu`` is given.

Examples:
  # flat layout (for benchmark_raw / benchmark_cross)
  python scripts/encode_torch.py -k logs/run/version_0/checkpoints \\
      -d data/ds/fold1/test.csv -o emb.pkl --name vit_clip --fold 1

  # nested train/test layout (for benchmark_folds / benchmark_cross_folds)
  python scripts/encode_torch.py -k logs/run/version_0/checkpoints \\
      -d data/ds/fold1 --train-test -o emb.pkl --name vit_clip --fold 1

  # a supervised classifier's logits and labels (JAX's --logits entry)
  python scripts/encode_torch.py -k logs/run/version_0/checkpoints \\
      -d data/ds/fold1/test.csv --logits -o logits.pkl --name vit_t

Repeated invocations with --append build multi-model/fold pickles. An
orbax checkpoint of the JAX package is carried over first with
``scripts/checkpoint_from_jax.py``.
"""

import argparse
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_plankton_recognition_torch.retrieval.encode import (  # noqa: E402
    encode_dataset, encode_split, predict_classifier,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-k", "--checkpoint", required=True,
                        help="Checkpoint directory of the port (with "
                             "plankton metadata).")
    parser.add_argument("-d", "--data", required=True,
                        help="Annotations csv (flat) or dataset dir with "
                             "train.csv/test.csv (--train-test).")
    parser.add_argument("-o", "--output", required=True,
                        help="Output pickle path.")
    parser.add_argument("--name", default="model",
                        help="Model key in the pickle.")
    parser.add_argument("--fold", type=int, default=1,
                        help="Fold key in the pickle.")
    parser.add_argument("--train-test", action="store_true",
                        help="Encode train.csv and test.csv (nested layout).")
    parser.add_argument("--logits", action="store_true",
                        help="Classifier checkpoint: export logits+labels "
                             "instead of embeddings.")
    parser.add_argument("--append", action="store_true",
                        help="Merge into an existing pickle.")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="Device to encode on (default: the card).")
    args = parser.parse_args(argv)

    if args.logits:
        encode = predict_classifier
    else:
        encode = encode_split if args.train_test else encode_dataset
    entry = encode(args.checkpoint, args.data, args.batch_size,
                   args.num_workers, device=args.device)

    out_path = Path(args.output)
    embeddings = {}
    if args.append and out_path.exists():
        with open(out_path, "rb") as f:
            embeddings = pickle.load(f)
    embeddings.setdefault(args.name, {})[args.fold] = entry
    with open(out_path, "wb") as f:
        pickle.dump(embeddings, f)
    n = len(entry["train"]["label"]) + len(entry["test"]["label"]) \
        if args.train_test else len(entry["label"])
    print(f"Wrote {args.name}/fold{args.fold} ({n} samples) to {out_path}")


if __name__ == "__main__":
    main()
