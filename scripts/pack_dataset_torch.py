#!/usr/bin/env python3
"""Write the packed input cache of a dataset's split CSVs with the PyTorch
port (``data/packed.py``'s ``pack_split``): the CLI, flags and output lines
of ``scripts/pack_dataset.py``, with no JAX. The cache is the JAX
package's, byte for byte.

The cache holds the deterministic prefix of the train and eval transforms
(decoded and resized uint8 images, resampled f32 profiles), so train-time
loaders replay only the cheap random suffix. A card reads it with
``packed_cache: true``.

    python scripts/pack_dataset_torch.py -d <dataset_dir> -t 224 \\
        [--splits train.csv test.csv]

Packing decodes JPEGs and reads CSVs, so it needs PIL and pandas.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_plankton_recognition_torch.data.packed import (  # noqa: E402
    pack_split,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", required=True,
                   help="Dataset directory holding the split CSVs.")
    p.add_argument("-t", "--target-size", type=int, default=224,
                   help="Card target_size the cache is built for.")
    p.add_argument("--splits", nargs="*", default=["train.csv", "test.csv"],
                   help="Split CSVs to pack (default: train.csv test.csv).")
    args = p.parse_args(argv)
    root = Path(args.dataset)
    for split in args.splits:
        csv = root / split
        if not csv.exists():
            print(f"skip {csv}: not found")
            continue
        t0 = time.perf_counter()
        out = pack_split(csv, args.target_size)
        n = sum(f.stat().st_size for f in out.iterdir())
        print(f"packed {csv} -> {out} "
              f"({n / 1e6:.1f} MB, {time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    main()
