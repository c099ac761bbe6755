#!/usr/bin/env python3
"""Fused-gallery retrieval benchmark, in-pool sampling, on the PyTorch port: the CLI, constants and result-pickle
schema of ``scripts/benchmark_raw.py``, plus ``--device`` (default: the
card; without one it raises unless ``--device cpu`` is given).

    python scripts/benchmark_raw_torch.py -e embeddings.pkl -o results.pkl
"""

import argparse
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_plankton_recognition_torch.parallel import (  # noqa: E402
    multihost,
)
from multimodal_plankton_recognition_torch.retrieval.benchmark import (  # noqa: E402
    run_suite,
)

N = (4, 8, 12, 16, 32, 64, 128, 256)
K = (1, 3, 9, 15, 31, 51)
TH = 20
REPEATS = 20


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-e", "--embeddings",
                        help="Location to pickled embeddings.")
    parser.add_argument("-o", "--output", help="Path to pickled result data")
    parser.add_argument("--repeats", type=int, default=REPEATS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threshold", type=int, default=TH)
    parser.add_argument("--sharded", action="store_true",
                        help="Row-shard galleries over the ranks (under "
                             "torchrun --nproc_per_node N; one rank "
                             "without it); rank 0 writes the output")
    parser.add_argument("--device", default="cuda",
                        help="Device of the kNN index (default: the card).")
    args = parser.parse_args(argv)

    multihost.initialize(device=args.device)
    try:
        with open(args.embeddings, "rb") as buf:
            embeddings = pickle.load(buf)

        results = run_suite(embeddings, mode="raw", N=N, K=K,
                            repeats=args.repeats, th=args.threshold,
                            seed=args.seed, progress=True,
                            sharded=args.sharded, device=args.device)
        if multihost.process_index() == 0:
            with open(args.output, "wb") as buf:
                pickle.dump(results, buf)
    finally:
        multihost.shutdown()
    return results


if __name__ == "__main__":
    main()
