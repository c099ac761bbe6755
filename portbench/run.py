"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the measured package ``multimodal_plankton_recognition_torch``. The
last line of standard output is the result (JSON); the last lines of
standard error are the numbers that decide ``correct`` beside their
limits. Exits 2 without a CUDA card for each chip the cell asks for, 3
if the run imported JAX or the JAX package.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; libraries that could
    load JAX by themselves kept from it."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from portbench.harness.runner import run_cell

    return run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
