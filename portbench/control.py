"""Readings that set the limits of ``correct``, on the card, at a cell's
own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3 4 5] [--fault-seeds 6 7 8] [--window 2]

For each of ``--seeds``: one run of the cell's timed path with a short
window, in this process (set-up, check steps, window, the reference and
the compared numbers, as ``run.py`` makes them), printed as a
``program`` line: the lower readings. For each of ``--control-seeds``:
the reference at float8 in the program's place (``control``), and for a
train cell the reference on half of each batch (``half_batch``, a fault
the numbers must catch): the upper readings. For each of ``--fault-seeds`` of a train cell: the
timed path run again with each dropout fault of ``harness/taps.py``
planted in the program (``fault:<kind>``), the upper readings of the
dropout numbers. One JSON object a line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--window", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.manifest import driver, load_manifest, resolve
    from portbench.harness.taps import FAULTS, plant_fault
    from portbench.reference.precision import FP8
    from portbench.run import _environment

    _environment()
    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = resolve(args.workload, load_manifest(ROOT), ROOT)
    drv = driver(cell.traffic["driver"])
    for seed in args.seeds:
        out = drv.run(cell, seed=seed, seconds=args.window, trace=False,
                      device=device, t0=time.perf_counter())
        print(json.dumps({"reading": "program", "seed": seed,
                          "failed": out.failed, **out.numbers}), flush=True)
    for seed in args.control_seeds:
        print(json.dumps({"reading": "control", "seed": seed,
                          **drv.control_numbers(cell, seed, device, FP8)}),
              flush=True)
        if cell.traffic["driver"] == "train_closed_loop":
            rows = cell.traffic["batch"] // 2
            print(json.dumps({"reading": "half_batch", "seed": seed,
                              **drv.control_numbers(cell, seed, device,
                                                    rows=rows)}),
                  flush=True)
    for seed in args.fault_seeds:
        for kind in FAULTS:
            undo = plant_fault(kind)
            try:
                out = drv.run(cell, seed=seed, seconds=args.window,
                              trace=False, device=device,
                              t0=time.perf_counter())
            finally:
                undo()
            print(json.dumps({"reading": f"fault:{kind}", "seed": seed,
                              "failed": out.failed, **out.numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
