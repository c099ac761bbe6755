#!/usr/bin/env python3
"""Result-pickle analysis CLI of the PyTorch port: the commands and
output of ``scripts/results.py`` on ``retrieval/results.py`` of the port.
It reads the result pickles of either package's benchmark CLIs.

Examples:
  python scripts/results_torch.py table   -r results.pkl -k 9
  python scripts/results_torch.py cross   -r results.pkl -n 16 -k 3
  python scripts/results_torch.py report  -r results.pkl -m MODEL -n 16 -k 3 --latex
  python scripts/results_torch.py curves  -r results.pkl -k 9 -o acc_vs_n.png
  python scripts/results_torch.py cm      -r results.pkl -m MODEL -n 16 -k 3 -o cm.png
"""

import argparse
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_plankton_recognition_torch.retrieval import results as R  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["table", "cross", "report",
                                            "curves", "cm"])
    parser.add_argument("-r", "--results", required=True)
    parser.add_argument("-m", "--model", default=None)
    parser.add_argument("-n", type=int, default=16)
    parser.add_argument("-k", type=int, default=3)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--setup", default=None,
                        help="cross-modal setup key, e.g. 'I+P - P'")
    parser.add_argument("--latex", action="store_true")
    args = parser.parse_args(argv)

    with open(args.results, "rb") as f:
        results = pickle.load(f)

    if args.command == "table":
        table = R.accuracy_table(results, args.k, args.setup)
        for model, per_n in table.items():
            print(f"\n== {model} (k={args.k}"
                  + (f", {args.setup}" if args.setup else "") + ") ==")
            print(f"{'n':>6}  {'acc':>16}  {'macro-P':>16}  "
                  f"{'macro-R':>16}  {'macro-F1':>16}")
            for n in sorted(per_n):
                row = per_n[n]
                cells = [f"{row[key][0] * 100:6.2f} ± {row[key][1] * 100:4.2f}"
                         for key in ("acc", "precision", "recall", "f1")]
                print(f"{n:>6}  " + "  ".join(f"{c:>16}" for c in cells))
    elif args.command == "cross":
        table = R.cross_modal_table(results, args.n, args.k)
        setups = sorted({s for t in table.values() for s in t})
        print(f"{'setup':>10}  " + "  ".join(f"{m:>20}" for m in table))
        for s in setups:
            row = [table[m].get(s) for m in table]
            cells = [f"{v[0] * 100:6.2f} ± {v[1] * 100:4.2f}" if v else "-"
                     for v in row]
            print(f"{s:>10}  " + "  ".join(f"{c:>20}" for c in cells))
    elif args.command == "report":
        model = args.model or next(iter(results))
        print(R.classification_report(results, model, args.n, args.k,
                                      args.setup, latex=args.latex))
    elif args.command == "curves":
        out = args.output or "accuracy_vs_n.png"
        R.accuracy_vs_n_figure(results, args.k, Path(out), args.setup)
        print(f"wrote {out}")
    elif args.command == "cm":
        model = args.model or next(iter(results))
        out = args.output or "confusion.png"
        R.confusion_figure(results, model, args.n, args.k, Path(out),
                           args.setup)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
