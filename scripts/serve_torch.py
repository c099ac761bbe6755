#!/usr/bin/env python3
"""Batch inference with a serving artifact of the PyTorch port
(``scripts/export_model_torch.py`` output): the CLI of ``scripts/serve.py``
plus ``--device`` (default: the card; without one it raises unless
``--device cpu`` is given).

Loads the artifact's program for the device and runs it over an
annotations CSV through the port's eval input pipeline (pandas and PIL,
as ``encode_csv``):

  # retrieval-classifier artifact -> per-sample class predictions
  python scripts/serve_torch.py -a artifact/ -d data/fold1/test.csv -o pred.csv

  # encoder artifact -> embeddings pickle (flat layout, like encode_torch.py)
  python scripts/serve_torch.py -a artifact/ -d data/fold1/test.csv -o emb.pkl

The CSV needs ``image, profile`` columns; a ``class`` column is optional
(predictions CSVs then omit ``true`` and no accuracy is printed). Output
format follows the artifact kind: ``retrieval`` and classifier kinds write
a CSV with columns ``image, profile[, true], pred``; ``multi`` writes the
encode-CLI pickle layout ``{name: {fold: {image, profile, label,
classes}}}``. Artifacts exported with a pinned ``--batch-size`` are served
at that size, with the trailing partial batch padded and the padding
dropped from the outputs.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _pad_rows(batch, to):
    """Pad every array's leading dim to ``to`` rows by repeating the last
    row (fixed-shape artifacts; padding rows are dropped from outputs)."""
    import numpy as np

    out = {}
    for k, v in batch.items():
        short = to - v.shape[0]
        out[k] = np.concatenate([v, np.repeat(v[-1:], short, axis=0)]) \
            if short else v
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--artifact", required=True,
                   help="serving artifact directory")
    p.add_argument("-d", "--data", required=True,
                   help="annotations/split CSV to classify or embed")
    p.add_argument("-o", "--output", required=True,
                   help="predictions CSV (classifier kinds) or embeddings "
                        "pickle (multi)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="rows per call (overridden by an artifact's pinned "
                        "batch size)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--name", default="serve",
                   help="model name key for the embeddings pickle layout")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="device to serve on (default: the card)")
    args = p.parse_args(argv)

    import numpy as np
    import pandas as pd

    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.data.dataset import MultiSet
    from multimodal_plankton_recognition_torch.data.pipeline import (
        Loader, multi_collate_fn,
    )
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        eval_pipeline,
    )
    from multimodal_plankton_recognition_torch.retrieval.export import (
        load_artifact,
    )

    serving = load_artifact(args.artifact, device=args.device)
    kind = serving.meta["kind"]
    if kind not in ("multi", "retrieval", "image", "profile"):
        raise SystemExit(f"Unknown artifact kind {kind!r} (artifact "
                         f"metadata: {args.artifact})")
    card = ModelCard.from_dict(serving.meta["card"])
    batch_size = args.batch_size
    pinned = serving.meta.get("batch_size")
    if isinstance(pinned, int):
        if batch_size != pinned:
            print(f"artifact pins batch_size={pinned}; serving at that size")
        batch_size = pinned

    # the shared eval-side pipeline rules (retrieval/encode.eval_pipeline)
    # guarantee the batch matches what the artifact was traced with
    image_tf, profile_tf, tok = eval_pipeline(card, kind)
    dataset = MultiSet(args.data, image_tf, profile_tf)
    loader = Loader(dataset, batch_size, multi_collate_fn(tok),
                    shuffle=False, drop_last=False,
                    num_workers=args.num_workers)
    wanted = set(serving.meta["input_spec"])

    outs, rows = [], 0
    for batch in loader:
        batch = {k: np.asarray(v) for k, v in batch.items() if k in wanted}
        n = next(iter(batch.values())).shape[0]
        if isinstance(pinned, int) and n < pinned:
            batch = _pad_rows(batch, pinned)
        out = serving.call(batch)
        outs.append({k: v[:n] for k, v in out.items()})
        rows += n
    assert rows == len(dataset)

    table = dataset.table
    has_labels = "class" in pd.read_csv(args.data, nrows=0).columns
    if kind in ("retrieval", "image", "profile"):
        if kind == "retrieval":
            ids = np.concatenate([o["class_id"] for o in outs])
        else:
            ids = np.concatenate([o["logits"] for o in outs]).argmax(axis=1)
        pred = serving.classes[ids]
        out = table[["image", "profile"]].copy()
        if has_labels:
            out["true"] = table["class"].to_numpy()
        out["pred"] = pred
        out.to_csv(args.output, index=False)
        if has_labels:
            true = table["class"].to_numpy()
            known = np.isin(true, serving.classes)
            if known.any():
                acc = float((pred[known] == true[known]).mean())
                print(f"accuracy {acc:.4f} over {int(known.sum())} labeled "
                      f"samples ({len(true) - int(known.sum())} with labels "
                      f"outside the artifact's classes)")
        print(f"Predictions -> {args.output}")
    else:  # multi: embeddings pickle, encode-CLI layout
        import pickle

        entry = {
            "image": np.concatenate([o["image_emb"] for o in outs])
            .astype(np.float32),
            "profile": np.concatenate([o["profile_emb"] for o in outs])
            .astype(np.float32),
            "label": table["class"].to_numpy(),
            "classes": serving.classes,
        }
        with open(args.output, "wb") as f:
            pickle.dump({args.name: {args.fold: entry}}, f)
        print(f"Embeddings ({entry['image'].shape[0]} pairs) -> "
              f"{args.output}")


if __name__ == "__main__":
    main()
