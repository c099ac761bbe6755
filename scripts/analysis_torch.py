#!/usr/bin/env python3
"""Dataset analysis CLI of the PyTorch port (``scripts/analysis.py``'s five
subcommands on the port's profile reader, transforms and PaCMAP), replacing
the reference's analysis notebook
(reference: analysis.ipynb: class histograms/overlap (cells 3-4), sample
visualization (cells 6-8), derivation of the normalization constants
hard-coded in the transforms (cells 12-17), augmentation sanity checks
(cell 18)) and the embedding-space visualization of experiments.ipynb
(cells 26-30: t-SNE / PCA projections).

pandas, PIL, matplotlib and sklearn are imported inside the
subcommands that use them; ``embed --method pacmap`` runs PaCMAP's
optimisation on ``--device`` (default: the card).

Examples:
  python scripts/analysis_torch.py stats   -d data/CytoSense
  python scripts/analysis_torch.py norms   -d data/CytoSense [-d data/other]
  python scripts/analysis_torch.py samples -d data/CytoSense -o samples.png
  python scripts/analysis_torch.py augment -d data/CytoSense -o augment.png
  python scripts/analysis_torch.py embed   -e emb.pkl -o tsne.png [--method pca]
  python scripts/analysis_torch.py embed   -e emb.pkl -o p.png --method pacmap
"""

import argparse
import pickle
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def cmd_stats(dirs) -> None:
    """Class histograms + cross-dataset class overlap (analysis.ipynb 3-4)."""
    import pandas as pd

    tables = {}
    for d in dirs:
        annot = pd.read_csv(Path(d) / "annotations.csv")
        counts = annot["class"].value_counts().sort_index()
        tables[Path(d).name] = counts
        print(f"\n== {d}: {len(annot)} pairs, {len(counts)} classes ==")
        for cls, cnt in counts.items():
            print(f"  {cls:<40} {cnt}")
    if len(tables) > 1:
        names = list(tables)
        shared = set(tables[names[0]].index)
        for n in names[1:]:
            shared &= set(tables[n].index)
        print(f"\nshared classes across {names}: {sorted(shared)}")


def cmd_norms(dirs) -> None:
    """Derive the transform normalization constants (analysis.ipynb 12-17):
    per-channel log1p ceilings (-> ProfileTransformTrain divisors), profile
    log mean/std, image mean/std after [0,1] scaling."""
    import pandas as pd
    from PIL import Image

    from multimodal_plankton_recognition_torch.data.profile_io import (
        load_profile_csv,
    )

    log_max = None
    log_sum = None
    log_sumsq = None
    n_rows = 0
    img_sum = img_sumsq = 0.0
    n_pix = 0
    for d in dirs:
        root = Path(d)
        annot = pd.read_csv(root / "annotations.csv")
        for _, row in annot.iterrows():
            prof = np.log1p(load_profile_csv(root / row["profile"]))
            if prof.size == 0:
                continue
            m = prof.max(axis=0)
            log_max = m if log_max is None else np.maximum(log_max, m)
            s = prof.sum(axis=0)
            log_sum = s if log_sum is None else log_sum + s
            q = (prof ** 2).sum(axis=0)
            log_sumsq = q if log_sumsq is None else log_sumsq + q
            n_rows += prof.shape[0]
            img = np.asarray(Image.open(root / row["image"]).convert("L"),
                             dtype=np.float64) / 255.0
            img_sum += img.sum()
            img_sumsq += (img ** 2).sum()
            n_pix += img.size
    mean = log_sum / n_rows
    std = np.sqrt(log_sumsq / n_rows - mean ** 2)
    print("profile log1p ceilings (ProfileTransformTrain divisors):")
    print("  ", np.round(log_max, 4).tolist())
    print("profile log1p mean:", np.round(mean, 3).tolist())
    print("profile log1p std: ", np.round(std, 3).tolist())
    print(f"image mean/std ([0,1] scale): {img_sum / n_pix:.4f} / "
          f"{np.sqrt(img_sumsq / n_pix - (img_sum / n_pix) ** 2):.4f}")


def _load_pairs(d, k=4):
    import pandas as pd
    from PIL import Image

    from multimodal_plankton_recognition_torch.data.profile_io import (
        load_profile_csv,
    )

    root = Path(d)
    annot = pd.read_csv(root / "annotations.csv")
    picks = annot.groupby("class").head(1).head(k)
    out = []
    for _, row in picks.iterrows():
        img = np.asarray(Image.open(root / row["image"]).convert("L"))
        prof = load_profile_csv(root / row["profile"])
        out.append((row["class"], img, prof))
    return out


def cmd_samples(dirs, out) -> None:
    """Raw image + profile pair visualization (analysis.ipynb 6-7)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pairs = _load_pairs(dirs[0])
    fig, axes = plt.subplots(2, len(pairs), figsize=(4 * len(pairs), 6))
    if len(pairs) == 1:
        axes = axes.reshape(2, 1)
    for i, (cls, img, prof) in enumerate(pairs):
        axes[0, i].imshow(img, cmap="gray")
        axes[0, i].set_title(cls, fontsize=9)
        axes[0, i].axis("off")
        axes[1, i].plot(np.log1p(prof))
        axes[1, i].set_xlabel("time")
    fig.savefig(out, bbox_inches="tight", dpi=130)
    print(f"wrote {out}")


def cmd_augment(dirs, out) -> None:
    """Augmentation sanity visualization (analysis.ipynb 18): the same
    sample through the train transforms with different seeds."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    from PIL import Image

    from multimodal_plankton_recognition_torch.data.profile_io import (
        load_profile_csv,
    )
    from multimodal_plankton_recognition_torch.data.transforms import (
        ImageTransformTrain, PairAugmentation, ProfileTransformTrain,
    )

    root = Path(dirs[0])
    annot = pd.read_csv(root / "annotations.csv")
    row = annot.iloc[0]
    img = Image.open(root / row["image"])
    prof = load_profile_csv(root / row["profile"])

    tf_i, tf_p, aug = ImageTransformTrain(224), ProfileTransformTrain(224), \
        PairAugmentation()
    fig, axes = plt.subplots(2, 4, figsize=(16, 6))
    for i in range(4):
        rng = np.random.default_rng(i)
        x = tf_i(img, rng)
        p = tf_p(prof, rng)
        x, p = aug(x, p, rng)
        axes[0, i].imshow(x[..., 0], cmap="gray", vmin=-1, vmax=1)
        axes[0, i].set_title(f"seed {i}")
        axes[0, i].axis("off")
        axes[1, i].plot(p)
    fig.savefig(out, bbox_inches="tight", dpi=130)
    print(f"wrote {out}")


def cmd_embed(emb_path, out, method="tsne", fold=None,
              device="cuda") -> None:
    """Embedding-space projection colored by class (experiments.ipynb 26-30)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(emb_path, "rb") as f:
        embeddings = pickle.load(f)
    model = next(iter(embeddings))
    folds = embeddings[model]
    fold = fold if fold is not None else next(iter(folds))
    entry = folds[fold]
    if "image" not in entry:  # nested layout
        entry = entry["test"]
    X = np.concatenate([entry["image"], entry["profile"]], axis=0)
    modality = np.array(["image"] * len(entry["image"])
                        + ["profile"] * len(entry["profile"]))
    labels = np.concatenate([entry["label"], entry["label"]])

    if method == "pca":
        X = X - X.mean(0)
        _, _, vt = np.linalg.svd(X, full_matrices=False)
        proj = X @ vt[:2].T
    elif method == "pacmap":
        from multimodal_plankton_recognition_torch.ops.pacmap import pacmap
        proj = pacmap(X, n_components=2, seed=0, device=device)
    else:
        from sklearn.manifold import TSNE
        proj = TSNE(n_components=2, random_state=0,
                    perplexity=min(30, len(X) - 1)).fit_transform(X)

    classes = np.unique(labels)
    fig, ax = plt.subplots(figsize=(8, 8))
    cmap = plt.get_cmap("tab20")
    for i, cls in enumerate(classes):
        for mod, marker in (("image", "o"), ("profile", "^")):
            sel = (labels == cls) & (modality == mod)
            ax.scatter(proj[sel, 0], proj[sel, 1], s=12, marker=marker,
                       color=cmap(i % 20),
                       label=f"{cls} ({mod})" if len(classes) <= 10 else None)
    if len(classes) <= 10:
        ax.legend(fontsize=7, markerscale=1.5)
    ax.set_title(f"{model} fold {fold} ({method})")
    fig.savefig(out, bbox_inches="tight", dpi=150)
    print(f"wrote {out}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["stats", "norms", "samples",
                                            "augment", "embed"])
    parser.add_argument("-d", "--dataset", action="append", default=[])
    parser.add_argument("-e", "--embeddings", default=None)
    parser.add_argument("-o", "--output", default="analysis.png")
    parser.add_argument("--method", default="tsne",
                        choices=["tsne", "pca", "pacmap"])
    parser.add_argument("--fold", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="device of embed --method pacmap (default: the "
                             "card)")
    args = parser.parse_args(argv)

    if args.command == "stats":
        cmd_stats(args.dataset)
    elif args.command == "norms":
        cmd_norms(args.dataset)
    elif args.command == "samples":
        cmd_samples(args.dataset, args.output)
    elif args.command == "augment":
        cmd_augment(args.dataset, args.output)
    elif args.command == "embed":
        cmd_embed(args.embeddings, args.output, args.method, args.fold,
                  args.device)


if __name__ == "__main__":
    main()
