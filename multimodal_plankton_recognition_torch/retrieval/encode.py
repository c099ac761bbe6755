"""Embedding export: pairs -> L2-normalized embeddings
(``retrieval/encode.py`` of the JAX package).

Batched eval-mode ``MultiModel.encode`` followed by ``l2_normalize``. The
pickle layouts are the JAX package's, which its retrieval benchmarks
consume unchanged:

  flat:   {image, profile, label[, classes]}   (f32 numpy embeddings)
  nested: {train: {...}, test: {...}, classes}

* ``encode_arrays`` takes in-memory arrays (numpy or tensors): the entry
  point of runs on the card, which need nothing beyond torch and numpy
  (a packed split, ``data.packed``, gives such arrays).
* ``encode_csv`` reads an annotations CSV through the port's own host
  layers (``data.dataset``, ``data.transforms``, ``data.pipeline``), which
  import pandas and PIL only when called.
* ``encode_dataset`` (flat) and ``encode_split`` (nested) load a
  checkpoint (``train.checkpoint.load_from_checkpoint``) and encode CSVs
  with ``eval_pipeline``, ``classes`` from the checkpoint's metadata.

All run on the card unless the caller passes ``device="cpu"``; without a
card the default raises (``ops.knn.require_device``), it never falls back
to the CPU. ``encode_arrays`` and ``encode_csv`` take a model already on
that device.

Not ported yet: ``predict_classifier`` and the ``image`` / ``profile``
pipelines (the supervised classifiers, queue 1 module 5).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from ..data.dataset import MultiSet
from ..data.pipeline import Loader, multi_collate_fn
from ..config import ModelCard
from ..data.tokenize import get_tokenizer
from ..data.transforms import ImageTransformTest, ProfileTransformTest
from ..ops.knn import require_device
from ..ops.losses import l2_normalize
from ..train.checkpoint import load_from_checkpoint


def eval_pipeline(card: ModelCard, kind: str):
    """``(image_tf, profile_tf, tokenizer)`` of the deterministic eval
    pipeline of a ``multi`` / ``retrieval`` model: the test-time
    transforms at the card's ``target_size`` and the tokenizer of the
    profile encoder's kind, padded to ``target_size + 1`` tokens for a
    transformer (the CLS row), ``target_size`` otherwise."""
    if kind in ("image", "profile"):
        raise NotImplementedError(
            f"the {kind!r} eval pipeline (the supervised classifiers) is "
            f"not ported yet (queue 1 module 5)")
    if kind not in ("multi", "retrieval"):
        raise ValueError(f"Unknown model kind {kind!r}")
    enc_kind = (card.profile_encoder_args or {}).get("kind", "cnn")
    ts = card.target_size
    pad_to = ts + 1 if enc_kind == "transformer" else ts
    return (ImageTransformTest(ts), ProfileTransformTest(ts),
            get_tokenizer(enc_kind, ts, pad_to=pad_to))


@torch.inference_mode()
def encode_batches(model: nn.Module, batches: Iterable[Mapping],
                   device: torch.device | str) -> Dict[str, np.ndarray]:
    """Encode each batch (a dict of ``MultiModel.encode`` inputs) on
    ``device``; return the stacked normalized image and profile
    embeddings."""
    device = require_device(device)
    model.eval()
    images, profiles = [], []
    for batch in batches:
        inputs = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        emb = model.encode(**inputs)
        images.append(l2_normalize(emb["image_emb"]).float().cpu().numpy())
        profiles.append(l2_normalize(emb["profile_emb"]).float().cpu().numpy())
    return {"image": np.concatenate(images), "profile": np.concatenate(profiles)}


def encode_arrays(model: nn.Module, arrays: Mapping, labels,
                  batch_size: int = 256,
                  device: torch.device | str = "cuda"
                  ) -> Dict[str, np.ndarray]:
    """Encode ``arrays`` (image, image_shape, profile, profile_len, time,
    padding_mask; equal leading sizes) in batches of ``batch_size``."""
    n = len(arrays["image"])
    batches = ({k: v[i:i + batch_size] for k, v in arrays.items()}
               for i in range(0, n, batch_size))
    out = encode_batches(model, batches, device)
    out["label"] = np.asarray(labels)
    return out


def encode_csv(model: nn.Module, csv_path: Path | str, target_size: int,
               batch_size: int = 64, num_workers: int = 4,
               device: torch.device | str = "cuda"
               ) -> Dict[str, np.ndarray]:
    """Encode an annotations CSV (columns ``image, profile[, class]``) with
    the eval pipeline of "multi" models (``eval_pipeline`` of the JAX
    package): test-time image and profile transforms at the card's
    ``target_size``, and the tokenizer of the profile encoder's kind —
    ``transformer`` pads to ``target_size + 1`` tokens (the CLS row),
    ``cnn`` to ``target_size``."""
    kind = model.profile_encoder.kind
    pad_to = target_size + 1 if kind == "transformer" else target_size
    return _encode_table(model, csv_path, ImageTransformTest(target_size),
                         ProfileTransformTest(target_size),
                         get_tokenizer(kind, target_size, pad_to),
                         batch_size, num_workers, device)


def _encode_table(model, csv_path, image_tf, profile_tf, tokenizer,
                  batch_size, num_workers, device) -> Dict[str, np.ndarray]:
    device = require_device(device)
    dataset = MultiSet(csv_path, image_tf, profile_tf)
    loader = Loader(dataset, batch_size, multi_collate_fn(tokenizer),
                    shuffle=False, drop_last=False, num_workers=num_workers)
    out = encode_batches(model, loader, device)
    out["label"] = dataset.table["class"].to_numpy()
    return out


def _load(checkpoint_dir, device):
    model, _, meta = load_from_checkpoint(checkpoint_dir, device=device)
    return model, ModelCard.from_dict(meta["card"]), meta


def encode_dataset(checkpoint_dir: Path | str, csv_path: Path | str,
                   batch_size: int = 64, num_workers: int = 4,
                   device: torch.device | str = "cuda") -> Dict:
    """Flat layout: one csv -> {image, profile, label, classes}."""
    model, card, meta = _load(checkpoint_dir, device)
    out = _encode_table(model, Path(csv_path), *eval_pipeline(card, "multi"),
                        batch_size, num_workers, device)
    out["classes"] = np.asarray(meta.get("class_names", []))
    return out


def encode_split(checkpoint_dir: Path | str, dataset_dir: Path | str,
                 batch_size: int = 64, num_workers: int = 4,
                 device: torch.device | str = "cuda") -> Dict:
    """Nested layout: dataset_dir/{train,test}.csv ->
    {train: {...}, test: {...}, classes}."""
    model, card, meta = _load(checkpoint_dir, device)
    pipeline = eval_pipeline(card, "multi")
    out = {split: _encode_table(model, Path(dataset_dir) / f"{split}.csv",
                                *pipeline, batch_size, num_workers, device)
           for split in ("train", "test")}
    out["classes"] = np.asarray(meta.get("class_names", []))
    return out
