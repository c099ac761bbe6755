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
* ``predict_classifier`` loads a supervised classifier's checkpoint and
  gives its logits over a CSV (``{logits, label, classes}``, the
  ``--logits`` entry of ``scripts/encode_torch.py``), through
  ``predict_arrays``, which takes in-memory arrays as ``encode_arrays``
  does.

All run on the card unless the caller passes ``device="cpu"``; without a
card the default raises (``ops.knn.require_device``), it never falls back
to the CPU. ``encode_arrays`` and ``encode_csv`` take a model already on
that device, and so does ``predict_arrays``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from ..data.dataset import MultiSet
from ..config import ModelCard
from ..data.pipeline import (
    Loader, image_collate_fn, multi_collate_fn, profile_collate_fn,
)
from ..data.tokenize import get_tokenizer
from ..data.transforms import (
    ImageTransforms, ImageTransformTest, ProfileTransform,
    ProfileTransformTest,
)
from ..ops.knn import require_device
from ..ops.losses import l2_normalize
from ..train.checkpoint import load_from_checkpoint
from ..utils import LabelVocab


def eval_pipeline(card: ModelCard, kind: str):
    """``(image_tf, profile_tf, tokenizer)`` of the deterministic eval
    pipeline of a model ``kind``. ``multi`` / ``retrieval``: the
    test-time transforms at the card's ``target_size`` and the tokenizer
    of the profile encoder's kind, padded to ``target_size + 1`` tokens
    for a transformer (the CLS row), ``target_size`` otherwise. The
    supervised kinds take the raw transforms their drivers train on:
    ``profile`` resamples to the card's ``max_len`` and pads to ``max_len
    + 1`` tokens for a transformer (default 256); ``image`` keeps each
    profile's length (unused downstream) under an auto-padding
    tokenizer."""
    enc_kind = (card.profile_encoder_args or {}).get("kind", "cnn")
    ts = card.target_size
    if kind in ("multi", "retrieval"):
        pad_to = ts + 1 if enc_kind == "transformer" else ts
        return (ImageTransformTest(ts), ProfileTransformTest(ts),
                get_tokenizer(enc_kind, ts, pad_to=pad_to))
    if kind == "profile":
        max_len = card.max_len or 256
        pad_to = max_len + 1 if enc_kind == "transformer" else max_len
        return (ImageTransforms(target_size=ts),
                ProfileTransform(max_len=card.max_len),
                get_tokenizer(enc_kind, max_len, pad_to=pad_to))
    if kind == "image":
        return (ImageTransforms(target_size=ts), ProfileTransform(max_len=0),
                get_tokenizer(enc_kind, card.max_len or 256))
    raise ValueError(f"Unknown model kind {kind!r}")


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


@torch.inference_mode()
def predict_batches(model: nn.Module, batches: Iterable[Mapping],
                    device: torch.device | str) -> Dict[str, np.ndarray]:
    """A classifier's eval-mode logits (f32: a bf16 logit is exact in f32)
    and ``label`` ids of each batch (a collate's dict; ``label`` is not
    an input), stacked."""
    device = require_device(device)
    model.eval()
    logits, labels = [], []
    for batch in batches:
        inputs = {k: torch.as_tensor(v).to(device)
                  for k, v in batch.items() if k != "label"}
        logits.append(model(**inputs).float().cpu().numpy())
        if "label" in batch:
            labels.append(np.asarray(batch["label"]))
    return {"logits": np.concatenate(logits),
            "label": np.concatenate(labels) if labels else None}


def predict_arrays(model: nn.Module, arrays: Mapping,
                   batch_size: int = 64,
                   device: torch.device | str = "cuda") -> np.ndarray:
    """A classifier's logits for ``arrays`` (its inputs: image and
    image_shape, or the tokenized profile, profile_len and tokens; equal
    leading sizes) in batches of ``batch_size``."""
    n = len(next(iter(arrays.values())))
    batches = ({k: v[i:i + batch_size] for k, v in arrays.items()}
               for i in range(0, n, batch_size))
    return predict_batches(model, batches, device)["logits"]


def predict_classifier(checkpoint_dir: Path | str, csv_path: Path | str,
                       batch_size: int = 64, num_workers: int = 4,
                       device: torch.device | str = "cuda") -> Dict:
    """A supervised classifier's logits and labels over an annotations
    CSV through its kind's eval pipeline: ``{logits, label (class
    names), classes}``."""
    model, card, meta = _load(checkpoint_dir, device)
    kind = meta.get("kind")
    if kind not in ("image", "profile"):
        raise ValueError(f"predict_classifier needs an image/profile "
                         f"checkpoint, got kind={kind!r}")
    vocab = LabelVocab(meta["class_names"])
    image_tf, profile_tf, tok = eval_pipeline(card, kind)
    dataset = MultiSet(csv_path, image_tf, profile_tf)
    collate = image_collate_fn(vocab) if kind == "image" \
        else profile_collate_fn(tok, vocab)
    loader = Loader(dataset, batch_size, collate, shuffle=False,
                    drop_last=False, num_workers=num_workers)
    out = predict_batches(model, loader, device)
    return {"logits": out["logits"],
            "label": vocab.inverse_transform(out["label"]),
            "classes": np.asarray(vocab.to_list())}
