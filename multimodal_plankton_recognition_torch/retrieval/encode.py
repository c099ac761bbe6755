"""Embedding export: pairs -> L2-normalized embeddings
(``retrieval/encode.py`` of the JAX package).

Batched eval-mode ``MultiModel.encode`` followed by ``l2_normalize``,
returning the JAX package's flat pickle layout ``{image, profile, label}``
(f32 numpy), which its retrieval benchmarks consume unchanged.

* ``encode_arrays`` takes in-memory arrays (numpy or tensors): the entry
  point of runs on the card, which need nothing beyond torch and numpy.
* ``encode_csv`` reads an annotations CSV through the port's own host
  layers (``data.dataset``, ``data.transforms``, ``data.pipeline``), which
  import pandas and PIL only when called.

Both run on the card unless the caller passes ``device="cpu"``; without a
card the default raises (``ops.knn.require_device``), it never falls back
to the CPU. The model must already be on that device.

Not ported yet: the checkpoint loaders (``encode_dataset``,
``encode_split``) and the ``scripts/encode.py`` CLI.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from ..data.dataset import MultiSet
from ..data.pipeline import Loader, multi_collate_fn
from ..data.tokenize import get_tokenizer
from ..data.transforms import ImageTransformTest, ProfileTransformTest
from ..ops.knn import require_device
from ..ops.losses import l2_normalize


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
    device = require_device(device)
    kind = model.profile_encoder.kind
    pad_to = target_size + 1 if kind == "transformer" else target_size
    dataset = MultiSet(csv_path, ImageTransformTest(target_size),
                       ProfileTransformTest(target_size))
    loader = Loader(dataset, batch_size,
                    multi_collate_fn(get_tokenizer(kind, target_size,
                                                   pad_to)),
                    shuffle=False, drop_last=False, num_workers=num_workers)
    out = encode_batches(model, loader, device)
    out["label"] = dataset.table["class"].to_numpy()
    return out
