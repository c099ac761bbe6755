"""Serving export: a port checkpoint -> a ``torch.export`` artifact
(``retrieval/export.py`` of the JAX package).

``torch.export`` traces the eval-mode inference function, weights and
(for retrieval) the gallery held in the program, into an
``ExportedProgram`` that ``torch.export.load`` runs with no model code,
card or checkpoint machinery: only torch and the op registrations of the
port's kernels (``ops/attention.py``, ``ops/attention_block.py``,
``ops/ffn.py``), which loading imports.

Artifact layout (a directory):

  model.cuda.pt2   ``torch.export.save`` of the program traced on the card
  model.cpu.pt2    the same traced on the CPU
  metadata.json    {kind, classes, input_spec, outputs, platforms, ...}

One program per platform, each traced on its own device (``platforms``,
default ``("cuda", "cpu")``); asking for ``cuda`` without a card raises,
and ``load_artifact(dir, device)`` picks that device's program and
raises when the artifact lacks it. The programs take the batch dict of
the training collates (``data/pipeline.py``): ``{image, image_shape,
profile, profile_len, ...tokens}`` for ``kind="multi"`` (returns the
L2-normalised ``{image_emb, profile_emb}`` of ``retrieval/encode.py``),
the classifier batch for ``kind="image" | "profile"`` (returns
``logits``). The batch dimension is symbolic by default, so one artifact
serves every batch size, 1 included; ``batch_size=N`` pins it.

Kernels. By default the card's kernel flags (``fused_attention``,
``fused_mbconv``, ``fused_ffn``) are stripped before the export, as in
JAX, and the program runs PyTorch's own ops. ``keep_fused=True`` keeps
them: the forwards of kernels 1, 3, 9 and 11 are registered ops
(``plankton::mha_qkv_fwd``, ``plankton::mha_fwd``, ``plankton::ffn_fwd``,
``plankton::attn_block_fwd``), so each stays one node of the program,
launching the kernel when the program runs on the card and the plain
version when it runs on the CPU; never the plain math inlined. The
kernels are built at first use (``ops/build.py``), as in eager code.
``fused_mbconv``'s kernels 13-16 are train kernels: the eval forward of
an EfficientNet runs cuDNN either way.

A JAX artifact (serialized StableHLO, ``model.stablehlo``) cannot be
loaded here, nor this artifact by the JAX package. Not ported (JAX
machinery): the lowering platforms ``tpu`` and ``jax_version``
(``torch_version`` takes its place).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelCard
from ..ops.knn import (inverse_distance_weights, require_device,
                       topk_euclidean, weighted_mode_device)
from ..ops.losses import l2_normalize

PLATFORMS = ("cuda", "cpu")
METADATA_FILE = "metadata.json"

_FUSED_KEYS = ("fused_attention", "fused_mbconv", "fused_ffn")
_DTYPES = {"float32": torch.float32, "int32": torch.int32,
           "bool": torch.bool}
#: the batch a symbolic program is traced at
TRACE_BATCH = 2


def artifact_file(platform: str) -> str:
    """The program file of ``platform``: ``model.<platform>.pt2``."""
    return f"model.{platform}.pt2"


def _strip_fused(card: ModelCard) -> ModelCard:
    """Return a card with the kernel flags off (see module docstring)."""
    d = copy.deepcopy(card.to_dict())
    for block in ("image_encoder_args", "profile_encoder_args"):
        args = d.get(block)
        if args:
            for k in _FUSED_KEYS:
                args.pop(k, None)
    return ModelCard.from_dict(d)


def batch_spec(card: ModelCard, kind: str) -> Dict[str, Tuple[Tuple, str]]:
    """Input spec {key: (shape-with-None-batch, dtype)} mirroring the
    training collates (data/pipeline.py MultiCollate/ImageCollate/
    ProfileCollate, minus labels)."""
    ts = card.target_size
    enc_kind = (card.profile_encoder_args or {}).get("kind", "cnn")
    if kind == "multi":
        pad_to = ts + 1 if enc_kind == "transformer" else ts
        spec = {
            "image": ((None, ts, ts, 1), "float32"),
            "image_shape": ((None, 2), "int32"),
            "profile_len": ((None, 1), "int32"),
        }
        spec.update(_profile_token_spec(enc_kind, pad_to))
        return spec
    if kind == "image":
        return {
            "image": ((None, ts, ts, 1), "float32"),
            "image_shape": ((None, 2), "int32"),
        }
    if kind == "profile":
        max_len = card.max_len or 256
        pad_to = max_len + 1 if enc_kind == "transformer" else max_len
        spec = {"profile_len": ((None, 1), "int32")}
        spec.update(_profile_token_spec(enc_kind, pad_to))
        return spec
    raise ValueError(f"Unknown checkpoint kind {kind!r}")


def _profile_token_spec(enc_kind: str, pad_to: int) -> Dict:
    spec = {"profile": ((None, pad_to, 6), "float32")}
    if enc_kind == "transformer":
        spec["time"] = ((None, pad_to), "int32")
        spec["padding_mask"] = ((None, pad_to), "bool")
    elif enc_kind == "lstm":
        spec["last_idx"] = ((None,), "int32")
    return spec


def _present(**inputs) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in inputs.items() if v is not None}


class _Inference(nn.Module):
    """The inference function of ``kind`` over a batch's keyword tensors
    (the keys of ``batch_spec``): normalised embeddings (``multi``) or
    logits."""

    def __init__(self, model: nn.Module, kind: str) -> None:
        super().__init__()
        self.model = model
        self.kind = kind

    def forward(self, image=None, image_shape=None, profile=None,
                profile_len=None, time=None, padding_mask=None,
                last_idx=None):
        batch = _present(image=image, image_shape=image_shape,
                         profile=profile, profile_len=profile_len, time=time,
                         padding_mask=padding_mask, last_idx=last_idx)
        if self.kind == "multi":
            emb = self.model.encode(**batch)
            return {"image_emb": l2_normalize(emb["image_emb"]),
                    "profile_emb": l2_normalize(emb["profile_emb"])}
        return {"logits": self.model(**batch)}


#: exact-hit tolerance of the retrieval artifact (JAX's value): far above
#: the embedding difference between the program and the code that built
#: the gallery and the direct form's distance noise, far below genuine
#: distances between L2-normalised embeddings, so a gallery member queried
#: through the artifact fires the reference's exact-hit rule, and only it.
SERVING_EXACT_EPS = 1e-4


class _RetrievalClassify(nn.Module):
    """Embed a pair batch, query the fused gallery held in the program
    with both modalities (one kNN query per modality, neighbours
    h-stacked: the reference's fusion), and return the inverse-distance
    weighted-mode class (``ANNClassifier.predict`` up to
    ``SERVING_EXACT_EPS``). The candidates come from the matmul form
    ``|q|² − 2 q·g + |g|²``, whose f32 cancellation noise could tie
    distinct neighbours with an exact self-hit; so ``kc`` candidates are
    re-ranked by the direct form ``|q − g|`` and the top k kept."""

    def __init__(self, model: nn.Module, gallery: torch.Tensor,
                 gallery_ids: torch.Tensor, n_classes: int, k: int) -> None:
        super().__init__()
        self.model = model
        self.register_buffer("gallery", gallery)
        self.register_buffer("gallery_ids", gallery_ids)
        self.n_classes = n_classes
        self.k = k

    def forward(self, image=None, image_shape=None, profile=None,
                profile_len=None, time=None, padding_mask=None,
                last_idx=None):
        emb = self.model.encode(**_present(
            image=image, image_shape=image_shape, profile=profile,
            profile_len=profile_len, time=time, padding_mask=padding_mask,
            last_idx=last_idx))
        queries = (l2_normalize(emb["image_emb"]),
                   l2_normalize(emb["profile_emb"]))
        k = self.k
        kc = min(self.gallery.shape[0], max(2 * k, k + 16))
        idx_list, dist_list = [], []
        for q in queries:
            cand, _ = topk_euclidean(q, self.gallery, kc)
            diff = q.float()[:, None, :] - self.gallery[cand]
            d2 = (diff * diff).sum(dim=-1)
            best, pos = torch.topk(-d2, k, dim=1)
            idx_list.append(torch.gather(cand, 1, pos))
            dist_list.append(torch.sqrt(torch.clamp(-best, min=0.0)))
        idx = torch.cat(idx_list, dim=1)
        dist = torch.cat(dist_list, dim=1)
        weights = inverse_distance_weights(dist, exact_eps=SERVING_EXACT_EPS)
        class_id, votes = weighted_mode_device(self.gallery_ids[idx],
                                               weights, self.n_classes)
        return {"class_id": class_id, "votes": votes,
                "image_emb": queries[0], "profile_emb": queries[1]}


def _example_batch(spec, batch: int, device) -> Dict[str, torch.Tensor]:
    """A batch of ``spec`` to trace with: zero images and profiles at
    full size, every profile one row long, no padding."""
    out = {}
    for key, (shape, dtype) in spec.items():
        shape = tuple(batch if d is None else d for d in shape)
        out[key] = torch.zeros(shape, dtype=_DTYPES[dtype], device=device)
    if "image_shape" in out:
        out["image_shape"][:] = spec["image"][0][1]
    if "profile_len" in out:
        out["profile_len"][:] = 1
    if "time" in out:
        out["time"][:] = torch.arange(out["time"].shape[1], device=device)
    return out


def _trace(fn: nn.Module, spec, platform: str,
           batch_size: Optional[int]) -> torch.export.ExportedProgram:
    """``torch.export`` of ``fn`` (already on ``platform``, frozen, eval
    mode) over a batch of ``spec``: the batch symbolic unless pinned."""
    device = require_device(platform)
    example = _example_batch(spec, batch_size or TRACE_BATCH, device)
    dynamic = None
    if batch_size is None:
        b = torch.export.Dim("b", min=1)
        dynamic = {key: {0: b} for key in example}
    with torch.no_grad():
        return torch.export.export(fn, (), example, dynamic_shapes=dynamic)


def _frozen(fn: nn.Module, platform: str) -> nn.Module:
    """A copy of ``fn`` on ``platform`` in eval mode that takes no
    gradient, so the kernel wrappers reach their registered ops."""
    fn = copy.deepcopy(fn).to(require_device(platform)).eval()
    for p in fn.parameters():
        p.requires_grad_(False)
    return fn


def _check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{list(platforms)}")
    for p in platforms:
        require_device(p)  # cuda without a card raises before any trace
    return platforms


def export_inference(model: nn.Module, card: ModelCard, kind: str,
                     platforms: Sequence[str] = PLATFORMS,
                     batch_size: Optional[int] = None
                     ) -> Dict[str, torch.export.ExportedProgram]:
    """{platform: program} of the eval-mode inference function of
    ``model`` (a ``kind`` model of ``card``), each traced on its own
    device. ``batch_size=None`` exports a symbolic batch dimension (one
    program, any batch size); an int pins it. ``model`` is not moved."""
    spec = batch_spec(card, kind)
    return {p: _trace(_frozen(_Inference(model, kind), p), spec, p,
                      batch_size)
            for p in _check_platforms(platforms)}


def export_retrieval_inference(model: nn.Module, card: ModelCard,
                               gallery_image: np.ndarray,
                               gallery_profile: np.ndarray,
                               gallery_ids: np.ndarray, n_classes: int,
                               k: int = 9,
                               platforms: Sequence[str] = PLATFORMS,
                               batch_size: Optional[int] = None
                               ) -> Dict[str, torch.export.ExportedProgram]:
    """{platform: program} of the end-to-end retrieval classifier, the
    fused gallery held in the program: image and profile embeddings
    stacked along rows with tiled labels (the reference's fused-gallery
    protocol)."""
    gallery = torch.from_numpy(np.concatenate(
        [gallery_image, gallery_profile]).astype(np.float32))
    ids = torch.from_numpy(np.tile(np.asarray(gallery_ids, np.int64), 2))
    fn = _RetrievalClassify(model, gallery, ids, n_classes, k)
    spec = batch_spec(card, "multi")
    return {p: _trace(_frozen(fn, p), spec, p, batch_size)
            for p in _check_platforms(platforms)}


def save_artifact(programs: Dict[str, torch.export.ExportedProgram],
                  meta: Dict[str, Any], out_dir: Path | str) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for platform, program in programs.items():
        torch.export.save(program, out_dir / artifact_file(platform))
    with open(out_dir / METADATA_FILE, "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return out_dir


class ServingModel:
    """A loaded artifact's program on one device: ``call(batch)`` -> dict
    of numpy arrays (bf16 outputs as f32, which holds them exactly)."""

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Dict[str, Any], device: torch.device) -> None:
        self.program = program
        self.meta = meta
        self.device = device
        self._module = program.module()

    @property
    def classes(self) -> np.ndarray:
        return np.asarray(self.meta.get("classes", []))

    def _check_keys(self, batch) -> None:
        expected = set(self.meta["input_spec"])
        got = set(batch)
        if got != expected:
            raise ValueError(
                f"Batch keys {sorted(got)} != artifact inputs "
                f"{sorted(expected)}")

    def run(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The program on a batch of tensors already on the device; the
        outputs stay there, in the program's dtypes."""
        self._check_keys(batch)
        with torch.no_grad():
            return self._module(**batch)

    def call(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        self._check_keys(batch)
        out = self.run({k: torch.as_tensor(np.asarray(v)).to(self.device)
                        for k, v in batch.items()})
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy() for k, v in out.items()}


def _register_ops() -> None:
    """Import the port's op registrations, which a program that keeps
    kernels calls (the op modules, not the model code)."""
    from ..ops import attention, attention_block, ffn  # noqa: F401


def load_artifact(artifact_dir: Path | str,
                  device: torch.device | str = "cuda") -> ServingModel:
    """The artifact's program for ``device`` (the card unless the caller
    names another; without a card the default raises). Raises when the
    artifact has no program for that device's platform."""
    device = require_device(device)
    artifact_dir = Path(artifact_dir)
    with open(artifact_dir / METADATA_FILE) as f:
        meta = json.load(f)
    if device.type not in meta.get("platforms", ()):
        raise ValueError(
            f"artifact {artifact_dir} has no {device.type} program (its "
            f"platforms: {meta.get('platforms')}); export it with "
            f"--platforms {device.type}")
    _register_ops()
    program = torch.export.load(artifact_dir / artifact_file(device.type))
    return ServingModel(program, meta, device)


def export_checkpoint(checkpoint_dir: Path | str, out_dir: Path | str,
                      platforms: Sequence[str] = PLATFORMS,
                      batch_size: Optional[int] = None,
                      keep_fused: bool = False) -> Path:
    """checkpoint directory -> serving artifact directory. The rebuild on
    the stripped card loads the same state dict: the kernel routes keep
    the parameter tree of the routes without them."""
    model, card, meta = _load_rebuilt(checkpoint_dir, keep_fused)
    kind = meta.get("kind", "multi")
    programs = export_inference(model, card, kind, platforms, batch_size)
    artifact_meta = _artifact_meta(
        kind, card, platforms, batch_size,
        classes=list(meta.get("class_names", [])),
        outputs=(["image_emb", "profile_emb"] if kind == "multi"
                 else ["logits"]))
    return save_artifact(programs, artifact_meta, out_dir)


def _artifact_meta(kind: str, card: ModelCard, platforms, batch_size,
                   classes, outputs, **extra) -> Dict[str, Any]:
    spec = batch_spec(card, "multi" if kind == "retrieval" else kind)
    return {
        "kind": kind,
        "classes": classes,
        "input_spec": {k: {"shape": ["b" if d is None else d for d in shape],
                           "dtype": dtype}
                       for k, (shape, dtype) in spec.items()},
        "outputs": outputs,
        "platforms": list(platforms),
        "batch_size": batch_size or "symbolic",
        "torch_version": torch.__version__,
        "card": card.to_dict(),
        **extra,
    }


def _load_rebuilt(checkpoint_dir, keep_fused: bool):
    """(model on the CPU, card, metadata), the kernel flags stripped
    unless ``keep_fused`` (shared by both export entry points)."""
    from ..models.build import build_for_kind
    from ..train.checkpoint import load_from_checkpoint

    model, _, meta = load_from_checkpoint(checkpoint_dir, device="cpu")
    card = ModelCard.from_dict(meta["card"])
    if not keep_fused:
        card = _strip_fused(card)
        stripped = build_for_kind(card, meta.get("kind", "multi"),
                                  meta.get("class_names", ()))
        stripped.load_state_dict(model.state_dict(), strict=True)
        model = stripped
    return model.eval(), card, meta


def export_retrieval_checkpoint(checkpoint_dir: Path | str,
                                embeddings_pkl: Path | str,
                                out_dir: Path | str,
                                name: Optional[str] = None,
                                fold=None, k: int = 9,
                                platforms: Sequence[str] = PLATFORMS,
                                batch_size: Optional[int] = None,
                                keep_fused: bool = False) -> Path:
    """checkpoint + embeddings pickle (the gallery) -> one classifying
    artifact: embed the pair, kNN against the fused gallery in the
    program, weighted-mode class.

    ``embeddings_pkl`` is a ``scripts/encode_torch.py`` (or
    ``scripts/encode.py``) product; ``name``/``fold`` select the entry
    (defaulting to the only one). Nested train/test entries use the
    *train* split as the gallery (the folds protocol).
    """
    import pickle

    from ..utils import LabelVocab

    with open(embeddings_pkl, "rb") as f:
        emb = pickle.load(f)
    name = name if name is not None else _only_key(emb, "model name")
    folds = emb[name]
    fold = fold if fold is not None else _only_key(folds, "fold")
    entry = folds[fold]
    if "train" in entry:  # nested layout: gallery from the train split
        entry = entry["train"]
    labels = np.asarray(entry["label"])
    vocab = LabelVocab(labels)
    ids = vocab.transform(list(labels))

    model, card, _ = _load_rebuilt(checkpoint_dir, keep_fused)
    programs = export_retrieval_inference(
        model, card, entry["image"], entry["profile"], ids,
        n_classes=len(vocab), k=k, platforms=platforms,
        batch_size=batch_size)
    artifact_meta = _artifact_meta(
        "retrieval", card, platforms, batch_size,
        classes=vocab.classes_.tolist(),
        outputs=["class_id", "votes", "image_emb", "profile_emb"],
        k=k, exact_eps=SERVING_EXACT_EPS,
        gallery_size=int(labels.shape[0]),
        gallery_source=str(embeddings_pkl))
    return save_artifact(programs, artifact_meta, out_dir)


def _only_key(d: Dict, what: str):
    keys = list(d)
    if len(keys) != 1:
        raise ValueError(f"Multiple {what}s in the embeddings pickle "
                         f"({keys}); pass one explicitly")
    return keys[0]
