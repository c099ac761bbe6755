"""Typed model-card schema (``config.py`` of the JAX package).

The same dataclasses, defaults, compat shims (key-sniffed profile encoder
kind, stale ``dim_out`` / ``max_len`` keys) and checks, raising the same
``CardError``s. The only difference: PyYAML is imported inside
``load_card``, so building a model from a card dict
(``ModelCard.from_dict`` → ``models.build.build_multi_model``) imports no
yaml, which the card's machine lacks.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Dict, Optional

COORDINATION_METHODS = (
    "clip",
    "siglip",
    "clipplus",
    "siglipplus",
    "rank",
    "distance",
    "arcface",
    "zero",
)

PROFILE_ENCODER_KINDS = ("transformer", "cnn", "lstm")


class CardError(ValueError):
    """Raised when a model card fails validation."""


@dataclasses.dataclass
class OptimConfig:
    """SGD hyperparameters (the reference trains exclusively with
    ``torch.optim.SGD``; reference: src/model.py:147-148)."""

    lr: float = 5e-3
    momentum: float = 0.9
    weight_decay: float = 1e-3
    nesterov: bool = True

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "OptimConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise CardError(f"optim_args: unknown keys {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class TrainerConfig:
    """Subset of Lightning ``Trainer`` kwargs the reference cards use.
    ``precision`` '16-mixed' maps to bfloat16 compute (no loss scaling
    needed)."""

    precision: str = "32"
    min_epochs: int = 1
    max_epochs: int = 1
    accumulate_grad_batches: int = 1
    check_val_every_n_epoch: int = 1
    val_check_interval: Optional[float] = None

    @property
    def compute_dtype(self) -> str:
        precision = str(self.precision)
        return "bfloat16" if "16" in precision and precision != "32" \
            else "float32"

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "TrainerConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        ignored = {k: d.pop(k) for k in list(d) if k not in known}
        cfg = cls(**{k: v for k, v in d.items() if v is not None})
        cfg._ignored = ignored  # type: ignore[attr-defined]
        return cfg


def _normalize_profile_encoder(args: Optional[Dict[str, Any]],
                               target_size: int,
                               max_len: Optional[int]) -> Optional[Dict[str, Any]]:
    """Normalize profile-encoder args.

    Applies the reference's key-sniffing dispatch as a compat fallback
    (reference: src/model.py:34-39) and renames the stale example-card keys
    (``dim_out`` -> ``dim_hidden``, ``max_len`` -> ``target_size``;
    reference: model_cards/example_multi.yaml:18-25 vs src/profile_encoder.py:12).
    """
    if args is None:
        return None
    args = dict(args)
    kind = args.pop("kind", None)
    if kind is None:
        if "num_head" in args:
            kind = "transformer"
        elif "blocks" in args:
            kind = "cnn"
        else:
            kind = "lstm"
    if kind not in PROFILE_ENCODER_KINDS:
        raise CardError(
            f"profile_encoder_args.kind must be one of {PROFILE_ENCODER_KINDS}, got {kind!r}"
        )

    # Stale-card compat renames.
    if "dim_out" in args and "dim_hidden" not in args:
        args["dim_hidden"] = args.pop("dim_out")
    if kind == "transformer":
        if "max_len" in args and "target_size" not in args:
            args["target_size"] = args.pop("max_len")
        args.setdefault("target_size", max_len or target_size)
    else:
        args.pop("max_len", None)
        args.pop("target_size", None)

    allowed = {
        "transformer": {"dim_in", "dim_hidden", "target_size", "num_head",
                        "num_layers", "dim_feedforward", "dropout",
                        "activation", "metadata", "fused_attention",
                        "fused_ffn"},
        "lstm": {"dim_in", "dim_hidden", "num_layers", "dropout", "metadata"},
        "cnn": {"dim_in", "blocks", "groups", "base_channels", "dropout",
                "metadata", "norm"},
    }[kind]
    unknown = set(args) - allowed
    if unknown:
        raise CardError(
            f"profile_encoder_args ({kind}): unknown keys {sorted(unknown)}"
        )
    args["kind"] = kind
    return args


def _normalize_image_encoder(args: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if args is None:
        return None
    args = dict(args)
    if "name" not in args:
        raise CardError("image_encoder_args requires a 'name' (backbone)")
    allowed = {"name", "pretrained", "num_classes", "in_chans", "dropout",
               "metadata", "pretrained_path", "fused_mbconv",
               "fused_attention", "fused_ffn", "remat", "backbone_kwargs"}
    unknown = set(args) - allowed
    if unknown:
        raise CardError(f"image_encoder_args: unknown keys {sorted(unknown)}")
    bk = args.get("backbone_kwargs")
    if bk is not None and not isinstance(bk, dict):
        raise CardError("image_encoder_args.backbone_kwargs must be a "
                        "mapping of backbone constructor overrides")
    args.setdefault("in_chans", 1)
    args.setdefault("dropout", 0.1)
    args.setdefault("metadata", True)
    # NOTE: the reference hard-codes pretrained=True, silently ignoring the
    # card's flag (reference: src/image_encoder.py:16-17). We honor the flag;
    # the port does not load pretrained weights yet and raises for
    # `pretrained: true` and `pretrained_path` (ROADMAP.md).
    args.setdefault("pretrained", False)
    return args


def _normalize_coordination(args: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if args is None:
        return None
    args = dict(args)
    method = args.get("method")
    if method not in COORDINATION_METHODS:
        raise CardError(
            f"coordination_args.method must be one of {COORDINATION_METHODS}, got {method!r}"
        )
    args.setdefault("negatives", "bucketed")
    if args["negatives"] not in ("bucketed", "global"):
        raise CardError("coordination_args.negatives must be 'bucketed' or 'global'")
    # fused=True routes clip/siglip through the contrastive-loss kernels
    args.setdefault("fused", False)
    return args


@dataclasses.dataclass
class ModelCard:
    """Validated model card. Field names follow the reference card schema
    (reference: model_cards/example_{image,profile,multi}.yaml)."""

    bs: int = 64
    precision: str = "medium"          # matmul precision hint
    patience: int = 20
    save_top_k: int = 1
    dim_embedding: Optional[int] = None
    max_len: Optional[int] = None
    target_size: int = 224
    buckets: int = 1
    num_workers: int = 4
    seed: int = 0
    image_encoder_args: Optional[Dict[str, Any]] = None
    profile_encoder_args: Optional[Dict[str, Any]] = None
    coordination_args: Optional[Dict[str, Any]] = None
    optim_args: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    trainer_args: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    # Extensions of the JAX package (absent from reference cards,
    # defaulted); nothing in the port reads them yet (ROADMAP.md).
    mesh: Optional[Dict[str, int]] = None      # e.g. {data: 8, model: 1}
    device_augment: bool = False  # run crop/flip/noise on device in the step
    loader: str = "threads"       # 'threads' | 'grain' (multiprocess workers)
    #: read the packed input cache (scripts/pack_dataset.py) instead of
    #: decoding JPEG/CSV per epoch — bit-identical batches, ~10x the
    #: per-core sample rate (data/packed.py)
    packed_cache: bool = False
    #: multi-chip step mode of the JAX package: 'gspmd' or 'shard_map'
    #: (explicit per-chip step); ignored on one chip
    parallel: str = "gspmd"
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.bs <= 0:
            raise CardError("bs must be positive")
        if self.buckets <= 0 or self.bs % self.buckets != 0:
            raise CardError(
                f"bs ({self.bs}) must be divisible by buckets ({self.buckets})"
            )
        if self.parallel not in ("gspmd", "shard_map"):
            raise CardError(
                f"parallel must be 'gspmd' or 'shard_map', got {self.parallel!r}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelCard":
        d = dict(d)
        raw = dict(d)
        target_size = d.get("target_size") or 224
        max_len = d.get("max_len")
        kwargs: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name in ("raw",):
                continue
            if f.name in d and d[f.name] is not None:
                kwargs[f.name] = d.pop(f.name)
            else:
                d.pop(f.name, None)
        known_extra = set(d)
        allowed_extra = {"accumulate_grad_batches", "name", "notes"}
        unexpected = known_extra - allowed_extra
        if unexpected:
            raise CardError(f"Unknown top-level card keys: {sorted(unexpected)}")
        kwargs["image_encoder_args"] = _normalize_image_encoder(
            kwargs.get("image_encoder_args"))
        kwargs["profile_encoder_args"] = _normalize_profile_encoder(
            kwargs.get("profile_encoder_args"), target_size, max_len)
        pe = kwargs["profile_encoder_args"]
        if pe and pe.get("kind") == "transformer" and \
                kwargs.get("dim_embedding") is not None:
            # multi-card: profiles are resampled to card target_size, so the
            # position table (target_size + 2 rows) must cover those indices
            # — an undersized table reads out-of-bounds embeddings and
            # silently destabilizes training
            if pe["target_size"] < target_size:
                raise CardError(
                    f"profile_encoder_args.target_size ({pe['target_size']}) "
                    f"must be >= the card's target_size ({target_size}): "
                    f"profiles are resampled to {target_size} steps and the "
                    f"position table would be indexed out of bounds")
        ie = kwargs["image_encoder_args"]
        if ie and "_224" in ie.get("name", "") and target_size != 224 \
                and (ie.get("backbone_kwargs") or {}).get("img_size") \
                != target_size:
            # fixed-resolution backbones (ViT position tables) crash at
            # other crop sizes with an opaque broadcast error — fail early
            # (a backbone_kwargs img_size override matching the crop is the
            # sanctioned escape, e.g. the scaled-down parity-gate ViT)
            raise CardError(
                f"image_encoder_args.name {ie['name']!r} is a fixed-224 "
                f"backbone but the card's target_size is {target_size}; "
                f"set target_size: 224")
        kwargs["coordination_args"] = _normalize_coordination(
            kwargs.get("coordination_args"))
        kwargs["optim_args"] = OptimConfig.from_dict(kwargs.get("optim_args"))
        kwargs["trainer_args"] = TrainerConfig.from_dict(kwargs.get("trainer_args"))
        # train_image.py reads accumulate_grad_batches from the top level too
        # (reference: scripts/train_image.py:88); fold it into trainer_args.
        if "accumulate_grad_batches" in d:
            kwargs["trainer_args"].accumulate_grad_batches = d["accumulate_grad_batches"]
        card = cls(raw=raw, **kwargs)
        return card

    @property
    def oversize(self) -> int:
        """Pre-crop size for train-time over-resize, ceil(1.05 * target)
        (reference: src/data.py:78,133)."""
        return math.ceil(1.05 * self.target_size)


def load_card(path: str | Path) -> ModelCard:
    """Parse a YAML model card. PyYAML is imported here, not at module
    import: the card's machine has none, and the card path (``from_dict``)
    does not need it."""
    import yaml

    with open(path, "r") as stream:
        d = yaml.safe_load(stream)
    if not isinstance(d, dict):
        raise CardError(f"Model card {path} did not parse to a mapping")
    return ModelCard.from_dict(d)
