"""Operations of one forward of a contrastive card, counted from its
shapes: every matmul, convolution and attention product (2 per
multiply-add), nothing for norms, activations or reductions. A train
step is 3 forwards (the backward's two products per forward product,
none recomputed); a served batch is one forward plus the kNN's distance
products against the fused gallery.

Each encoder's count is its own file (``counts/encoders/``, found by the
encoder's name); here the two projections into the shared space and the
CLIP similarities, one (n x D) x (D x n) product a bucket of n pairs.
Transformers count every token, padded ones too, as the program
computes them.
"""

from __future__ import annotations

from typing import Dict

from .encoders import count_file


def encoder_dims(card: Dict) -> Dict[str, int]:
    """The projections' input widths (each encoder's features and its
    metadata scalars: the image's height and width, the profile's
    length) and the shared space's."""
    img, prof = card["image_encoder_args"], card["profile_encoder_args"]
    return {"image": count_file(img, "image").width(img)
            + 2 * int(img.get("metadata", True)),
            "profile": count_file(prof, "profile").width(prof)
            + int(prof.get("metadata", True)),
            "embed": card.get("dim_embedding") or 512}


def forward_flops(card: Dict, batch: int) -> int:
    """Operations of one forward of ``batch`` pairs: both encoders and
    both projections."""
    size = card.get("target_size", 224)
    per = 0
    for role in ("image", "profile"):
        args = card[f"{role}_encoder_args"]
        per += count_file(args, role).flops(args, size)
    d = encoder_dims(card)
    per += 2 * d["embed"] * (d["image"] + d["profile"])
    return batch * per


def clip_flops(card: Dict, batch: int, buckets: int) -> int:
    d = encoder_dims(card)["embed"]
    return 2 * batch * (batch // buckets) * d


def train_step_flops(card: Dict, batch: int, buckets: int) -> int:
    """A train step: forward and loss, times 3 for forward plus
    backward."""
    return 3 * (forward_flops(card, batch) + clip_flops(card, batch,
                                                        buckets))


def knn_flops(card: Dict, batch: int, gallery_rows: int) -> int:
    """The served classifier's distance products: one (B x D) x (D x G)
    a query modality, two modalities."""
    d = encoder_dims(card)["embed"]
    return 2 * 2 * batch * gallery_rows * d
