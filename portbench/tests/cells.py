"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can hold."""

import copy

from portbench.harness.manifest import Cell, load_manifest, resolve


def tiny(name: str) -> Cell:
    """The cell ``name`` small enough for the CPU: 32-px images (the
    ViT's position table cut to match, 2 blocks), 16 pairs a batch in 4
    buckets, 4 pool batches, a gallery of 100 pairs. Widths stay."""
    c = copy.deepcopy(resolve(name, load_manifest()))
    card = c.config["card"]
    card.update(bs=16, buckets=4, target_size=32)
    img, prof = card["image_encoder_args"], card["profile_encoder_args"]
    if img["name"].startswith("vit"):
        img["backbone_kwargs"] = {"img_size": 32, "depth": 2}
    if prof["kind"] == "transformer":
        prof["target_size"] = 32
    c.traffic.update(batch=16, pool=4)
    if "gallery_pairs" in c.traffic:
        c.traffic.update(gallery_pairs=100, calibration_pairs=16,
                         sample_batches=3)
    return c
