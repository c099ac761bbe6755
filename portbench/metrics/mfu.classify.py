"""``mfu.classify``: the operations of a served batch (both encoders'
and projections' forward products, and the kNN's distance products
against the fused gallery: ``counts/model_flops.py``) over the call's
time (the unprofiled calls' wall over their count), over the card's 989
TFLOP/s of bf16, in %."""

from portbench.counts.model_flops import forward_flops, knn_flops
from portbench.counts.peaks import BF16_FLOPS


def read(record):
    if record.kind != "classify" or not record.units:
        return None
    call_s = record.wall_s / record.units
    flops = forward_flops(record.card, record.batch) \
        + knn_flops(record.card, record.batch, record.gallery_rows)
    return 100.0 * flops / call_s / BF16_FLOPS
