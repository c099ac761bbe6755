"""``mfu.train``: the model operations of a train step (both encoders'
and projections' products and the CLIP similarities, times 3 for forward
and backward, none recomputed: ``counts/model_flops.py``) over the
step's time (the unprofiled steps' wall, ended by a synchronize, over
their count), over the card's 989 TFLOP/s of bf16, in %."""

from portbench.counts.model_flops import train_step_flops
from portbench.counts.peaks import BF16_FLOPS


def read(record):
    if record.kind != "train" or not record.units:
        return None
    step_s = record.wall_s / record.units
    flops = train_step_flops(record.card, record.batch, record.buckets)
    return 100.0 * flops / step_s / BF16_FLOPS
