"""``attn_roofline.train``: the least time the card needs for the
attention cores' work of a train step (forward and backward of every
attention layer at the cell's shapes, ``counts/attention.py``) over the
device time of the kernels launched inside the attention core's forward
and its autograd backward node, per step of the profiled sub-window, in
%. Nothing to read where the trace has no such range."""

from portbench.counts.attention import attention_calls, least_time

RANGES = ("_MhaQkv", "_MhaQkvBackward", "_Mha", "_MhaBackward")


def read(record):
    t = record.trace
    if record.kind != "train" or t is None or not record.trace_units:
        return None
    device_s = sum(t.range_s.get(r, 0.0) for r in RANGES) \
        / record.trace_units
    calls = attention_calls(record.card, record.batch, record.profile_keys)
    if device_s <= 0 or not calls:
        return None
    return 100.0 * least_time(calls, backward=True) / device_s
