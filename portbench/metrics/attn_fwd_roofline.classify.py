"""``attn_fwd_roofline.classify``: the least time the card needs for
the attention cores' forwards of a served batch (``counts/
attention.py``) over the device time of the kernels the program's
attention op launches (the registered ``plankton::mha_qkv_fwd`` or
``plankton::mha_fwd``), per call of the profiled sub-window, in %.
Nothing to read where the trace has no such range."""

from portbench.counts.attention import attention_calls, least_time

RANGES = ("plankton::mha_qkv_fwd", "plankton::mha_fwd")


def read(record):
    t = record.trace
    if record.kind != "classify" or t is None or not record.trace_units:
        return None
    device_s = sum(t.range_s.get(r, 0.0) for r in RANGES) \
        / record.trace_units
    calls = attention_calls(record.card, record.batch, record.profile_keys)
    if device_s <= 0 or not calls:
        return None
    return 100.0 * least_time(calls, backward=False) / device_s
