"""``h2d_gbps.classify``: the bytes a served call hands to the card, the
program's counter ``serve.h2d_bytes`` (``utils/tracing.py``: every host
array's ``nbytes``) per ``serve.call``, over the device time of the
host-to-device copies per call of the profiled sub-window (as
``h2d_ms.classify`` reads it), in GB/s. Nothing to read where the
program has no such counter, where its count of ``serve.call`` is not
the sub-window's calls, or where the trace holds no copy."""


def read(record):
    t = record.trace
    if record.kind != "classify" or t is None or not record.trace_units:
        return None
    try:
        from multimodal_plankton_recognition_torch.utils import tracing
    except ImportError:
        return None
    call = tracing.table().get("serve.call")
    sent = tracing.counters().get("serve.h2d_bytes", 0)
    if not call or call["count"] != record.trace_units or sent <= 0 \
            or t.h2d_s <= 0:
        return None
    return sent / call["count"] / (t.h2d_s / record.trace_units) * 1e-9
