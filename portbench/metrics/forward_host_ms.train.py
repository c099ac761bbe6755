"""``forward_host_ms.train``: the host's self time in the program's span
``train.forward`` (``utils/tracing.py``: the loss's forward, launching
its kernels), per ``train.step`` of the profiled sub-window, in ms.
Spans record only while the profiler runs, so this is the profiled
sub-window's host time and carries the profiler's slowdown, as the
trace's readings do. Nothing to read where the program has no span
table, or where its count of ``train.step`` is not the sub-window's
steps."""


def read(record):
    if record.kind != "train" or record.trace is None \
            or not record.trace_units:
        return None
    try:
        from multimodal_plankton_recognition_torch.utils import tracing
    except ImportError:
        return None
    table = tracing.table()
    step, forward = table.get("train.step"), table.get("train.forward")
    if not step or not forward or step["count"] != record.trace_units:
        return None
    return forward["self_s"] / step["count"] * 1e3
