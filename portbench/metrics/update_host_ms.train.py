"""``update_host_ms.train``: the host's self time in the program's spans
``train.load`` (the f32 masters into the compute module, train mode,
gradients cleared) and ``train.update`` (the gradients' f32 upcast,
accumulation and the optimizer's step), ``utils/tracing.py``, per
``train.step`` of the profiled sub-window, in ms: the step's bookkeeping
on the host. Spans record only while the profiler runs, so this is the
profiled sub-window's host time and carries the profiler's slowdown.
Nothing to read where the program has no span table, or where its count
of ``train.step`` is not the sub-window's steps."""


def read(record):
    if record.kind != "train" or record.trace is None \
            or not record.trace_units:
        return None
    try:
        from multimodal_plankton_recognition_torch.utils import tracing
    except ImportError:
        return None
    table = tracing.table()
    step = table.get("train.step")
    parts = [table.get(name) for name in ("train.load", "train.update")]
    if not step or not all(parts) or step["count"] != record.trace_units:
        return None
    return sum(p["self_s"] for p in parts) / step["count"] * 1e3
