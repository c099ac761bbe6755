"""``program_host_ms.classify``: the host's self time in the program's
span ``serve.program`` (``utils/tracing.py``: ``ServingModel.run``
launching the exported program, encode and kNN), per ``serve.call`` of
the profiled sub-window, in ms. Spans record only while the profiler
runs, so this is the profiled sub-window's host time and carries the
profiler's slowdown. Nothing to read where the program has no span
table, or where its count of ``serve.call`` is not the sub-window's
calls."""


def read(record):
    if record.kind != "classify" or record.trace is None \
            or not record.trace_units:
        return None
    try:
        from multimodal_plankton_recognition_torch.utils import tracing
    except ImportError:
        return None
    table = tracing.table()
    call, program = table.get("serve.call"), table.get("serve.program")
    if not call or not program or call["count"] != record.trace_units:
        return None
    return program["self_s"] / call["count"] * 1e3
