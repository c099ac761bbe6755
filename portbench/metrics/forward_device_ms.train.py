"""``forward_device_ms.train``: device time of the kernels the train
step's forward launched, those launched inside the program's span
``plankton::train.forward`` (``utils/tracing.py``), per step of the
profiled sub-window, in ms. The backward's kernels are launched from the
autograd engine's thread, outside the span, and are not counted. Nothing
to read where the trace has no such range (a program without the span),
or where the program's span table does not count one ``train.step`` a
step of the sub-window."""

RANGES = ("plankton::train.forward",)


def read(record):
    t = record.trace
    if record.kind != "train" or t is None or not record.trace_units:
        return None
    try:
        from multimodal_plankton_recognition_torch.utils import tracing
    except ImportError:
        return None
    steps = tracing.table().get("train.step", {}).get("count")
    device_s = t.range_s.get(RANGES[0], 0.0)
    if steps != record.trace_units or device_s <= 0:
        return None
    return device_s / record.trace_units * 1e3
