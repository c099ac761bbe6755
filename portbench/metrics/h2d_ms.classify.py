"""``h2d_ms.classify``: device time of the host-to-device copies of a
served batch (``ServingModel.call`` hands host arrays to the card), per
call of the profiled sub-window, in ms."""


def read(record):
    t = record.trace
    if record.kind != "classify" or t is None or not record.trace_units:
        return None
    return t.h2d_s / record.trace_units * 1e3
