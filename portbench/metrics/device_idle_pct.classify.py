"""``device_idle_pct.classify``: the share of the profiled sub-window's
wall in which no kernel, copy or set ran on the card, in %."""


def read(record):
    t = record.trace
    if record.kind != "classify" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
