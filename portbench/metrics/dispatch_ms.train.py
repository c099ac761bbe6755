"""``dispatch_ms.train``: the host's time from the call of the train
step to its return, with no synchronize (host clock), the median over
the unprofiled steps of a ``--trace 1`` run, in ms. The card works
behind it; where this nears the step's time the host paces the card."""

import statistics


def read(record):
    if record.kind != "train" or not record.dispatch_s:
        return None
    return statistics.median(record.dispatch_s) * 1e3
