"""``launches_per_step.train``: device kernels a train step launches,
counted in the profiled sub-window's trace over its steps."""


def read(record):
    if record.kind != "train" or record.trace is None \
            or not record.trace_units:
        return None
    return record.trace.kernels / record.trace_units
