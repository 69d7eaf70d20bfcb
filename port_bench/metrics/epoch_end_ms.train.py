"""Epoch end: the mean synchronised host time of one epoch end (the model's
epoch-end calls summed, its module's ``EPOCH_END``: IGCN's anneal, and
DOSE's selection and view rebuild after it), over the epoch ends of the
window and of the traced sub-window."""


def read(run):
    ends = run.probe.epoch_end_ms
    n = sum(1 for name, _ in ends if name == run.bench.EPOCH_END[0])
    return sum(ms for _, ms in ends) / n if n else None
