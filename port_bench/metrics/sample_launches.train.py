"""Sampler: the kernel launch calls the host makes inside the program's
span ``irt.train.sample`` (the batch draws), a traced step."""

from port_bench.core import spans


def read(run):
    return spans.launches_per_unit(run.trace, "irt.train.sample")
