"""Training loop: the host time a traced step spends inside the program's
span ``irt.train.backward`` (``zero_grad`` and ``backward``, the transpose
SpMM products among them), in ms a step."""

from port_bench.core import spans


def read(run):
    return spans.ms_per_unit(run.trace, "irt.train.backward")
