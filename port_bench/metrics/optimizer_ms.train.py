"""Training loop: the host time a traced step spends inside the program's
span ``irt.train.optimizer`` (Adam's ``optimizer.step``), in ms a step."""

from port_bench.core import spans


def read(run):
    return spans.ms_per_unit(run.trace, "irt.train.optimizer")
