"""Training loop: the host time a traced step spends inside the program's
span ``irt.train.forward`` (``batch_loss``: the representation, its SpMM
products and the losses), in ms a step."""

from port_bench.core import spans


def read(run):
    return spans.ms_per_unit(run.trace, "irt.train.forward")
