"""Training loop: the kernel launch calls the host makes inside the
program's span ``irt.train.step`` (the whole step: sampler, forward,
backward, Adam), a traced step."""

from port_bench.core import spans


def read(run):
    return spans.launches_per_unit(run.trace, "irt.train.step")
