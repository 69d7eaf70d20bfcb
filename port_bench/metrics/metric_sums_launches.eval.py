"""Evaluation: the kernel launch calls the host makes inside the program's
span ``irt.eval.metric_sums``, a traced pass (a slice's pass in the
inductive cell)."""

from port_bench.core import spans


def read(run):
    return spans.launches_per_unit(run.trace, "irt.eval.metric_sums")
