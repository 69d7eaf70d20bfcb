"""Evaluation: the host time inside the program's span ``irt.eval.score``
(each batch's score product), in ms a traced pass (a slice's pass in the
inductive cell)."""

from port_bench.core import spans


def read(run):
    return spans.ms_per_unit(run.trace, "irt.eval.score")
