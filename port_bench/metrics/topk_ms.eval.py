"""Evaluation: the host time inside the program's span ``irt.eval.topk``
(each batch's masking of the known and banned items and its top k), in ms
a traced pass (a slice's pass in the inductive cell)."""

from port_bench.core import spans


def read(run):
    return spans.ms_per_unit(run.trace, "irt.eval.topk")
