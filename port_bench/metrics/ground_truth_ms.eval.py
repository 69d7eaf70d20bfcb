"""Evaluator build: the host time inside the program's span
``irt.eval.ground_truth`` (the six slices' lists, and each list's padded
rows on the device where no cache holds them), in ms over the traced
sub-window, which is one inductive round."""

from port_bench.core import spans


def read(run):
    s = spans.host_s(run.trace, "irt.eval.ground_truth")
    return None if s is None else 1e3 * s
