"""Evaluator build: the host time inside the program's spans
``irt.eval.evaluator_build`` (``Evaluator.__init__``: the padded exclusion
lists of every user) and ``irt.eval.buckets`` (the users grouped by
exclusion width, built once a stage), in ms over the traced sub-window,
which is one inductive round."""

from port_bench.core import spans


def read(run):
    s = spans.host_s(run.trace, "irt.eval.evaluator_build", "irt.eval.buckets")
    return None if s is None else 1e3 * s
