"""Attention: the host time a traced step spends inside the program's
``irt.attention.*`` spans (AttIGCN's query, fold, scores, softmax and
aggregation, and the backward of the scores, the softmax and the
aggregation), their union, in ms a step."""

from port_bench.core import spans

PREFIX = "irt.attention."


def read(run):
    names = {n for _, _, n in run.trace.host if n.startswith(PREFIX)}
    return spans.ms_per_unit(run.trace, *names) if names else None
