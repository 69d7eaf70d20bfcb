"""Attention: the kernel launch calls the host makes inside the program's
``irt.attention.*`` spans, a traced step."""

from port_bench.core import spans

PREFIX = "irt.attention."


def read(run):
    names = {n for _, _, n in run.trace.host if n.startswith(PREFIX)}
    return spans.launches_per_unit(run.trace, *names) if names else None
