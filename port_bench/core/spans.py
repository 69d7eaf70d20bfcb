"""The program's spans in a traced sub-window: the ``record_function``
ranges the port opens while a profiler records (``utils.profiling.span``,
named ``irt.<layer>...``), read from the host events of ``core.timing.Trace``
with the CUDA runtime's launch calls, which share their clock.

- ``host_s``: the host time inside any range of the given names (their
  union, so nested or repeated ranges count once);
- ``launches``: the launch calls whose interval lies inside one of them.

Both return None where the trace holds no such range (a program without
the span), and ``launches`` also where it holds no launch call at all (the
CPU)."""

from __future__ import annotations

import bisect

# host runtime calls that start work on the device
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def intervals(trace, *names) -> list:
    """The union of the host ranges named ``names``, as sorted disjoint
    (start_s, end_s) pairs."""
    merged = []
    for s, e in sorted((s, e) for s, e, n in trace.host if n in names):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def host_s(trace, *names):
    spans = intervals(trace, *names)
    return sum(e - s for s, e in spans) if spans else None


def launches(trace, *names):
    spans = intervals(trace, *names)
    calls = [(s, e) for s, e, n in trace.host if n.startswith(LAUNCH_PREFIXES)]
    if not spans or not calls:
        return None
    starts = [s for s, _ in spans]
    count = 0
    for s, e in calls:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= spans[i][1]:
            count += 1
    return count


def ms_per_unit(trace, *names):
    """Host ms inside the spans, per unit (step or pass) of the sub-window."""
    s = host_s(trace, *names)
    return None if s is None or not trace.units else 1e3 * s / trace.units


def launches_per_unit(trace, *names):
    n = launches(trace, *names)
    return None if n is None or not trace.units else n / trace.units
