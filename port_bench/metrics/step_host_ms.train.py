"""Training loop: the median host time ``trainer.step`` took to return
over the window's steps (the benchmark's wrapper; no synchronise, so it is
the host's share of a step when the device keeps up)."""

import statistics


def read(run):
    times = run.probe.step_host_ms
    return statistics.median(times) if times else None
