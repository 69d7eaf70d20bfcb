"""Representation: the median time of the refresh (``model.get_rep``, the
feature product and the layer products), from CUDA events around the
benchmark's wrapper, over the window's passes."""

import statistics


def read(run):
    times = run.probe.get_rep_ms()
    return statistics.median(times) if times else None
