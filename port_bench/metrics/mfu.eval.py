"""Whole pass: the least time the chip needs for one evaluation pass's work
(the refresh's SpMM products, the score products of every user and item,
the top-k ids written, the metric sums; ``core/roofline.py``) over the
window's time per pass (in the inductive cell, the attaches included), in
percent."""


def read(run):
    if not run.units or not run.window_s:
        return None
    return 100.0 * run.kind.pass_work(run).least_s / (run.window_s / run.units)
