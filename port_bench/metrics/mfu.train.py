"""Whole step: the least time the chip needs for one training step's model
work (every SpMM product forward and backward, the layer means, the
batch's gathers and losses, Adam over the table; ``core/roofline.py``, at
67 TFLOP/s fp32 and 3.35 TB/s) over the window's time per step (epoch ends
included), in percent."""


def read(run):
    if not run.units or not run.window_s:
        return None
    return 100.0 * run.bench.step_work(run).least_s / (run.window_s / run.units)
