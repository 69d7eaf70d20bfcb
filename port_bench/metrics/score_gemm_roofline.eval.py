"""Evaluation: the least time of a pass's score products (2 * n_users *
n_items * d operations at 67 TFLOP/s fp32, the two representation matrices
read once; ``core/roofline.py``) over the device time the profiler gives
the matrix-product kernels in the traced passes, per pass, in percent."""

import re

from port_bench.core import roofline

GEMM = re.compile(r"gemm|xmma|cutlass", re.IGNORECASE)


def read(run):
    device_s = run.trace.device_s(lambda name: bool(GEMM.search(name)))
    if device_s <= 0 or not run.trace.units:
        return None
    m = run.bench.shapes(run.model)
    least = roofline.score_gemm(run.model.n_users, run.model.n_items, m["d"]).least_s
    return 100.0 * least / (device_s / run.trace.units)
