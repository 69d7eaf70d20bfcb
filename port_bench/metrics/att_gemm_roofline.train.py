"""Attention: the least time of a step's dense products (Wq forward, the
fold of Wk into the query, d(q) through the fold, d(Wk), d(Wq); each about
2 * n_rows * d * h * d operations at 67 TFLOP/s fp32, ``core/attention_work.py``)
over the device time the profiler gives the matrix-product kernels in the
traced sub-window, per step, in percent."""

import re

from port_bench.core import attention_work

GEMM = re.compile(r"gemm|gemv|xmma|cutlass|splitK", re.IGNORECASE)


def read(run):
    shapes = getattr(run.bench, "attention_shapes", None)
    device_s = run.trace.device_s(lambda name: bool(GEMM.search(name)))
    if shapes is None or device_s <= 0 or not run.trace.units:
        return None
    least = attention_work.gemms(shapes(run.model)).least_s
    return 100.0 * least / (device_s / run.trace.units)
