"""Attention: the least time of the traced sub-window's attention-kernel
calls (the scores, d(values), the scores' gradient and the softmax's four
passes of ``ops/csrc/attention_csr.cu``, matched by name in the device
trace and each priced by ``core/attention_work.py`` at the feature matrix's
size) over the device time the profiler gives those kernels, in percent."""

from port_bench.core import attention_work


def read(run):
    shapes = getattr(run.bench, "attention_shapes", None)
    if shapes is None:
        return None
    least, device_s = attention_work.kernel_share(run.trace.device, shapes(run.model))
    return 100.0 * least / device_s if device_s > 0 else None
