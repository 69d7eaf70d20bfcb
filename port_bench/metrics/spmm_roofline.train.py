"""SpMM kernel: the least time of the traced sub-window's SpMM products
(their launches counted by route, each product's bytes and operations from
its layout's shape, ``core/roofline.py``) over the device time the profiler
gives ``spmm_chunk_kernel`` and ``spmm_carry_kernel``, in percent. The
``forward`` route's products are counted at the adjacency's size."""

from port_bench.core import roofline

KERNELS = ("spmm_chunk_kernel", "spmm_carry_kernel")


def read(run):
    device_s = run.trace.device_s(lambda name: any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    layouts = run.bench.layouts_by_route(run.model)
    least = 0.0
    for route, launches in run.trace.launches.items():
        if route not in layouts:
            return None
        n_rows, n_cols, nnz, d, dropout = layouts[route]
        # a product is two launches: the chunks, then the rows they cut
        least += (launches / 2) * roofline.spmm(n_rows, n_cols, nnz, d, dropout).least_s
    return 100.0 * least / device_s
