"""The operations and bytes of AttIGCN's attention, counted from shapes, at
the peaks of ``core/roofline.py`` (the counts of ``PERF.md`` §6 and of the
repo's ``chip_smoke.py``: each input read once, each output written once).

Kernels of ``ops/csrc/attention_csr.cu`` (a call's work; a call of more than
one chunk is two launches, the chunks then the rows they cut, and its work
is counted once, at the chunk kernel):

- ``sddmm``: the CSR's ``row_ptr`` and ``col``, ``a`` [n_rows, h, dv], ``x``
  [n_cols, dv] and ``b`` [n_rows, h] (when given) read, [nnz, h] written;
  2·h·dv operations an edge (the scores at h heads with the bias; d(values)
  at one head without);
- ``sddmm_backward``: the CSR, ``g`` [nnz, h] and ``x`` read, d_a [n_rows, h,
  dv] and d_b [n_rows, h] written; (2·dv + 1)·h an edge;
- the softmax passes over [nnz, h] entries: the statistics pass reads the
  scores and writes m and s [n_rows, h] (5 operations an entry); the apply
  pass reads the scores, m and s and writes p [nnz, h] and the attention
  [nnz] (5); backward, the statistics pass reads p and g [nnz] and writes c
  (2), the apply pass reads p, g and c and writes g_s [nnz, h] (3).

The step's dense products (cuBLAS, fp32 with TF32 off): Wq's forward,
the fold of Wk into the query, d(q) through the fold, d(Wk) and d(Wq), each
2·n_rows·d·(h·d) operations. Nothing here imports the program."""

from __future__ import annotations

import re

from port_bench.core import roofline as R
from port_bench.core.roofline import F32, Work

SOFTMAX_STATS_OPS, SOFTMAX_APPLY_OPS = 5, 5
SOFTMAX_STATS_BACKWARD_OPS, SOFTMAX_APPLY_BACKWARD_OPS = 2, 3


def _csr(n_rows: int, nnz: int) -> float:
    return F32 * (n_rows + 1 + nnz)


def sddmm(n_rows: int, n_cols: int, nnz: int, h: int, dv: int, bias: bool) -> Work:
    n_bytes = _csr(n_rows, nnz) + F32 * (n_rows * h * dv + n_cols * dv + nnz * h + (n_rows * h if bias else 0))
    return Work(2.0 * h * dv * nnz, n_bytes)


def sddmm_backward(n_rows: int, n_cols: int, nnz: int, h: int, dv: int) -> Work:
    n_bytes = _csr(n_rows, nnz) + F32 * (nnz * h + n_cols * dv + n_rows * h * dv + n_rows * h)
    return Work((2.0 * dv + 1.0) * h * nnz, n_bytes)


def softmax_stats(n_rows: int, nnz: int, h: int) -> Work:
    return Work(float(SOFTMAX_STATS_OPS) * nnz * h, _csr(n_rows, 0) + F32 * (nnz * h + 2 * n_rows * h))


def softmax_apply(n_rows: int, nnz: int, h: int) -> Work:
    return Work(float(SOFTMAX_APPLY_OPS) * nnz * h, _csr(n_rows, 0) + F32 * (2 * nnz * h + 2 * n_rows * h + nnz))


def softmax_stats_backward(n_rows: int, nnz: int, h: int) -> Work:
    return Work(float(SOFTMAX_STATS_BACKWARD_OPS) * nnz * h, _csr(n_rows, 0) + F32 * (nnz * h + nnz + n_rows * h))


def softmax_apply_backward(n_rows: int, nnz: int, h: int) -> Work:
    return Work(float(SOFTMAX_APPLY_BACKWARD_OPS) * nnz * h,
                _csr(n_rows, 0) + F32 * (2 * nnz * h + nnz + n_rows * h))


def gemm(m: int, k: int, n: int) -> Work:
    """[m, k] @ [k, n] in fp32: both operands read once, the product written
    once."""
    return Work(2.0 * m * k * n, F32 * (m * k + k * n + m * n))


def kernel_calls(s: dict) -> dict:
    """The work of each attention-kernel call of a training step, by call.
    ``s``: n_rows, n_cols, nnz (the feature matrix's), d, heads."""
    n, c, e, d, h = s["n_rows"], s["n_cols"], s["nnz"], s["d"], s["heads"]
    return {
        "scores": sddmm(n, c, e, h, d, True),
        "d_values": sddmm(n, c, e, 1, d, False),
        "scores_backward": sddmm_backward(n, c, e, h, d),
        "softmax_stats": softmax_stats(n, e, h),
        "softmax_apply": softmax_apply(n, e, h),
        "softmax_stats_backward": softmax_stats_backward(n, e, h),
        "softmax_apply_backward": softmax_apply_backward(n, e, h),
    }


def gemms(s: dict) -> Work:
    """The step's five dense products over the feature matrix's rows: Wq
    [d, h·d] forward, the fold (per head [n, d] @ [d, d]), d(q) through the
    fold, d(Wk) and d(Wq) (each a reduction over the rows)."""
    n, d, h = s["n_rows"], s["d"], s["heads"]
    fold = gemm(n, d, d) * h
    return gemm(n, d, h * d) + fold + fold + gemm(d, n, d) * h + gemm(d, n, h * d)


def step(s: dict) -> Work:
    """One AttIGCN training step: the query product (no dropout), the
    attention kernels and the dense products, the aggregation and its
    transpose, the layer products forward and backward, the layer means, the
    batch's gathers and losses, and Adam over the table, w, Wq and Wk.
    ``s``: n_rows, n_cols, nnz, adj_nnz, d, heads, n_layers, batch,
    table_rows."""
    n, c, e, d, h, L = s["n_rows"], s["n_cols"], s["nnz"], s["d"], s["heads"], s["n_layers"]
    w = R.spmm(n, c, e, d) * 2 + R.spmm(c, n, e, d)  # the query, the aggregation, its transpose
    for call in kernel_calls(s).values():
        w = w + call
    w = w + gemms(s)
    w = w + L * 2 * R.spmm(n, n, s["adj_nnz"], d)
    w = w + 2 * R.elementwise(n * d, L + 1, 1, L + 1)
    w = w + R.elementwise(6 * s["batch"] * d, 1, 1, 4)
    return w + R.adam(s["table_rows"] * d + d + 2 * (d * h * d + h * d))


# the attention kernels' names in a device trace (demangled), and the call
# whose work a launch of each carries: a carry kernel finishes a call whose
# chunk kernel carries the work; the SDDMM kernel serves both the scores
# and d(values), one call each a step, so its launches carry their mean
_KERNELS = (
    (re.compile(r"sddmm_(vec|scalar)_kernel"), ("scores", "d_values")),
    (re.compile(r"sddmm_bwd_chunk_kernel"), ("scores_backward",)),
    (re.compile(r"softmax_stats_chunk_kernel<false"), ("softmax_stats",)),
    (re.compile(r"softmax_stats_chunk_kernel<true"), ("softmax_stats_backward",)),
    (re.compile(r"softmax_apply_kernel<false"), ("softmax_apply",)),
    (re.compile(r"softmax_apply_kernel<true"), ("softmax_apply_backward",)),
    (re.compile(r"sddmm_bwd_carry_kernel|softmax_stats_carry_kernel"), ()),
)


def kernel_share(device_events, s: dict):
    """(least seconds, device seconds) of the attention kernels among a
    trace's device events [(start_s, end_s, name)]; (0, 0) where none ran."""
    calls = kernel_calls(s)
    least = device = 0.0
    for start, end, name in device_events:
        for pattern, carried in _KERNELS:
            if pattern.search(name):
                device += end - start
                if carried:
                    least += sum(calls[k].least_s for k in carried) / len(carried)
                break
    return least, device
