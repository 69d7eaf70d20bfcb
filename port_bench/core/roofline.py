"""The yardstick's arithmetic: the published peaks of one H100 and the
operations and bytes of the work, counted from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s
fp32 outside the tensor cores, HBM3 at 3.35 TB/s (the values of the repo's
``chip_smoke.py``). A least time is the larger of operations over the peak
rate and bytes over the peak bandwidth: every input byte read once, every
output byte written once, whatever a kernel reads again.

The SpMM's count is ``chip_smoke.py::spmm_bound_ms``'s: ``row_ptr``, 8 bytes
an edge (12 with the edge id under dropout), the operand and the output once,
2 * nnz * d operations plus 100 an edge for the Philox draw under dropout.
"""

from __future__ import annotations

import dataclasses

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PHILOX_OPS_PER_EDGE = 100
F32 = 4


@dataclasses.dataclass
class Work:
    ops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other):
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def __mul__(self, n):
        return Work(self.ops * n, self.bytes * n)

    __rmul__ = __mul__

    @property
    def least_s(self) -> float:
        return max(self.ops / FP32_FLOPS, self.bytes / HBM_BYTES_PER_S)


def spmm(n_rows: int, n_cols: int, nnz: int, d: int, dropout: bool = False) -> Work:
    """One product of a CSR [n_rows, n_cols] with nnz edges and a [n_cols, d]
    operand."""
    n_bytes = F32 * (n_rows + 1) + (12 if dropout else 8) * nnz + F32 * d * (n_cols + n_rows)
    return Work((2.0 * d + (PHILOX_OPS_PER_EDGE if dropout else 0)) * nnz, n_bytes)


def elementwise(n: int, reads: int, writes: int, ops_each: int) -> Work:
    """n fp32 elements, each read ``reads`` times and written ``writes`` times
    in distinct arrays, with ``ops_each`` operations."""
    return Work(float(n) * ops_each, float(n) * F32 * (reads + writes))


def adam(n_params: int) -> Work:
    """One Adam update: reads the parameter, its gradient and both moments,
    writes the parameter and both moments; about 12 operations an element."""
    return elementwise(n_params, 4, 3, 12)


def igcn_step(shapes: dict, view_nnz: int | None) -> Work:
    """One training step of IGCN (``view_nnz`` None) or DOSE_aug: the feature
    product under dropout, the layer products, their backwards through the
    transposes, the batch's gathers and losses, the embedding's gradient
    accumulation, and Adam over the table.

    ``shapes``: n_nodes, feat_cols, feat_nnz, adj_nnz, d, n_layers, batch,
    table_rows."""
    n, fc, d, L, B = shapes["n_nodes"], shapes["feat_cols"], shapes["d"], shapes["n_layers"], shapes["batch"]
    one_pass = spmm(n, fc, shapes["feat_nnz"], d, dropout=True) + spmm(fc, n, shapes["feat_nnz"], d, dropout=True)
    layers = L * 2 * spmm(n, n, shapes["adj_nnz"], d)
    w = one_pass + layers
    # the layer mean, forward and backward: L adds and a scale over [n, d]
    w = w + 2 * elementwise(n * d, L + 1, 1, L + 1)
    # BPR + auxiliary batch: 6 gathered [B, d] rows, their scores and losses
    w = w + elementwise(6 * B * d, 1, 1, 4)
    if view_nnz is not None:
        w = w + one_pass + L * 2 * spmm(n, n, view_nnz, d) + 2 * elementwise(n * d, L + 1, 1, L + 1)
        # InfoNCE: [B, B] logits of normalized rows, forward and backward
        w = w + Work(3 * 2.0 * B * B * d, F32 * (2 * B * d + 2 * B * B))
    return w + adam(shapes["table_rows"] * d + d)


def eval_pass(shapes: dict, n_users: int, n_items: int, k: int, n_topks: int) -> Work:
    """One full-catalog pass: the representation refresh (the feature product
    and the layer products), the scores of every user against every item,
    the top-k ids of each user written once, and the metric sums (a hit test
    of each id, prefix sums, 3 metrics at each cutoff)."""
    n, fc, d, L = shapes["n_nodes"], shapes["feat_cols"], shapes["d"], shapes["n_layers"]
    w = spmm(n, fc, shapes["feat_nnz"], d) + L * spmm(n, n, shapes["adj_nnz"], d)
    w = w + elementwise(n * d, L + 1, 1, L + 1)
    w = w + score_gemm(n_users, n_items, d)
    w = w + Work(float(n_users) * k * 4 + n_users * n_topks * 3 * 4, float(n_users) * k * 8)
    return w


def score_gemm(n_users: int, n_items: int, d: int) -> Work:
    """The scores [n_users, n_items] = users @ items^T in fp32: the two rep
    matrices read once; the scores need not leave the chip."""
    return Work(2.0 * n_users * n_items * d, F32 * d * (n_users + n_items))
