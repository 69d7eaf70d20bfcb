"""AttIGCN's attention over the CSR layout: the hand-written CUDA kernels of
``csrc/attention_csr.cu``, their plain PyTorch versions, and the autograd
Functions that chain them.

- ``sddmm_csr``: ``out[e, j] = a[r_e, j, :] . x[c_e, :] (+ b[r_e, j])`` for
  ``j < h <= 8``: the scores from the folded query (``a`` = qk, ``b`` = qb,
  ``x`` = the detached value table), and d(values) of the product with
  learned edge values (h = 1, ``a`` = the output's cotangent).
- ``segment_softmax_csr``: the per-row softmax of each head at temperature
  T and its head mean (``ops.spmm.segment_softmax(...).mean(-1)``), with the
  per-head softmax ``p`` kept for the backward.
- ``segment_softmax_csr_backward``: ``g_s[e, j] = p[e, j] (g[e] - sum_row
  p[., j] g[.]) / (h T)``, the scores' cotangent from the attention's.

A CUDA tensor runs the kernel (or the wrapper raises); a CPU tensor runs the
plain version. Each kernel launch adds one to ``route_launches`` under
``"<kernel>/<route>"`` (keys in ``ROUTES``); ``reset_launch_counts()`` zeroes
them.

The query's gradient needs no kernel of its own: ``d_qk[:, j, :] = A_{g_s[:,
j]} @ v`` is the SpMM kernel (``csrc/spmm_csr.cu``) on the attention's CSR
with head j's score cotangent as edge values, one product a head, counted
under the layout's route plus ``_dq``. The products run on ``[v | 1 | 0 0
0]``, so the ones column gives each row's sum of g_s, d(qb), in the same
pass (the zeros keep the width a multiple of 4, the kernel's 16-byte path).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, _product, route_key, row_of_edges
from inductive_recommendation_tpu_torch.ops.spmm import segment_softmax

MAX_HEADS = 8  # kMaxHeads in csrc/attention_csr.cu
LONG_ROW = 256  # kLongRow: the softmax kernels give a longer row a block of its own

# the keys of route_launches
ROUTES = (
    "sddmm_csr/attention", "sddmm_csr/attention_d_values",
    "sddmm_csr/edge_shard_attention", "sddmm_csr/edge_shard_attention_d_values",
    "segment_softmax_csr/attention", "segment_softmax_csr_backward/attention",
)
route_launches: dict[str, int] = {}


def reset_launch_counts():
    """Set every kernel's count, by route, to 0."""
    route_launches.clear()
    route_launches.update(dict.fromkeys(ROUTES, 0))


reset_launch_counts()


def _count(kernel: str, route: str):
    key = f"{kernel}/{route}"
    route_launches[key] = route_launches.get(key, 0) + 1


def _check_cuda(dtypes: dict, **tensors):
    """Raises unless every tensor is a contiguous CUDA tensor of its dtype on
    one device."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every operand on one cuda device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtypes.get(name, torch.float32):
            raise TypeError(f"{name} must be {dtypes.get(name, torch.float32)}, got {t.dtype}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(f"{name} requires grad; the kernels record no autograd")
    return device


_INDEX = {"row_ptr": torch.int32, "col": torch.int32}


def _launch(fn: str, *args):
    err = getattr(_build.load("attention_csr"), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")


def _run(tensors, reference, cuda):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return cuda()
    if kinds == {"cpu"}:
        return reference()
    raise ValueError(f"the attention kernels run on cuda or cpu tensors, all on one, not {sorted(kinds)}")


# -- K1: sddmm_csr -----------------------------------------------------------------


def _check_sddmm(row_ptr, col, a, x, b):
    n_rows = row_ptr.shape[0] - 1
    if a.ndim != 3 or a.shape[0] != n_rows or a.shape[2] != x.shape[-1] or x.ndim != 2:
        raise ValueError(f"a must be [n_rows={n_rows}, h, dv] and x [n_cols, dv]; got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}")
    if not 1 <= a.shape[1] <= MAX_HEADS:
        raise ValueError(f"h = {a.shape[1]} heads; the kernel takes 1 to {MAX_HEADS}")
    if b is not None and b.shape != a.shape[:2]:
        raise ValueError(f"b must be [n_rows, h] = {tuple(a.shape[:2])}, got {tuple(b.shape)}")


def sddmm_csr_reference(row_ptr, col, a, x, b=None) -> torch.Tensor:
    """Plain PyTorch version: ``[nnz, h]``, ``a[r_e] . x[c_e]`` per head (+
    ``b[r_e]``), by a gather of a's rows per edge and a row dot."""
    rows = row_of_edges(row_ptr, col.shape[0]).long()
    out = torch.einsum("ehv,ev->eh", a.index_select(0, rows), x.index_select(0, col.long()))
    return out if b is None else out + b.index_select(0, rows)


def sddmm_csr_cuda(row_ptr, col, a, x, b=None, route="attention") -> torch.Tensor:
    """Launch ``sddmm_csr`` on the current stream; fp32 [nnz, h]."""
    tensors = dict(row_ptr=row_ptr, col=col, a=a, x=x, **({} if b is None else {"b": b}))
    device = _check_cuda(_INDEX, **tensors)
    _check_sddmm(row_ptr, col, a, x, b)
    n_rows, nnz, h, dv = row_ptr.shape[0] - 1, col.shape[0], a.shape[1], x.shape[1]
    if nnz >= 2**31:
        raise ValueError("the kernel indexes edges with int32")
    out = torch.empty(nnz, h, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("sddmm_csr", row_ptr.data_ptr(), col.data_ptr(), a.data_ptr(), x.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(), n_rows, nnz, h, dv, stream)
    _count("sddmm_csr", route)
    return out


def sddmm_csr(row_ptr, col, a, x, b=None, route="attention") -> torch.Tensor:
    """``out[e, j] = a[r_e, j, :] . x[col[e], :] (+ b[r_e, j])``: the kernel on
    CUDA tensors (counted under ``route``), the plain version on CPU ones.
    ``a`` [n_rows, h, dv], ``x`` [n_cols, dv], ``b`` None or [n_rows, h]."""
    ts = [row_ptr, col, a, x] + ([] if b is None else [b])
    return _run(
        ts,
        lambda: sddmm_csr_reference(row_ptr, col, a, x, b),
        lambda: sddmm_csr_cuda(row_ptr, col, a.contiguous(), x.contiguous(),
                               None if b is None else b.contiguous(), route),
    )


# -- K2: segment_softmax_csr ---------------------------------------------------------

_long_rows = WeakTensorKeyDictionary()


def long_rows(row_ptr: torch.Tensor) -> torch.Tensor:
    """int32 indices of the rows with more than ``LONG_ROW`` edges, which the
    softmax kernels give a block each: found once for each ``row_ptr``
    tensor (a read of their count to the host) and kept while it lives."""
    rows = _long_rows.get(row_ptr)
    if rows is None:
        rows = torch.nonzero(torch.diff(row_ptr) > LONG_ROW).flatten().to(torch.int32)
        _long_rows[row_ptr] = rows
    return rows


def segment_softmax_csr_reference(row_ptr, scores, temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (p [nnz, h], the per-row softmax of each head at
    ``temperature`` (``ops.spmm.segment_softmax``), and its head mean [nnz])."""
    p = segment_softmax(scores, row_ptr, temperature)
    return p, p.mean(dim=-1)


def segment_softmax_csr_cuda(row_ptr, scores, temperature: float, route="attention"):
    """Launch ``segment_softmax_csr`` on the current stream: (p, attn)."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, scores=scores)
    if scores.ndim != 2 or not 1 <= scores.shape[1] <= MAX_HEADS:
        raise ValueError(f"scores must be [nnz, h <= {MAX_HEADS}], got {tuple(scores.shape)}")
    n_rows, (nnz, h) = row_ptr.shape[0] - 1, scores.shape
    p = torch.empty(nnz, h, dtype=torch.float32, device=device)
    attn = torch.empty(nnz, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rows = long_rows(row_ptr)
        _launch("segment_softmax_csr", row_ptr.data_ptr(), rows.data_ptr(), rows.shape[0], scores.data_ptr(),
                p.data_ptr(), attn.data_ptr(), n_rows, h, float(temperature), stream)
    _count("segment_softmax_csr", route)
    return p, attn


def segment_softmax_csr(row_ptr, scores, temperature: float, route="attention"):
    """(p [nnz, h], attn [nnz]): the per-row softmax of every head of
    ``scores`` at ``temperature`` and its head mean; a row with no edges
    writes nothing, a zero sum is taken as 1."""
    return _run(
        [row_ptr, scores],
        lambda: segment_softmax_csr_reference(row_ptr, scores, temperature),
        lambda: segment_softmax_csr_cuda(row_ptr, scores.contiguous(), temperature, route),
    )


# -- K3: segment_softmax_csr_backward -------------------------------------------------


def segment_softmax_csr_backward_reference(row_ptr, p, g, temperature: float) -> torch.Tensor:
    """Plain PyTorch version: ``g_s = p (g - c[row]) / (h T)`` with ``c[r, j]
    = sum over r's edges of p[., j] g[.]``."""
    rows = row_of_edges(row_ptr, p.shape[0]).long()
    c = p.new_zeros(row_ptr.shape[0] - 1, p.shape[1]).index_add_(0, rows, p * g[:, None])
    return p * (g[:, None] - c.index_select(0, rows)) / (p.shape[1] * temperature)


def segment_softmax_csr_backward_cuda(row_ptr, p, g, temperature: float, route="attention") -> torch.Tensor:
    """Launch ``segment_softmax_csr_backward`` on the current stream: g_s."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, p=p, g=g)
    if p.ndim != 2 or not 1 <= p.shape[1] <= MAX_HEADS or g.shape != p.shape[:1]:
        raise ValueError(f"p must be [nnz, h <= {MAX_HEADS}] and g [nnz]; got {tuple(p.shape)}, {tuple(g.shape)}")
    n_rows, (nnz, h) = row_ptr.shape[0] - 1, p.shape
    g_s = torch.empty(nnz, h, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rows = long_rows(row_ptr)
        _launch("segment_softmax_csr_backward", row_ptr.data_ptr(), rows.data_ptr(), rows.shape[0], p.data_ptr(),
                g.data_ptr(), g_s.data_ptr(), n_rows, h, float(temperature), stream)
    _count("segment_softmax_csr_backward", route)
    return g_s


def segment_softmax_csr_backward(row_ptr, p, g, temperature: float, route="attention") -> torch.Tensor:
    """The scores' cotangent [nnz, h] from the head-mean attention's ``g``
    [nnz], given the forward's per-head softmax ``p``."""
    return _run(
        [row_ptr, p, g],
        lambda: segment_softmax_csr_backward_reference(row_ptr, p, g, temperature),
        lambda: segment_softmax_csr_backward_cuda(row_ptr, p.contiguous(), g.contiguous(), temperature, route),
    )


# -- autograd ---------------------------------------------------------------------------


def dq_route(mat: CsrSpMM) -> str:
    """The route the query-gradient products on ``mat`` count under."""
    return f"{mat.route or 'attention'}_dq"


class _Scores(torch.autograd.Function):
    """scores [nnz, h] = qk[r_e] . v[c_e] + qb[r_e] (K1) on ``mat``'s edges;
    ``v`` is the detached value table and gets no gradient. Backward: per
    head j the SpMM kernel on ``mat`` with g_s[:, j] as edge values, on [v |
    1 | 0 0 0]: d_qk[:, j] and, in the ones column, d_qb[:, j]."""

    @staticmethod
    def forward(ctx, qk, qb, v, mat):
        ctx.mat = mat
        ctx.save_for_backward(v)
        return sddmm_csr(mat.row_ptr, mat.col, qk, v, qb, route=route_key(mat))

    @staticmethod
    def backward(ctx, g_s):
        mat, (v,) = ctx.mat, ctx.saved_tensors
        n, dv = v.shape
        v1 = torch.cat([v, v.new_ones(n, 1), v.new_zeros(n, 3)], dim=1).contiguous()
        dmat = dataclasses.replace(mat, route=dq_route(mat))
        d = torch.stack([_product(dataclasses.replace(dmat, val=g_s[:, j].contiguous()), v1)
                         for j in range(g_s.shape[1])], dim=1)
        return d[:, :, :dv], d[:, :, dv], None, None


class _SoftmaxMean(torch.autograd.Function):
    """attn [nnz] = the head mean of the per-row softmax of scores / T (K2);
    backward K3 from the kept per-head softmax."""

    @staticmethod
    def forward(ctx, scores, mat, temperature):
        p, attn = segment_softmax_csr(mat.row_ptr, scores, temperature, route=route_key(mat))
        ctx.mat, ctx.temperature = mat, temperature
        ctx.save_for_backward(p)
        return attn

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        g_s = segment_softmax_csr_backward(ctx.mat.row_ptr, p, g, ctx.temperature, route=route_key(ctx.mat))
        return g_s, None, None


def attention_scores(mat: CsrSpMM, qk: torch.Tensor, qb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[nnz, h]: ``qk[r_e] . sg(v[c_e]) + qb[r_e]`` on ``mat``'s edges,
    differentiable in ``qk`` [n_rows, h, dv] and ``qb`` [n_rows, h]."""
    return _Scores.apply(qk, qb, v.detach(), mat)


def softmax_head_mean(mat: CsrSpMM, scores: torch.Tensor, temperature: float) -> torch.Tensor:
    """[nnz]: the per-row softmax of ``scores`` [nnz, h] at ``temperature``,
    averaged over the heads, differentiable in ``scores``."""
    return _SoftmaxMean.apply(scores, mat, temperature)
