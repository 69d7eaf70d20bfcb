"""Sparse x dense products over the port's CSR layout, the layer-mean
propagation and the per-row softmax over a layout's edges (counterpart of
``inductive_recommendation_tpu/ops/spmm.py``)."""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, row_of_edges, spmm_csr


def spmm(adj: CsrSpMM, x: torch.Tensor) -> torch.Tensor:
    """out = adj @ x; the CSR layout is the port's only sparse container."""
    if not isinstance(adj, CsrSpMM):
        raise TypeError(f"unsupported sparse container {type(adj)}")
    return spmm_csr(adj, x)


def propagate_mean(adj: CsrSpMM, x0: torch.Tensor, n_layers: int) -> torch.Tensor:
    """LightGCN-style propagation: mean over the layer outputs [x0, A x0, ...]
    (reference model.py:100-110)."""
    if n_layers <= 0:
        return x0
    x, acc = x0, x0
    for _ in range(n_layers):
        x = spmm(adj, x)
        acc = acc + x
    return acc / float(n_layers + 1)


def segment_softmax(scores: torch.Tensor, row_ptr: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Per-row softmax over a CSR's edge scores, ``[nnz]`` or ``[nnz, h]``
    (h heads apart): exp((s - max) / T) over the row's sum (the AttIGCN spec,
    model.py:4270-4274; JAX ``segment_softmax``, whose T is 1). A row with
    no edges has max -inf, taken as 0; a zero sum is taken as 1. The max is
    a constant of the backward, where its gradient is 0 in exact arithmetic.
    The row sums use ``index_add`` (atomics on the card: not bitwise
    repeatable). Torch ops on any device: the plain version of
    ``ops.attention_csr.segment_softmax_csr``, whose kernel AttIGCN's
    attention runs on the card."""
    n_rows = row_ptr.shape[0] - 1
    rows = row_of_edges(row_ptr, scores.shape[0]).long()
    shape = (n_rows, *scores.shape[1:])
    index = rows.view(-1, *([1] * (scores.ndim - 1))).expand_as(scores)
    row_max = scores.new_full(shape, -torch.inf).scatter_reduce(0, index, scores.detach(), "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    ex = torch.exp((scores - row_max.index_select(0, rows)) / temperature)
    denom = scores.new_zeros(shape).index_add(0, rows, ex)
    denom = torch.where(denom > 0, denom, 1.0)
    return ex / denom.index_select(0, rows)
