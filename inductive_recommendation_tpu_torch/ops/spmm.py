"""Sparse x dense products over the port's CSR layout, and the layer-mean
propagation (counterpart of ``inductive_recommendation_tpu/ops/spmm.py``)."""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, spmm_csr


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
