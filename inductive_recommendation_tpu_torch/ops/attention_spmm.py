"""Attention-weighted SpMM over the CSR layout (AttIGCN; counterpart of
``inductive_recommendation_tpu/ops/attention_spmm.py``, reference
model.py:4224-4287).

Per row r of the feature matrix, each head scores every edge (r, c), the
scores go through a softmax over the row's edges at temperature T, the
softmax is averaged over the heads, and the row's output is the
attention-weighted sum of the value rows:

    scores[e, h] = q[r_e, h] . k[c_e, h]
    attn[e]      = mean_h softmax_row(scores[:, h] / T)[e]
    out[r]       = sum over r's edges e of attn[e] * v[c_e]

The scores and the softmax are torch ops over the edges (a gather, a row
dot, ``ops.spmm.segment_softmax``); the aggregation is the hand-written
SpMM with the attention as its edge values (``ops.csr_spmm.spmm_csr_values``
on a ``values_layout``), whose backward runs the same kernel on the
transpose layout for d(v) and a gather plus row dot for d(attn). The
structure's own values are a mask only: the aggregation sums attn * v, not
val * attn * v (JAX ``attention_spmm.py:196-212``).
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, spmm_csr_values
from inductive_recommendation_tpu_torch.ops.spmm import segment_softmax


def _head_mean_attention(mat: CsrSpMM, scores: torch.Tensor, temperature: float) -> torch.Tensor:
    """fp32 [nnz]: the per-row softmax of ``scores`` [nnz, h] at
    ``temperature``, averaged over the heads (model.py:4275)."""
    return segment_softmax(scores, mat.row_ptr, temperature).mean(dim=-1)


def fused_kv_attention(mat: CsrSpMM, q, w_k, b_k, v, temperature: float) -> torch.Tensor:
    """[nnz]: the attention of :func:`attention_spmm_fused_kv` on ``mat``'s
    edges, in the inputs' dtype (torch ops only: any floating dtype on any
    device)."""
    h, dh = q.shape[1], q.shape[2]
    dv = v.shape[-1]
    qk = torch.einsum("nhd,vhd->nhv", q, w_k.reshape(dv, h, dh))
    qb = torch.einsum("nhd,hd->nh", q, b_k.reshape(h, dh))
    rows, cols = mat.edge_rows().long(), mat.col.long()
    values_sg = v.detach().index_select(0, cols)  # [nnz, dv]
    scores = torch.einsum("ehv,ev->eh", qk.index_select(0, rows), values_sg) + qb.index_select(0, rows)
    return _head_mean_attention(mat, scores, temperature)


def attention_spmm_fused_kv(mat: CsrSpMM, q, w_k, b_k, v, temperature: float) -> torch.Tensor:
    """out[r] = sum over c in N(r) of softmax_c(q[r] . (sg(v[c]) @ Wk + bk) / T) v[c]
    (JAX ``attention_spmm_fused_kv``), on a :func:`values_layout` ``mat``.

    The keys are a linear map of the detached values, so Wk folds into the
    query side: ``qk = einsum(q, Wk)`` [n_rows, h, dv], ``qb = q . bk``
    [n_rows, h], and a score is ``qk[r_e] . sg(v[c_e]) + qb[r_e]``: the
    edges gather [dv]-wide value rows, not [h * dh]-wide key rows, and
    d(Wk) flows through the dense einsum. ``q`` [n_rows, h, dh]; ``w_k``
    [dv, h * dh]; ``b_k`` [h * dh]; ``v`` [n_cols, dv]. The gradient in
    ``v`` flows through the aggregation only."""
    return spmm_csr_values(mat, v, fused_kv_attention(mat, q, w_k, b_k, v, temperature))


def attention_spmm(mat: CsrSpMM, q, k_table, v, temperature: float) -> torch.Tensor:
    """out[r] = sum over c in N(r) of softmax_c(q[r] . k[c] / T) * v[c]
    (JAX ``attention_spmm``), differentiable in all three, on a
    :func:`values_layout` ``mat``. ``q`` [n_rows, h, dh]; ``k_table``
    [n_cols, h * dh]; ``v`` [n_cols, dv]."""
    h, dh = q.shape[1], q.shape[2]
    rows, cols = mat.edge_rows().long(), mat.col.long()
    keys = k_table.index_select(0, cols).reshape(-1, h, dh)
    scores = torch.einsum("ehd,ehd->eh", q.index_select(0, rows), keys)
    return spmm_csr_values(mat, v, _head_mean_attention(mat, scores, temperature))
