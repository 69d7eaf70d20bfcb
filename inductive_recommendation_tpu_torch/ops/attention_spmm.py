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

:func:`attention_spmm_fused_kv` folds the key map into the query (JAX
``_attention_forward_qk``): the scores are the SDDMM kernel over the folded
query ``qk`` [n_rows, h, dv], read once a row, and the gathered [dv]-wide
value rows; the softmax and its head mean are the softmax's statistics and
apply passes, forward and backward (``ops/attention_csr.py``,
``csrc/attention_csr.cu``); the
query's gradient is the SpMM kernel, one product a head. The aggregation is
the SpMM with the attention as its edge values (``ops.csr_spmm.
spmm_csr_values`` on a ``values_layout``), whose backward runs the same
kernel on the transpose layout for d(v) and the SDDMM kernel for d(attn).
The structure's own values are a mask only: the aggregation sums attn * v,
not val * attn * v (JAX ``attention_spmm.py:196-212``).
:func:`fused_kv_attention_reference` is the same attention as plain torch
ops (any dtype, any device, autograd through the ops). :func:`attention_spmm`,
with an explicit key table, stays torch ops: no model of the port calls it.
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.attention_csr import (
    attention_scores,
    segment_softmax_csr_reference,
    sddmm_csr_reference,
    softmax_head_mean,
)
from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, spmm_csr_values
from inductive_recommendation_tpu_torch.ops.spmm import segment_softmax
from inductive_recommendation_tpu_torch.utils.profiling import span


def folded_query(q, w_k, b_k, dv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(qk [n_rows, h, dv], qb [n_rows, h]): the query ``q`` [n_rows, h, dh]
    folded with the key map ``w_k`` [dv, h * dh], ``b_k`` [h * dh]."""
    h, dh = q.shape[1], q.shape[2]
    qk = torch.einsum("nhd,vhd->nhv", q, w_k.reshape(dv, h, dh))
    qb = torch.einsum("nhd,hd->nh", q, b_k.reshape(h, dh))
    return qk, qb


def fused_kv_attention(mat: CsrSpMM, q, w_k, b_k, v, temperature: float) -> torch.Tensor:
    """fp32 [nnz]: the attention of :func:`attention_spmm_fused_kv` on
    ``mat``'s edges: the folded query's scores (the SDDMM kernel), their row
    softmax and head mean (the statistics and apply passes); on CPU
    tensors the kernels' plain versions. Each part is a span:
    ``irt.attention.fold``, ``.scores``, ``.softmax``."""
    with span("irt.attention.fold"):
        qk, qb = folded_query(q, w_k, b_k, v.shape[-1])
    with span("irt.attention.scores"):
        scores = attention_scores(mat, qk, qb, v)
    with span("irt.attention.softmax"):
        return softmax_head_mean(mat, scores, temperature)


def fused_kv_attention_reference(mat: CsrSpMM, q, w_k, b_k, v, temperature: float) -> torch.Tensor:
    """:func:`fused_kv_attention` as plain torch ops (the kernels' plain
    versions, differentiable by autograd), in the inputs' dtype on any
    device."""
    qk, qb = folded_query(q, w_k, b_k, v.shape[-1])
    scores = sddmm_csr_reference(mat.row_ptr, mat.col, qk, v.detach(), qb)
    return segment_softmax_csr_reference(mat.row_ptr, scores, temperature)[1]


def attention_spmm_fused_kv(mat: CsrSpMM, q, w_k, b_k, v, temperature: float) -> torch.Tensor:
    """out[r] = sum over c in N(r) of softmax_c(q[r] . (sg(v[c]) @ Wk + bk) / T) v[c]
    (JAX ``attention_spmm_fused_kv``), on a :func:`values_layout` ``mat``.

    The keys are a linear map of the detached values, so Wk folds into the
    query side: ``qk = einsum(q, Wk)`` [n_rows, h, dv], ``qb = q . bk``
    [n_rows, h], and a score is ``qk[r_e] . sg(v[c_e]) + qb[r_e]``: the
    kernel reads a row's ``qk`` once and gathers [dv]-wide value rows, and
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
    return spmm_csr_values(mat, v, segment_softmax(scores, mat.row_ptr, temperature).mean(dim=-1))
