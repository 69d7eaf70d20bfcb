"""The edge-sharded attention aggregation of AttIGCN (counterpart of
``inductive_recommendation_tpu/parallel/attention.py``).

The feature matrix is column-block sharded (``parallel/spmm.py``), so a
row's edges span the ranks of a 'model' group and its softmax needs two
small cross-rank reductions over ``[n_rows_pad, h]`` row statistics:

    all-gather:  qk, qb      the folded query (qk = q @ Wk^T per head,
                             qb = q . bk), row-sharded, gathered whole
    per shard:   scores[e] = qk[row_e] . sg(v_local[col_e]) + qb[row_e]
                             (the SDDMM kernel, ``ops/attention_csr.py``)
                 rmax_s[r] = max over the shard's edges of row r
    all-reduce:  rmax[r]   = max_s rmax_s[r]          (op MAX, detached)
    per shard:   ex[e]     = exp((scores[e] - rmax[row_e]) / T)
                 den_s[r]  = sum over the shard's edges of row r
    all-reduce:  den[r]    = sum_s den_s[r]
    per shard:   attn[e]   = mean_h ex[e] / den[row_e]
                 partial   = A_attn[:, blk_s] @ v_s   (the hand-written
                                                       kernel, values layout)
    reduce-scatter: out    = this rank's rows of the sum

as the single-device ``ops/attention_spmm.py`` computes it (a row with no
edges has max 0 and sum 1). The row maxima are a constant of the backward
(their gradient is 0 in exact arithmetic). The gradient convention is
torch's (``parallel/collectives.py``): each rank reads the gathered query
and the summed row sums for its own edges, so their backwards reduce-scatter
and all-reduce the cotangents (JAX's ``shard_map`` transposes its own
collectives instead).
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.attention_csr import attention_scores
from inductive_recommendation_tpu_torch.parallel.collectives import all_reduce_max, gather_rows_grad, partial_sum
from inductive_recommendation_tpu_torch.parallel.spmm import EdgeShardedSpMM, edge_sharded_spmm_values


def shard_scores(emat: EdgeShardedSpMM, qk: torch.Tensor, qb: torch.Tensor, v: torch.Tensor):
    """(scores [nnz of the shard, h], each edge's global row): the folded
    query ``qk`` [n_rows_pad, h, dv] / ``qb`` [n_rows_pad, h] (whole) against
    the detached value rows ``v`` [block, dv] of this rank, through the SDDMM
    kernel on the shard's forward CSR with the query's row window
    ``[row_lo, row_hi)`` (``ops.attention_csr.attention_scores``; its
    backward is the SpMM kernel on the same CSR, one product a head)."""
    fwd, lo = emat.fwd, emat.row_lo
    scores = attention_scores(fwd, qk[lo : emat.row_hi], qb[lo : emat.row_hi], v)
    return scores, fwd.edge_rows().long() + lo


def shard_row_max(emat: EdgeShardedSpMM, scores: torch.Tensor, g_rows: torch.Tensor) -> torch.Tensor:
    """[n_rows_pad, h]: each row's largest score on this shard (-inf for a
    row with none), detached."""
    h = scores.shape[1]
    out = scores.new_full((emat.n_rows_pad, h), -torch.inf)
    return out.scatter_reduce_(0, g_rows[:, None].expand(-1, h), scores.detach(), "amax")


def shard_exp(scores: torch.Tensor, row_max: torch.Tensor, g_rows: torch.Tensor, temperature: float):
    """(exp((scores - row max) / T) per edge, this shard's row sums of them
    [n_rows_pad, h]); ``row_max`` the rows' maxima over every shard."""
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    ex = torch.exp((scores - row_max.index_select(0, g_rows)) / temperature)
    return ex, scores.new_zeros(row_max.shape).index_add(0, g_rows, ex)


def shard_attention_from(ex: torch.Tensor, den: torch.Tensor, g_rows: torch.Tensor) -> torch.Tensor:
    """[nnz of the shard]: the head mean of ``ex`` over the rows' sums over
    every shard ``den`` (a zero sum taken as 1)."""
    den = torch.where(den > 0, den, 1.0)
    return (ex / den.index_select(0, g_rows)).mean(dim=-1)


def sharded_attention(emat: EdgeShardedSpMM, qk: torch.Tensor, qb: torch.Tensor, v: torch.Tensor,
                      temperature: float, group) -> torch.Tensor:
    """fp32 [nnz of the shard]: the head-mean attention on this rank's
    edges, in the shard's edge order. ``qk`` [n_rows_pad, h, dv] and ``qb``
    [n_rows_pad, h] are the whole folded query (gathered); ``v`` [block, dv]
    this rank's value rows."""
    scores, g_rows = shard_scores(emat, qk, qb, v)
    row_max = all_reduce_max(shard_row_max(emat, scores, g_rows), group)
    ex, den = shard_exp(scores, row_max, g_rows, temperature)
    return shard_attention_from(ex, partial_sum(den, group), g_rows)


def edge_sharded_attention(emat: EdgeShardedSpMM, qk_local: torch.Tensor, qb_local: torch.Tensor,
                           v: torch.Tensor, temperature: float, group) -> torch.Tensor:
    """This rank's ``[row_block, dv]`` rows of the attention aggregation:
    the folded query's row blocks ``qk_local`` [row_block, h, dv] and
    ``qb_local`` [row_block, h] gathered, the attention on the shard's
    edges, and the product with it as edge values on ``emat``, a
    ``values_shard`` (JAX ``make_edge_sharded_attention``)."""
    qk = gather_rows_grad(qk_local.contiguous(), group)
    qb = gather_rows_grad(qb_local.contiguous(), group)
    attn = sharded_attention(emat, qk, qb, v, temperature, group)
    return edge_sharded_spmm_values(emat, v, attn, group)
