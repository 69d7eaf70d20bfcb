"""The edge-sharded attention aggregation of AttIGCN (counterpart of
``inductive_recommendation_tpu/parallel/attention.py``).

The feature matrix is column-block sharded (``parallel/spmm.py``), so a
row's edges span the ranks of a 'model' group and its softmax needs two
small cross-rank reductions over ``[n_rows_pad, h]`` row statistics, which
come between the two passes of the single-device softmax
(``ops/attention_csr.py``, ``csrc/attention_csr.cu``):

    all-gather:  qk, qb      the folded query (qk = q @ Wk^T per head,
                             qb = q . bk), row-sharded, gathered whole
    per shard:   scores[e] = qk[row_e] . sg(v_local[col_e]) + qb[row_e]
                             (the SDDMM kernel)
                 m_s, s_s  = the statistics pass on the shard's CSR: each
                             row's max and sum of exp((x - m_s) / T) over
                             the shard's edges (m_s = -inf, s_s = 0 for none)
    all-reduce:  m[r]      = max_s m_s[r]                       (op MAX)
    all-reduce:  s[r]      = sum_s s_s[r] exp((m_s[r] - m[r]) / T)
    per shard:   p, attn   = the apply pass: exp((x - m) / T) / s, its
                             head mean
                 partial   = A_attn[:, blk_s] @ v_s   (the hand-written
                                                       kernel, values layout)
    reduce-scatter: out    = this rank's rows of the sum

as the single-device ``ops/attention_spmm.py`` computes it (a row with no
edges has max 0 and sum 1). The backward (``_ShardSoftmaxMean``) is the
statistics pass in backward mode (c[r] = sum p g over the shard's edges), an
all-reduce of c, and the apply pass in backward mode. The gradient
convention is torch's (``parallel/collectives.py``): each rank's backward
gives its part of the one loss's gradient, so the gathered query's backward
reduce-scatters, and c sums every rank's edges (JAX's ``shard_map``
transposes its own collectives instead).
"""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops.attention_csr import (
    attention_scores,
    rescale_stats,
    softmax_apply,
    softmax_apply_backward,
    softmax_stats,
    softmax_stats_backward,
)
from inductive_recommendation_tpu_torch.ops.csr_spmm import route_key
from inductive_recommendation_tpu_torch.parallel.collectives import all_reduce, all_reduce_max, gather_rows_grad
from inductive_recommendation_tpu_torch.parallel.spmm import EdgeShardedSpMM, edge_sharded_spmm_values


def shard_scores(emat: EdgeShardedSpMM, qk: torch.Tensor, qb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[nnz of the shard, h]: the folded query ``qk`` [n_rows_pad, h, dv] /
    ``qb`` [n_rows_pad, h] (whole) against the detached value rows ``v``
    [block, dv] of this rank, through the SDDMM kernel on the shard's
    forward CSR with the query's row window ``[row_lo, row_hi)``
    (``ops.attention_csr.attention_scores``; its backward is the SpMM kernel
    on the same CSR, one product a head)."""
    lo, hi = emat.row_lo, emat.row_hi
    return attention_scores(emat.fwd, qk[lo:hi], qb[lo:hi], v)


def shard_stats(emat: EdgeShardedSpMM, scores: torch.Tensor, temperature: float):
    """(m, s) [n_rows_pad, h]: the statistics pass over the shard's edges,
    at the global rows (-inf and 0 where the shard has no edge)."""
    h, lo, hi = scores.shape[1], emat.row_lo, emat.row_hi
    m = scores.new_full((emat.n_rows_pad, h), -torch.inf)
    s = scores.new_zeros(emat.n_rows_pad, h)
    softmax_stats(emat.fwd.row_ptr, scores, temperature, route_key(emat.fwd), out=(m[lo:hi], s[lo:hi]))
    return m, s


def shard_apply(emat: EdgeShardedSpMM, scores: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                temperature: float):
    """(p [nnz of the shard, h], attn [nnz of the shard]): the apply pass
    from the statistics over every shard (m, s) [n_rows_pad, h]."""
    lo, hi = emat.row_lo, emat.row_hi
    return softmax_apply(emat.fwd.row_ptr, scores, m[lo:hi], s[lo:hi], temperature, route_key(emat.fwd))


class _ShardSoftmaxMean(torch.autograd.Function):
    """attn [nnz of the shard]: the head mean of the row softmax of the
    shard's scores over every shard's edges (the statistics pass, the MAX
    all-reduce of the maxima, the all-reduce of the sums rescaled to them,
    the apply pass). Backward: the statistics pass in backward mode, one
    all-reduce of its sums, the apply pass in backward mode."""

    @staticmethod
    def forward(ctx, scores, emat, temperature, group):
        m, s = shard_stats(emat, scores, temperature)
        m_all = all_reduce_max(m.clone(), group)
        s = all_reduce(rescale_stats(m, s, m_all, temperature), group)
        p, attn = shard_apply(emat, scores, m_all, s, temperature)
        ctx.emat, ctx.temperature, ctx.group = emat, temperature, group
        ctx.save_for_backward(p)
        return attn

    @staticmethod
    def backward(ctx, g):
        (p,), emat, lo, hi = ctx.saved_tensors, ctx.emat, ctx.emat.row_lo, ctx.emat.row_hi
        route, g = route_key(emat.fwd), g.contiguous()
        c = p.new_zeros(emat.n_rows_pad, p.shape[1])
        softmax_stats_backward(emat.fwd.row_ptr, p, g, route, out=c[lo:hi])
        c = all_reduce(c, ctx.group)
        return softmax_apply_backward(emat.fwd.row_ptr, p, g, c[lo:hi], ctx.temperature, route), None, None, None


def sharded_attention(emat: EdgeShardedSpMM, qk: torch.Tensor, qb: torch.Tensor, v: torch.Tensor,
                      temperature: float, group) -> torch.Tensor:
    """fp32 [nnz of the shard]: the head-mean attention on this rank's
    edges, in the shard's edge order. ``qk`` [n_rows_pad, h, dv] and ``qb``
    [n_rows_pad, h] are the whole folded query (gathered); ``v`` [block, dv]
    this rank's value rows."""
    return _ShardSoftmaxMean.apply(shard_scores(emat, qk, qb, v), emat, temperature, group)


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
