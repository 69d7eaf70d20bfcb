"""Edge-block-sharded SpMM: the graph itself split over the 'model' ranks
(counterpart of ``inductive_recommendation_tpu/parallel/spmm.py``).

A's columns, and the rows of the ``[n, d]`` operand, are cut into S
contiguous blocks. Rank s holds the CSR of its column block ``A[:, blk_s]``
over the rows that hold its edges, ``[lo_s, hi_s)``, and of its transpose,
both run by the hand-written kernel (``ops/csrc/spmm_csr.cu``) like any
other layout:

    forward:   partial_s = A[lo_s:hi_s, blk_s] @ x_s    (the kernel)
               out_s     = reduce_scatter(partial)      (rows sharded; the
                                                         partial 0 outside
                                                         [lo_s, hi_s))
    backward:  g         = all_gather(g_s)              (every row of out)
               dx_s      = A[lo_s:hi_s, blk_s]^T @ g[lo_s:hi_s]
                                                        (the kernel, transpose CSR)

The row window matters for a bipartite graph: a block of user columns has
its edges in item rows only and a block of item columns in user rows only,
and a layout over every row would hand the kernel a long run of empty rows.

One reduce-scatter forward and one all-gather backward per product; neither
x nor dx is whole on any rank. With a square matrix the output's row blocks
are the input's, so GCN layers chain with no re-sharding
(:func:`make_edge_sharded_propagation`). The ``replicated`` mode all-reduces
the forward instead (every rank gets all of out); its backward takes the
cotangent as it is (``collectives.replicated_sum``: torch gives every rank
the whole cotangent of a loss they all compute alike, where JAX's shard_map
gives each 1/S and psums it).

Edge ids: a shard's CSR carries the GLOBAL edge id (the position in the raw
COO input, numbered before zero-valued entries are dropped, as
``build_csr_spmm`` numbers them). So a global ``edge_scale`` vector reaches
each shard as it is, and the kernel's dropout, drawn from ``(seed, eid)``,
drops exactly the edges the single-device product drops under the same
seed. The JAX package draws i.i.d. per shard instead (a hash of the shard
index and the local edge id, its spmm.py:349-353): the same keep/rescale
algebra, other masks. Every rank of a 'model' group passes the same seed.

Per-epoch layouts (a DOSE / SGL view, DOSE_aug2's augmented feature matrix)
are built on the device each epoch; :func:`shard_csr` cuts this rank's
column block out of such a whole CSR there, with the same row window and
the whole layout's edge ids, and builds the block's transpose from the same
triples (a block of a symmetric view is not symmetric). Their launches
count under their own routes (``edge_shard_view``, ``edge_shard_aug_feat``).
:func:`edge_sharded_spmm_values` is the product with per-edge values given
as an argument (AttIGCN's attention), differentiable in both, on a shard's
:func:`values_shard`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from inductive_recommendation_tpu_torch.ops.csr_spmm import (
    CsrSpMM,
    _check_dropout,
    _one_side,
    _product,
    csr_on_device,
    spmm_csr_values,
    values_layout,
    with_annealed_values,
)
from inductive_recommendation_tpu_torch.parallel.collectives import all_gather, all_reduce, reduce_scatter, scatter_rows
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, local_rows, mesh_device

ROUTE = "edge_shard"


@dataclasses.dataclass(frozen=True)
class EdgeShardedSpMM:
    """This rank's shard of a column-block-sharded ``[n_rows, n_cols]`` A.

    ``fwd`` is ``A[row_lo:row_hi, blk_rank]``, the column block over the
    rows that hold its edges, as a ``[row_hi - row_lo x block]`` CSR carrying
    its transpose (route ``edge_shard``); its ``eid`` are global edge ids.
    ``eid_map`` [nnz_shard] int64 lists the shard's global edge ids in raw
    COO order (local slot -> global id). ``nnz`` counts every shard's edges."""

    fwd: CsrSpMM
    eid_map: torch.Tensor
    n_rows: int
    n_cols: int
    n_rows_pad: int  # a multiple of n_shards (reduce-scatter blocks)
    n_cols_pad: int  # a multiple of n_shards (operand blocks)
    n_shards: int
    rank: int
    nnz: int
    row_lo: int  # the first row holding an edge of the block
    row_hi: int  # one past the last

    @property
    def block(self) -> int:
        """Rows of the operand a rank holds: its column block's width."""
        return self.n_cols_pad // self.n_shards

    @property
    def row_block(self) -> int:
        """Rows of the scattered output a rank holds."""
        return self.n_rows_pad // self.n_shards

    @property
    def bwd(self) -> CsrSpMM:
        return self.fwd.T


def _padded(n_rows, n_cols, n_shards):
    return -(-n_rows // n_shards) * n_shards, -(-n_cols // n_shards) * n_shards


def build_edge_sharded_spmm(row, col, val, shape, n_shards: int, rank: int, device="cpu") -> EdgeShardedSpMM:
    """Rank ``rank``'s shard, from the whole (coalesced) COO arrays (numpy).

    Columns split into ``n_shards`` contiguous blocks; both dimensions pad to
    multiples of ``n_shards`` (pad rows and columns hold no edge). Only this
    rank's CSR and transpose are built (JAX spmm.py:175-219 builds every
    shard's), over the rows that hold the block's edges."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside {n_shards} shards")
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    val = np.asarray(val, dtype=np.float32)
    eid = np.arange(len(row), dtype=np.int64)  # raw order, before the zero filter
    nz = val != 0.0
    row, col, val, eid = row[nz], col[nz], val[nz], eid[nz]
    if len(eid) and eid[-1] >= 2**31:
        raise ValueError(f"edge id {eid[-1]} does not fit the int32 CSR")
    n_rows, n_cols = (int(s) for s in shape)
    n_rows_pad, n_cols_pad = _padded(n_rows, n_cols, n_shards)
    blk = n_cols_pad // n_shards
    m = (col >= rank * blk) & (col < (rank + 1) * blk)
    r, c, v, e = row[m], col[m] - rank * blk, val[m], eid[m]
    lo, hi = (int(r.min()), int(r.max()) + 1) if len(r) else (0, 0)
    transpose = _one_side(c, r - lo, v, e, blk, hi - lo, device, transposed=True, route=ROUTE)
    fwd = _one_side(r - lo, c, v, e, hi - lo, blk, device, transpose=transpose, route=ROUTE)
    return EdgeShardedSpMM(
        fwd=fwd,
        eid_map=torch.as_tensor(e, device=device),
        n_rows=n_rows,
        n_cols=n_cols,
        n_rows_pad=n_rows_pad,
        n_cols_pad=n_cols_pad,
        n_shards=int(n_shards),
        rank=int(rank),
        nnz=int(len(eid)),
        row_lo=lo,
        row_hi=hi,
    )


def build_edge_sharded_on_device(rows, cols, vals, eid, shape, n_shards: int, rank: int,
                                 route: str = ROUTE) -> EdgeShardedSpMM:
    """Rank ``rank``'s shard from COO triples already on a device (int64
    ``rows`` / ``cols`` / ``eid``, fp32 ``vals``, torch tensors), built there:
    the column block filtered on the device, the row window read back as two
    integers, the block's CSR and its transpose built from the same triples
    (``ops.csr_spmm.csr_on_device``) with the global edge ids ``eid``."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside {n_shards} shards")
    n_rows, n_cols = (int(x) for x in shape)
    n_rows_pad, n_cols_pad = _padded(n_rows, n_cols, n_shards)
    blk = n_cols_pad // n_shards
    if eid.numel() and int(eid.max()) >= 2**31:
        raise ValueError(f"edge id {int(eid.max())} does not fit the int32 CSR")
    m = (cols >= rank * blk) & (cols < (rank + 1) * blk) & (vals != 0)
    r, c, v, e = rows[m], cols[m] - rank * blk, vals[m], eid[m]
    lo, hi = (0, 0) if r.numel() == 0 else (int(x) for x in torch.stack([r.min(), r.max() + 1]).tolist())
    transpose = csr_on_device(c, r - lo, v, (blk, hi - lo), eid=e, transposed=True, route=route)
    fwd = csr_on_device(r - lo, c, v, (hi - lo, blk), eid=e, transpose=transpose, route=route)
    return EdgeShardedSpMM(
        fwd=fwd, eid_map=e, n_rows=n_rows, n_cols=n_cols, n_rows_pad=n_rows_pad, n_cols_pad=n_cols_pad,
        n_shards=int(n_shards), rank=int(rank), nnz=int((vals != 0).sum()), row_lo=lo, row_hi=hi,
    )


def shard_csr(mat: CsrSpMM, mesh, route: str) -> EdgeShardedSpMM:
    """This rank's shard of a whole CSR built on the device (a per-epoch
    view or augmented feature matrix), with ``mat``'s edge ids, so that a
    dropout seed drops the edges the whole layout drops under it."""
    return build_edge_sharded_on_device(
        mat.edge_rows().long(), mat.col.long(), mat.val, mat.eid.long(), mat.shape,
        axis_size(mesh, "model"), mesh.get_local_rank("model"), route=route,
    )


def values_shard(emat: EdgeShardedSpMM, route: str = "edge_shard_attention") -> EdgeShardedSpMM:
    """The shard's structure as a values layout (``ops.csr_spmm.values_layout``)
    for :func:`edge_sharded_spmm_values`."""
    return dataclasses.replace(emat, fwd=values_layout(emat.fwd, route=route))


def edge_sharded_spmm_values(emat: EdgeShardedSpMM, x: torch.Tensor, values: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``[row_block, d]`` rows of A_v @ x with the shard's edge
    values ``values`` [nnz of the shard] as an argument, differentiable in
    ``x`` (this rank's operand rows) and ``values``: the kernel on the
    shard's values layout (:func:`values_shard`), the rows placed in the
    padded row space, then a reduce-scatter."""
    part = spmm_csr_values(emat.fwd, x.contiguous(), values)
    return scatter_rows(F.pad(part, (0, 0, emat.row_lo, emat.n_rows_pad - emat.row_hi)), group)


def build_for_mesh(row, col, val, shape, mesh) -> EdgeShardedSpMM:
    """:func:`build_edge_sharded_spmm` for this rank's coordinate on 'model',
    on the mesh's device."""
    return build_edge_sharded_spmm(
        row, col, val, shape, axis_size(mesh, "model"), mesh.get_local_rank("model"), device=mesh_device(mesh)
    )


def bake_annealed(emat: EdgeShardedSpMM, row_sum: torch.Tensor, alpha: float) -> EdgeShardedSpMM:
    """The shard with IGCN's annealed feature weights folded into a copy of
    its values, both sides (``ops.csr_spmm.with_annealed_values``: an edge's
    feature row is its row in the forward CSR, ``row_lo`` past the shard's
    first); once an anneal, not once a product (JAX ``bake_stacked_scale``)."""
    return dataclasses.replace(emat, fwd=with_annealed_values(emat.fwd, row_sum[emat.row_lo : emat.row_hi], alpha))


def place_rows(emat: EdgeShardedSpMM, part: torch.Tensor) -> torch.Tensor:
    """The forward product's ``[row_hi - row_lo, d]`` rows placed in a
    zeroed ``[n_rows_pad, d]`` partial, this shard's term of A @ x."""
    out = part.new_zeros(emat.n_rows_pad, part.shape[1])
    out[emat.row_lo : emat.row_hi] = part
    return out


class _EdgeShardedProduct(torch.autograd.Function):
    """out_s = reduce_scatter(A[:, blk_s] @ x_s) (``scatter``) or
    all_reduce(...) (``replicated``); dx_s = A[:, blk_s]^T @ all_gather(g_s)
    or A[:, blk_s]^T @ g, both over the shard's row window. Both products
    are the kernel on a CUDA ``x``, under the same ``edge_scale`` and dropout
    ``drop`` = (seed, p)."""

    @staticmethod
    def forward(ctx, x, emat, group, mode, edge_scale, drop):
        ctx.emat, ctx.group, ctx.mode, ctx.edge_scale, ctx.drop = emat, group, mode, edge_scale, drop
        return _forward(emat, x, group, mode, edge_scale, drop)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.mode == "scatter":
            g = all_gather(g, ctx.group)
        g = g[ctx.emat.row_lo : ctx.emat.row_hi]
        return _product(ctx.emat.bwd, g, ctx.edge_scale, ctx.drop), None, None, None, None, None


def _forward(emat, x, group, mode, edge_scale, drop):
    part = place_rows(emat, _product(emat.fwd, x.contiguous(), edge_scale, drop))
    if mode == "scatter":
        return reduce_scatter(part, group)
    return all_reduce(part, group)


def edge_sharded_spmm(emat: EdgeShardedSpMM, x: torch.Tensor, group, mode: str = "scatter",
                      edge_scale: torch.Tensor | None = None, drop=None) -> torch.Tensor:
    """This rank's part of A @ x, differentiable in ``x`` (this rank's
    ``[block, d]`` operand rows). ``scatter``: ``[row_block, d]``, the
    rank's rows of out; ``replicated``: all ``[n_rows_pad, d]`` on every rank.
    ``edge_scale``: a global [raw COO nnz] per-edge multiplier; ``drop``:
    (seed, p), the same on every rank. ``group``: the 'model' group."""
    if mode not in ("scatter", "replicated"):
        raise ValueError(f"mode {mode!r} is not 'scatter' or 'replicated'")
    if x.ndim != 2 or x.shape[0] != emat.block:
        raise ValueError(f"x must be this rank's [block={emat.block}, d] rows, got {tuple(x.shape)}")
    if drop is not None:
        _check_dropout(*drop)
    if torch.is_grad_enabled() and x.requires_grad:
        return _EdgeShardedProduct.apply(x, emat, group, mode, edge_scale, drop)
    return _forward(emat, x, group, mode, edge_scale, drop)


def _check_mesh(emat, mesh, axis):
    if axis_size(mesh, axis) != emat.n_shards or mesh.get_local_rank(axis) != emat.rank:
        raise ValueError(
            f"mesh axis '{axis}' has size {axis_size(mesh, axis)} and this rank at {mesh.get_local_rank(axis)}; "
            f"the layout is shard {emat.rank} of {emat.n_shards}"
        )


def make_edge_sharded_spmm(emat: EdgeShardedSpMM, mesh, axis: str = "model", mode: str = "scatter"):
    """-> fn(x_local [block, d], edge_scale=None, drop=None): this rank's
    part of A @ x over the mesh's ``axis`` group (JAX spmm.py:405-436)."""
    _check_mesh(emat, mesh, axis)
    group = mesh.get_group(axis)

    def run(x, edge_scale=None, drop=None):
        return edge_sharded_spmm(emat, x, group, mode, edge_scale, drop)

    return run


def propagate_sharded(emat: EdgeShardedSpMM, x0: torch.Tensor, n_layers: int, group) -> torch.Tensor:
    """LightGCN's layer mean over a square A with the operand row-sharded
    end to end: each layer one scattered product (a reduce-scatter forward,
    an all-gather backward)."""
    acc, h = x0, x0
    for _ in range(n_layers):
        h = edge_sharded_spmm(emat, h, group, "scatter")
        acc = acc + h
    return acc / float(n_layers + 1) if n_layers > 0 else x0


def make_edge_sharded_propagation(emat: EdgeShardedSpMM, mesh, n_layers: int, axis: str = "model"):
    """-> fn(x_local [block, d]) -> this rank's [row_block, d] rows of the
    layer mean (JAX spmm.py:439-467). Requires a square A."""
    if emat.n_rows_pad != emat.n_cols_pad:
        raise ValueError("layer chaining requires a square adjacency")
    _check_mesh(emat, mesh, axis)
    group = mesh.get_group(axis)
    return lambda x: propagate_sharded(emat, x, n_layers, group)


def shard_operand(x: torch.Tensor, emat: EdgeShardedSpMM, mesh, axis: str = "model") -> torch.Tensor:
    """x's rows zero-padded to n_cols_pad, this rank's block of them, on the
    mesh's device (JAX spmm.py:470-476)."""
    x = torch.as_tensor(x, device=mesh_device(mesh))
    return local_rows(x, mesh, axis, n_rows=emat.n_cols_pad)
