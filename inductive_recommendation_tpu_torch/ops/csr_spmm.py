"""CSR SpMM: the layout, its hand-written CUDA kernel and the plain version.

Counterpart of ``inductive_recommendation_tpu/ops/bucketed_spmm.py``. The JAX
package groups rows into degree buckets because the TPU has no fast scatter;
on the GPU warps split the edges into equal chunks and a second pass adds the
pieces of the rows cut by a chunk boundary (``csrc/spmm_csr.cu``), so the
layout is plain CSR. It keeps the bucketed layout's contract:

- edge ids are assigned in the raw COO order, *before* explicit zeros are
  dropped, so a per-edge scale built in the caller's COO order lines up;
- rows are sorted stably (edges of one row keep their COO order);
- ``row_ptr`` int32 ``[n_rows + 1]``, ``col`` int32 ``[nnz]``, ``val`` fp32
  ``[nnz]`` and ``eid`` int32 ``[nnz]``;
- a layout built with ``symmetric=False`` carries its transpose (rows = the
  columns, sorted stably, with the same edge ids), on which the backward
  ``A^T @ g`` runs the same kernel; a symmetric layout is its own transpose.

Gradients flow to the dense operand only (``torch.autograd.Function``s around
the kernel): edge values are graph buffers, not parameters. The one
exception is :func:`spmm_csr_values`, whose edge values are an argument
(AttIGCN's attention) and get a gradient too.

Edge dropout (``spmm_csr_dropout``) keeps edge e with its value scaled by
1/(1-p) when ``u(seed, eid[e]) >= p``, with u from a counter-based Philox
draw of the edge id, so the forward and the transpose drop the same edges
(JAX ``bucketed_spmm.py:254-275,330-370``; its threefry bits differ). The
kernel draws u in its first launch; :func:`edge_uniform` computes the same
bits with torch integer ops on any device.

A seed is a host integer, or, while a training step is captured in a CUDA
graph, an entry of the step's :class:`SeedTable` on the card, which the
kernel reads when it runs: the host rewrites the table before each replay,
so every replay drops its own edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.utils.profiling import span

# Edges per warp in the kernel's first launch: kEdgesPerChunk in
# csrc/spmm_csr.cu, which must equal it.
EDGES_PER_CHUNK = 192


@dataclasses.dataclass(frozen=True)
class CsrSpMM:
    """Row-sorted CSR of a sparse ``[n_rows, n_cols]`` matrix on one device.

    ``symmetric=True`` asserts A == A^T (the sym-normalized adjacency, a
    DOSE view); a per-edge scale or dropout is then refused, since
    (A o S)^T != A o S in general. Otherwise ``transpose`` holds A^T
    (``transposed=True`` there), or None for a layout built by hand, which
    then has no backward. ``route`` names a layout whose launches are
    counted apart (:func:`route_key`): ``"view"`` for a per-epoch DOSE view
    (``graph/views.py``), ``"aug_feat"`` for DOSE_aug2's augmented feature
    matrix, ``"attention"`` for a values layout (:func:`values_layout`),
    whose ``t_pos`` maps each edge of the transpose to its position here."""

    row_ptr: torch.Tensor  # int32 [n_rows + 1]
    col: torch.Tensor  # int32 [nnz]
    val: torch.Tensor  # fp32 [nnz]
    eid: torch.Tensor  # int32 [nnz], position in the raw COO input
    n_rows: int
    n_cols: int
    symmetric: bool = False
    transpose: CsrSpMM | None = None
    transposed: bool = False
    route: str | None = None
    t_pos: torch.Tensor | None = None  # int64 [nnz], values layouts only

    @property
    def view(self) -> bool:
        return self.route == "view"

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def T(self) -> CsrSpMM:
        if self.symmetric:
            return self
        if self.transpose is None:
            raise ValueError("this layout carries no transpose; build it with build_csr_spmm")
        return self.transpose

    def edge_rows(self) -> torch.Tensor:
        """int32 [nnz] row of every edge."""
        return row_of_edges(self.row_ptr, self.nnz)


def _one_side(row, col, val, eid, n_rows, n_cols, device, **flags) -> CsrSpMM:
    """CSR of the COO edges with rows sorted stably."""
    order = np.argsort(row, kind="stable")
    row, col, val, eid = row[order], col[order], val[order], eid[order]
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=n_rows), out=row_ptr[1:])

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return CsrSpMM(
        row_ptr=put(row_ptr, torch.int32),
        col=put(col, torch.int32),
        val=put(val, torch.float32),
        eid=put(eid, torch.int32),
        n_rows=n_rows,
        n_cols=n_cols,
        **flags,
    )


@span("irt.graph.csr")
def build_csr_spmm(row, col, val, shape, symmetric: bool = False, device="cpu") -> CsrSpMM:
    """Host-side constructor from COO arrays (numpy), placed on ``device``;
    with ``symmetric=False`` the transpose layout is built beside it."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    val = np.asarray(val, dtype=np.float32)
    n_rows, n_cols = (int(s) for s in shape)
    if len(row) >= 2**31:
        raise ValueError(f"nnz {len(row)} does not fit the int32 CSR")
    eid = np.arange(len(row), dtype=np.int64)
    nz = val != 0.0
    row, col, val, eid = row[nz], col[nz], val[nz], eid[nz]
    if symmetric:
        return _one_side(row, col, val, eid, n_rows, n_cols, device, symmetric=True)
    transpose = _one_side(col, row, val, eid, n_cols, n_rows, device, transposed=True)
    return _one_side(row, col, val, eid, n_rows, n_cols, device, transpose=transpose)


def csr_on_device(rows, cols, vals, shape, eid=None, **flags) -> CsrSpMM:
    """CSR of COO triples already on a device (torch tensors), with rows
    sorted stably and explicit zeros dropped, built there with no host copy;
    ``eid`` is an edge's position in the triples unless given (one id per
    triple). No transpose is built: ``flags`` (``symmetric``, ``transposed``,
    ``route``) say what the layout is."""
    keep = vals != 0
    eid = torch.nonzero(keep).flatten() if eid is None else eid[keep]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if rows.shape[0] >= 2**31:
        raise ValueError(f"nnz {rows.shape[0]} does not fit the int32 CSR")
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=shape[0])
    return CsrSpMM(
        row_ptr=torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32),
        col=cols[order].to(torch.int32),
        val=vals[order].to(torch.float32),
        eid=eid[order].to(torch.int32),
        n_rows=int(shape[0]),
        n_cols=int(shape[1]),
        **flags,
    )


def row_of_edges(row_ptr: torch.Tensor, nnz: int | None = None) -> torch.Tensor:
    """int32 [nnz] row of every edge; given ``nnz``, with no device-to-host
    read of the output's size."""
    n_rows = row_ptr.shape[0] - 1
    rows = torch.arange(n_rows, dtype=torch.int32, device=row_ptr.device)
    return torch.repeat_interleave(rows, torch.diff(row_ptr), output_size=nnz)


def spmm_csr_reference(row_ptr, col, val, x) -> torch.Tensor:
    """Plain PyTorch version: out[r] = sum over r's edges of val * x[col]."""
    out = torch.zeros(row_ptr.shape[0] - 1, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, row_of_edges(row_ptr, col.shape[0]), x.index_select(0, col) * val[:, None])


# -- edge dropout: Philox4x32-10 of the edge id --------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments


def _mulhilo32(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b, for a < 2^32 and int64 b in
    [0, 2^32): b is split into 16-bit halves so that no product overflows
    int64."""
    low = a * (b & 0xFFFF)  # < 2^48
    high = a * (b >> 16)  # < 2^48
    t = low + ((high & 0xFFFF) << 16)  # a * b = t + (high >> 16) * 2^32
    return (high >> 16) + (t >> 32), t & _M32


def philox_word0(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """First output word of Philox4x32-10 (Salmon et al., SC'11) keyed by the
    64-bit ``seed`` (low word first), at the counters (counter, 0, 0, 0):
    int64 values in [0, 2^32). ``counter`` holds values in [0, 2^32)."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    c0 = counter.to(torch.int64)
    c1 = c2 = c3 = torch.zeros_like(c0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def edge_uniform(seed: int, eid: torch.Tensor) -> torch.Tensor:
    """fp32 u in [0, 1) per edge: the top 24 bits of ``philox_word0(seed,
    eid)`` times 2^-24, exact in fp32, as the kernel draws it."""
    return (philox_word0(seed, eid) >> 8).to(torch.float32) * 2.0**-24


def _check_dropout(seed, p):
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError(f"a seed on the device is one int64 entry, got {seed.dtype} {tuple(seed.shape)}")
    elif not 0 <= seed < 2**64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p {p} is not in [0, 1)")


def dropout_values(val: torch.Tensor, eid: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    """The edge values under dropout: ``val / (1 - p)`` where
    ``edge_uniform(seed, eid) >= p``, else 0, in fp32 as the kernel computes
    them."""
    p32 = torch.tensor(p, dtype=torch.float32, device=val.device)
    keep = edge_uniform(seed, eid) >= p32
    return torch.where(keep, val / (1.0 - p32), 0.0)


def spmm_csr_dropout_reference(mat: CsrSpMM, x: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    """Plain PyTorch version of the dropout product (A o M) @ x."""
    return spmm_csr_reference(mat.row_ptr, mat.col, dropout_values(mat.val, mat.eid, seed, p), x)


class SeedTable:
    """The dropout seeds of a training step captured in a CUDA graph: int64
    ``values`` [capacity] on the step's device. While the step is captured
    the forward gets the table in its host generator's place, and
    :func:`dropout_seed` hands out its entries in order, 0-dim views whose
    values the kernels read when they run; before every replay the host
    writes that step's draws into them (``train/step_graph.py``)."""

    def __init__(self, capacity: int, device):
        self.values = torch.zeros(capacity, dtype=torch.int64, device=device)
        self.taken = 0

    def take(self) -> torch.Tensor:
        if self.taken == self.values.shape[0]:
            raise RuntimeError(f"the step draws more than {self.taken} dropout seeds, its table's size")
        self.taken += 1
        return self.values[self.taken - 1]


def dropout_seed(generator: torch.Generator | SeedTable | None = None) -> int | torch.Tensor:
    """A dropout seed drawn from a CPU ``generator`` (torch's default one when
    None): a host draw, so a training step does not wait for the card. From
    a :class:`SeedTable`, its next entry, with nothing drawn."""
    if isinstance(generator, SeedTable):
        return generator.take()
    return int(torch.randint(0, 2**62, (), generator=generator))


# -- the kernel ----------------------------------------------------------------


def n_chunks(nnz: int) -> int:
    """Edge chunks of the kernel's first launch: one even for a matrix with no edges."""
    return max(1, -(-nnz // EDGES_PER_CHUNK))


def spmm_csr_cuda(mat: CsrSpMM, x: torch.Tensor, val: torch.Tensor | None = None, drop=None) -> torch.Tensor:
    """Launch ``csrc/spmm_csr.cu`` on the current stream: out = A @ x, with
    ``val`` (default ``mat.val``) as A's edge values and, when ``drop`` =
    ``(seed, p)``, the edge dropout drawn in the kernel from ``mat.eid``
    (a seed on the device is read by the kernel from its address).
    Records no autograd: :func:`spmm_csr` and :func:`spmm_csr_dropout` do.

    A product is two launches when the edges span more than one chunk of
    ``EDGES_PER_CHUNK``: the chunks, then the rows cut by a chunk boundary;
    one launch otherwise. ``spmm_csr_cuda.launches`` counts the launches of
    both kernels, and ``spmm_csr_cuda.route_launches`` the same launches by
    :func:`route_key`. Raises on anything the kernels do not take."""
    val = mat.val if val is None else val
    tensors = {"row_ptr": mat.row_ptr, "col": mat.col, "val": val, "x": x}
    if drop is not None:
        _check_dropout(*drop)
        tensors["eid"] = mat.eid
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every operand on {x.device} (cuda)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, dtype in (("row_ptr", torch.int32), ("col", torch.int32), ("eid", torch.int32),
                        ("val", torch.float32), ("x", torch.float32)):
        if name in tensors and tensors[name].dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensors[name].dtype}")
    if x.ndim != 2 or x.shape[0] != mat.n_cols:
        raise ValueError(f"x must be [n_cols={mat.n_cols}, d], got {tuple(x.shape)}")
    if val.shape != mat.col.shape or mat.eid.shape != mat.col.shape or mat.row_ptr.shape[0] != mat.n_rows + 1:
        raise ValueError("row_ptr/col/val/eid do not describe one CSR matrix")
    if mat.nnz >= 2**31 or x.shape[1] >= 2**31:
        raise ValueError("the kernel indexes edges and columns with int32")
    if torch.is_grad_enabled() and (x.requires_grad or val.requires_grad):
        raise NotImplementedError("spmm_csr_cuda records no autograd; call spmm_csr or spmm_csr_dropout")
    n_rows, nnz, d = mat.n_rows, mat.nnz, int(x.shape[1])
    out = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out
    chunks = n_chunks(nnz)
    # the partial sums of the rows cut by chunk boundaries, [chunk][first/last
    # row][d], and the row each chunk leaves unfinished (-1 for none)
    carry = cut_row = None
    if chunks > 1:
        carry = torch.empty(chunks, 2, d, dtype=torch.float32, device=x.device)
        cut_row = torch.empty(chunks, dtype=torch.int32, device=x.device)
    seed, p = (0, 0.0) if drop is None else drop
    seed_ptr = None
    if isinstance(seed, torch.Tensor):
        if seed.device != x.device:
            raise ValueError(f"the seed is on {seed.device}; the kernel needs it on {x.device}")
        seed, seed_ptr = 0, seed.data_ptr()
    route = route_key(mat, drop)
    lib = _build.load("spmm_csr")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spmm_csr_chunks(
            mat.row_ptr.data_ptr(), mat.col.data_ptr(), val.data_ptr(),
            None if drop is None else mat.eid.data_ptr(), seed, seed_ptr, p,
            x.data_ptr(), out.data_ptr(),
            None if carry is None else carry.data_ptr(), None if cut_row is None else cut_row.data_ptr(),
            n_rows, nnz, d, chunks, stream,
        )
        if err != 0:
            raise RuntimeError(f"spmm_csr chunk kernel launch failed: cudaError {err}")
        spmm_csr_cuda.launches += 1
        spmm_csr_cuda.route_launches[route] += 1
        if carry is not None:
            err = lib.spmm_csr_carries(
                mat.row_ptr.data_ptr(), cut_row.data_ptr(), carry.data_ptr(), out.data_ptr(),
                n_rows, d, chunks, stream,
            )
            if err != 0:
                raise RuntimeError(f"spmm_csr carry kernel launch failed: cudaError {err}")
            spmm_csr_cuda.launches += 1
            spmm_csr_cuda.route_launches[route] += 1
    return out


# the keys of spmm_csr_cuda.route_launches
ROUTES = (
    "forward", "transpose", "forward_dropout", "transpose_dropout", "view",
    "attention", "attention_transpose", "attention_query", "aug_feat", "aug_feat_transpose",
    "edge_shard", "edge_shard_transpose", "edge_shard_dropout", "edge_shard_transpose_dropout",
    "edge_shard_view", "edge_shard_view_transpose",
    "edge_shard_aug_feat", "edge_shard_aug_feat_transpose",
    "edge_shard_aug_feat_dropout", "edge_shard_aug_feat_transpose_dropout",
    "edge_shard_attention", "edge_shard_attention_transpose", "edge_shard_attention_query",
)

# routed layouts whose products under dropout count apart
_DROPOUT_ROUTES = ("edge_shard", "edge_shard_aug_feat")


def route_key(mat: CsrSpMM, drop=None) -> str:
    """The route a product on ``mat`` counts under: the layout side and the
    dropout (``forward``, ``transpose``, ``forward_dropout``,
    ``transpose_dropout``) for a layout with no ``route``; else the route,
    plus ``_transpose`` on the transpose side, with or without dropout
    (``view``, forward and backward alike since a view is symmetric;
    ``attention`` / ``attention_transpose``; ``attention_query``, AttIGCN's
    query product on the feature matrix; ``aug_feat`` /
    ``aug_feat_transpose``; a shard of the multi-GPU layer's edge-sharded
    product, ``edge_shard`` and ``edge_shard_transpose``, each with
    ``_dropout`` under dropout; a shard of a per-epoch view, of DOSE_aug2's
    augmented feature matrix (with ``_dropout``) or of AttIGCN's attention,
    ``edge_shard_view``, ``edge_shard_aug_feat``, ``edge_shard_attention``,
    each with its ``_transpose``; ``edge_shard_attention_query``, a shard of
    the query's layout)."""
    dropout = "" if drop is None else "_dropout"
    if mat.route is None:
        return ("transpose" if mat.transposed else "forward") + dropout
    return mat.route + ("_transpose" if mat.transposed else "") + (dropout if mat.route in _DROPOUT_ROUTES else "")


def reset_launch_counts():
    """Set ``spmm_csr_cuda.launches`` and every route's count to 0."""
    spmm_csr_cuda.launches = 0
    spmm_csr_cuda.route_launches = dict.fromkeys(ROUTES, 0)


reset_launch_counts()


# -- products with autograd ------------------------------------------------------


@span("irt.ops.spmm")
def _product(mat: CsrSpMM, x: torch.Tensor, edge_scale=None, drop=None) -> torch.Tensor:
    """(A o scale) @ x, or (A o M) @ x under ``drop`` = (seed, p): the kernel
    for a CUDA ``x`` (or it raises), the plain version for a CPU one. Every
    product, forward or backward, is one ``irt.ops.spmm`` span."""
    val = mat.val if edge_scale is None else mat.val * edge_scale[mat.eid]
    if x.device.type == "cuda":
        return spmm_csr_cuda(mat, x.contiguous(), val.contiguous(), drop)
    if x.device.type == "cpu":
        if drop is not None:
            seed, p = drop
            val = dropout_values(val, mat.eid, int(seed), p)
        return spmm_csr_reference(mat.row_ptr, mat.col, val, x)
    raise ValueError(f"spmm_csr runs on cuda or cpu tensors, not {x.device}")


class _CsrProduct(torch.autograd.Function):
    """out = (A o S) @ x, or (A o M) @ x under ``drop``; grad_x is the
    transpose product (A o S)^T @ g on the transpose layout, under the same
    (seed, p) so that the same edges drop (JAX ``bucketed_spmm.py:286-303,
    330-350``)."""

    @staticmethod
    def forward(ctx, x, mat, edge_scale, drop):
        ctx.mat, ctx.edge_scale, ctx.drop = mat, edge_scale, drop
        return _product(mat, x, edge_scale, drop)

    @staticmethod
    def backward(ctx, g):
        return _product(ctx.mat.T, g.contiguous(), ctx.edge_scale, ctx.drop), None, None, None


def _check_operand(mat: CsrSpMM, x: torch.Tensor):
    if x.ndim != 2 or x.shape[0] != mat.n_cols:
        raise ValueError(f"x must be [n_cols={mat.n_cols}, d], got {tuple(x.shape)}")


def spmm_csr(mat: CsrSpMM, x: torch.Tensor, edge_scale: torch.Tensor | None = None) -> torch.Tensor:
    """out = (A o scale) @ x, differentiable in ``x``.

    ``edge_scale``: optional fp32 [raw COO nnz] per-edge multiplier in the COO
    order given at construction. A CUDA ``x`` runs the hand-written kernel
    (or raises); a CPU ``x`` runs :func:`spmm_csr_reference`."""
    if edge_scale is not None and mat.symmetric:
        raise ValueError("edge_scale with a shared-symmetric layout is incorrect; build with symmetric=False")
    _check_operand(mat, x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _CsrProduct.apply(x, mat, edge_scale, None)
    return _product(mat, x, edge_scale)


def spmm_csr_dropout(mat: CsrSpMM, x: torch.Tensor, seed: int | torch.Tensor, p: float) -> torch.Tensor:
    """out = (A o M) @ x with M = keep/(1-p), keep = ``edge_uniform(seed,
    eid) >= p``, differentiable in ``x`` (reference ``sparse_dropout``,
    model.py:4016-4028). Needs a layout built with ``symmetric=False``.
    ``seed``: what :func:`dropout_seed` gave."""
    if mat.symmetric:
        raise ValueError("edge dropout with a shared-symmetric layout is incorrect; build with symmetric=False")
    _check_dropout(seed, p)
    _check_operand(mat, x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _CsrProduct.apply(x, mat, None, (seed, p))
    return _product(mat, x, drop=(seed, p))


def with_annealed_values(mat: CsrSpMM, row_sum: torch.Tensor, alpha: float) -> CsrSpMM:
    """A copy of ``mat`` whose values carry IGCN's annealed degree-power weights
    ``val * clamp(row_sum, 1e-12)[feature row] ** ((alpha - 1) / 2 - 0.5)``
    (reference model.py:4127-4175), computed once per anneal, not per product.
    The feature row of an edge is its row in the forward layout and its
    column in the transpose (JAX ``bucketed_spmm.py:412-427``)."""
    if mat.symmetric:
        raise ValueError("annealed values require symmetric=False")
    # the exponent in fp32, as the JAX package computes it
    expo = (torch.tensor(float(alpha), dtype=torch.float32) - 1.0) / 2.0 - 0.5
    rs = torch.clamp(row_sum.to(device=mat.val.device, dtype=torch.float32), min=1e-12)
    w = torch.pow(rs, expo.to(rs.device))
    t = mat.transpose
    if t is not None:
        t = dataclasses.replace(t, val=t.val * w[t.col.long()])
    return dataclasses.replace(mat, val=mat.val * w[mat.edge_rows().long()], transpose=t)


# -- products with learned edge values -------------------------------------------


def values_layout(mat: CsrSpMM, route: str = "attention") -> CsrSpMM:
    """``mat``'s structure as a layout for :func:`spmm_csr_values`: values 1
    on both sides (the structure is a mask; the product takes its values as
    an argument), the launches counted under ``route``, and ``t_pos``, the
    position in the forward layout of each edge of the transpose, found once
    from the edge ids (JAX ``attention_spmm.py::build_dv_slot_tables``).
    ``mat`` must carry its transpose (``symmetric=False``)."""
    if mat.symmetric:
        raise ValueError("a values layout needs a layout built with symmetric=False")
    t = mat.T
    pos_of_eid = torch.zeros(int(mat.eid.max()) + 1 if mat.nnz else 0, dtype=torch.int64, device=mat.col.device)
    pos_of_eid[mat.eid.long()] = torch.arange(mat.nnz, device=mat.col.device)
    transpose = dataclasses.replace(t, val=torch.ones_like(t.val), route=route)
    return dataclasses.replace(
        mat, val=torch.ones_like(mat.val), route=route, transpose=transpose, t_pos=pos_of_eid[t.eid.long()]
    )


class _ValuesProduct(torch.autograd.Function):
    """out = A_v @ x with the edge values v an input: grad_x = A_v^T @ g, the
    kernel on the transpose layout with v gathered into its edge order
    (``t_pos``); grad_v[e] = g[row_e] . x[col_e], the SDDMM kernel with one
    head (``ops.attention_csr.sddmm_csr``, counted under the layout's route
    plus ``_d_values``; JAX ``attention_spmm.py::_bilinear_bwd``). The
    backward is one ``irt.attention.aggregate_backward`` span."""

    @staticmethod
    def forward(ctx, x, values, mat):
        ctx.mat = mat
        ctx.save_for_backward(x, values)
        return _product(dataclasses.replace(mat, val=values), x)

    @staticmethod
    def backward(ctx, g):
        from inductive_recommendation_tpu_torch.ops.attention_csr import sddmm_csr  # it imports this module

        mat, (x, values) = ctx.mat, ctx.saved_tensors
        g = g.contiguous()
        d_x = d_values = None
        with span("irt.attention.aggregate_backward"):
            if ctx.needs_input_grad[0]:
                d_x = _product(dataclasses.replace(mat.T, val=values[mat.t_pos]), g)
            if ctx.needs_input_grad[1]:
                d_values = sddmm_csr(mat.row_ptr, mat.col, g[:, None, :], x,
                                     route=route_key(mat) + "_d_values")[:, 0]
        return d_x, d_values, None


def spmm_csr_values(mat: CsrSpMM, x: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[r] = sum over r's edges e of values[e] * x[col_e]: ``mat``'s
    structure with fp32 ``values`` [nnz] in its edge order, differentiable in
    ``x`` and ``values``. Needs a :func:`values_layout` for a gradient in
    ``x``. A CUDA ``x`` runs the hand-written kernel with ``values`` as the
    edge values (or raises); a CPU ``x`` runs :func:`spmm_csr_reference`."""
    _check_operand(mat, x)
    if values.shape != (mat.nnz,):
        raise ValueError(f"values must be [nnz={mat.nnz}], got {tuple(values.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or values.requires_grad):
        if x.requires_grad and mat.t_pos is None:
            raise ValueError("a gradient in x needs a values layout; build it with values_layout")
        return _ValuesProduct.apply(x, values, mat)
    return _product(dataclasses.replace(mat, val=values), x)
