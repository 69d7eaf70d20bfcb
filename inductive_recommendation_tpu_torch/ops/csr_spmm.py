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
  ``[nnz]`` and ``eid`` int32 ``[nnz]``.

Only the forward product exists so far; its transpose layout and the
edge-id-hashed dropout belong to the training path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from inductive_recommendation_tpu_torch.ops import _build

# Edges per warp in the kernel's first launch: kEdgesPerChunk in
# csrc/spmm_csr.cu, which must equal it.
EDGES_PER_CHUNK = 192


@dataclasses.dataclass(frozen=True)
class CsrSpMM:
    """Row-sorted CSR of a sparse ``[n_rows, n_cols]`` matrix on one device.

    ``symmetric=True`` asserts A == A^T (the sym-normalized adjacency); a
    per-edge scale is then refused, since (A o S)^T != A o S in general."""

    row_ptr: torch.Tensor  # int32 [n_rows + 1]
    col: torch.Tensor  # int32 [nnz]
    val: torch.Tensor  # fp32 [nnz]
    eid: torch.Tensor  # int32 [nnz], position in the raw COO input
    n_rows: int
    n_cols: int
    symmetric: bool = False

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def edge_rows(self) -> torch.Tensor:
        """int32 [nnz] row of every edge."""
        return row_of_edges(self.row_ptr)


def build_csr_spmm(row, col, val, shape, symmetric: bool = False, device="cpu") -> CsrSpMM:
    """Host-side constructor from COO arrays (numpy), placed on ``device``."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    val = np.asarray(val, dtype=np.float32)
    n_rows, n_cols = (int(s) for s in shape)
    if len(row) >= 2**31:
        raise ValueError(f"nnz {len(row)} does not fit the int32 CSR")
    eid = np.arange(len(row), dtype=np.int64)
    nz = val != 0.0
    row, col, val, eid = row[nz], col[nz], val[nz], eid[nz]
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
        symmetric=symmetric,
    )


def row_of_edges(row_ptr: torch.Tensor) -> torch.Tensor:
    n_rows = row_ptr.shape[0] - 1
    rows = torch.arange(n_rows, dtype=torch.int32, device=row_ptr.device)
    return torch.repeat_interleave(rows, torch.diff(row_ptr))


def spmm_csr_reference(row_ptr, col, val, x) -> torch.Tensor:
    """Plain PyTorch version: out[r] = sum over r's edges of val * x[col]."""
    out = torch.zeros(row_ptr.shape[0] - 1, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, row_of_edges(row_ptr), x.index_select(0, col) * val[:, None])


def n_chunks(nnz: int) -> int:
    """Edge chunks of the kernel's first launch: one even for a matrix with no edges."""
    return max(1, -(-nnz // EDGES_PER_CHUNK))


def spmm_csr_cuda(mat: CsrSpMM, x: torch.Tensor, val: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/spmm_csr.cu`` on the current stream: out = A @ x, with
    ``val`` (default ``mat.val``) as A's edge values.

    A product is two launches when the edges span more than one chunk of
    ``EDGES_PER_CHUNK``: the chunks, then the rows cut by a chunk boundary;
    one launch otherwise. ``spmm_csr_cuda.launches`` counts the launches of
    both kernels. Raises on anything the kernels do not take."""
    val = mat.val if val is None else val
    tensors = {"row_ptr": mat.row_ptr, "col": mat.col, "val": val, "x": x}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every operand on {x.device} (cuda)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, dtype in (("row_ptr", torch.int32), ("col", torch.int32), ("val", torch.float32), ("x", torch.float32)):
        if tensors[name].dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensors[name].dtype}")
    if x.ndim != 2 or x.shape[0] != mat.n_cols:
        raise ValueError(f"x must be [n_cols={mat.n_cols}, d], got {tuple(x.shape)}")
    if val.shape != mat.col.shape or mat.row_ptr.shape[0] != mat.n_rows + 1:
        raise ValueError("row_ptr/col/val do not describe one CSR matrix")
    if mat.nnz >= 2**31 or x.shape[1] >= 2**31:
        raise ValueError("the kernel indexes edges and columns with int32")
    if torch.is_grad_enabled() and (x.requires_grad or val.requires_grad):
        raise NotImplementedError("spmm_csr_cuda has no backward kernel yet; call it under torch.no_grad()")
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
    lib = _build.load("spmm_csr")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spmm_csr_chunks(
            mat.row_ptr.data_ptr(), mat.col.data_ptr(), val.data_ptr(), x.data_ptr(), out.data_ptr(),
            None if carry is None else carry.data_ptr(), None if cut_row is None else cut_row.data_ptr(),
            n_rows, nnz, d, chunks, stream,
        )
        if err != 0:
            raise RuntimeError(f"spmm_csr chunk kernel launch failed: cudaError {err}")
        spmm_csr_cuda.launches += 1
        if carry is not None:
            err = lib.spmm_csr_carries(
                mat.row_ptr.data_ptr(), cut_row.data_ptr(), carry.data_ptr(), out.data_ptr(),
                n_rows, d, chunks, stream,
            )
            if err != 0:
                raise RuntimeError(f"spmm_csr carry kernel launch failed: cudaError {err}")
            spmm_csr_cuda.launches += 1
    return out


spmm_csr_cuda.launches = 0


def spmm_csr(mat: CsrSpMM, x: torch.Tensor, edge_scale: torch.Tensor | None = None) -> torch.Tensor:
    """out = (A o scale) @ x.

    ``edge_scale``: optional fp32 [raw COO nnz] per-edge multiplier in the COO
    order given at construction. A CUDA ``x`` runs the hand-written kernel
    (or raises); a CPU ``x`` runs :func:`spmm_csr_reference`."""
    if edge_scale is not None and mat.symmetric:
        raise ValueError("edge_scale with a shared-symmetric layout is incorrect; build with symmetric=False")
    if x.ndim != 2 or x.shape[0] != mat.n_cols:
        raise ValueError(f"x must be [n_cols={mat.n_cols}, d], got {tuple(x.shape)}")
    val = mat.val if edge_scale is None else mat.val * edge_scale[mat.eid]
    if x.device.type == "cuda":
        return spmm_csr_cuda(mat, x.contiguous(), val.contiguous())
    if x.device.type == "cpu":
        return spmm_csr_reference(mat.row_ptr, mat.col, val, x)
    raise ValueError(f"spmm_csr runs on cuda or cpu tensors, not {x.device}")


def with_annealed_values(mat: CsrSpMM, row_sum: torch.Tensor, alpha: float) -> CsrSpMM:
    """A copy of ``mat`` whose values carry IGCN's annealed degree-power weights
    ``val * clamp(row_sum, 1e-12)[row] ** ((alpha - 1) / 2 - 0.5)``
    (reference model.py:4127-4175), computed once per anneal, not per product.

    Covers the forward layout only; the transpose side comes with training."""
    if mat.symmetric:
        raise ValueError("annealed values require symmetric=False")
    # the exponent in fp32, as the JAX package computes it
    expo = (torch.tensor(float(alpha), dtype=torch.float32) - 1.0) / 2.0 - 0.5
    rs = torch.clamp(row_sum.to(device=mat.val.device, dtype=torch.float32), min=1e-12)
    w = torch.pow(rs, expo.to(rs.device))
    return dataclasses.replace(mat, val=mat.val * w[mat.edge_rows().long()])
