"""AttIGCN's attention over the CSR layout: the hand-written CUDA kernels of
``csrc/attention_csr.cu``, their plain PyTorch versions, and the autograd
Functions that chain them.

- ``sddmm_csr``: ``out[e, j] = a[r_e, j, :] . x[c_e, :] (+ b[r_e, j])`` for
  ``j < h <= 8``: the scores from the folded query (``a`` = qk, ``b`` = qb,
  ``x`` = the detached value table), and d(values) of the product with
  learned edge values (h = 1, ``a`` = the output's cotangent).
- ``sddmm_csr_backward``: the scores' gradient, ``d_a[r, j, :] = sum over
  r's edges of g[e, j] x[c_e, :]`` and ``d_b[r, j] = sum g[e, j]``: one
  gather of each x row an edge for every head (two launches: the chunks,
  then the rows they cut).
- ``segment_softmax_csr``: the per-row softmax of each head at temperature
  T and its head mean (``ops.spmm.segment_softmax(...).mean(-1)``), with the
  per-head softmax ``p`` kept for the backward: ``softmax_stats`` (each
  row's max m and sum s of exp((x - m) / T), [n_rows, h]) then
  ``softmax_apply`` (p and its head mean from them).
- ``segment_softmax_csr_backward``: ``g_s[e, j] = p[e, j] (g[e] - c[r_e,
  j]) / (h T)``, the scores' cotangent from the attention's:
  ``softmax_stats_backward`` (``c[r, j] = sum_row p[., j] g[.]``) then
  ``softmax_apply_backward``.

The two passes are separate so that the edge-sharded attention
(``parallel/attention.py``) can combine every shard's statistics between
them (``rescale_stats`` and two all-reduces).

A CUDA tensor runs the kernel (or the wrapper raises); a CPU tensor runs the
plain version. Each kernel launch adds one to ``route_launches`` under
``"<kernel>/<route>"`` (keys in ``ROUTES``); ``reset_launch_counts()`` zeroes
them.

Every kernel walks the edges in chunks, each chunk's walk starting from
``chunk_first_rows`` (the first row of each chunk of ``SOFTMAX_CHUNK``
edges), found once a layout.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, route_key, row_of_edges, spmm_csr_reference
from inductive_recommendation_tpu_torch.ops.spmm import segment_softmax
from inductive_recommendation_tpu_torch.utils.profiling import span

MAX_HEADS = 8  # kMaxHeads in csrc/attention_csr.cu
SOFTMAX_CHUNK = 256  # kSoftmaxChunk: edges a warp of the softmax passes takes

# the keys of route_launches
SOFTMAX_KERNELS = ("softmax_stats", "softmax_apply", "softmax_stats_backward", "softmax_apply_backward")
ROUTES = (
    "sddmm_csr/attention", "sddmm_csr/attention_d_values",
    "sddmm_csr/edge_shard_attention", "sddmm_csr/edge_shard_attention_d_values",
    "sddmm_csr_backward/attention", "sddmm_csr_backward/edge_shard_attention",
    *(f"{k}/{r}" for r in ("attention", "edge_shard_attention") for k in SOFTMAX_KERNELS),
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
    """Launch ``sddmm_csr`` on the current stream; fp32 [nnz, h]; counted
    under ``"sddmm_csr/<route>"``."""
    tensors = dict(row_ptr=row_ptr, col=col, a=a, x=x, **({} if b is None else {"b": b}))
    device = _check_cuda(_INDEX, **tensors)
    _check_sddmm(row_ptr, col, a, x, b)
    n_rows, nnz, h, dv = row_ptr.shape[0] - 1, col.shape[0], a.shape[1], x.shape[1]
    if nnz >= 2**31:
        raise ValueError("the kernel indexes edges with int32")
    out = torch.empty(nnz, h, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("sddmm_csr", row_ptr.data_ptr(), chunk_first_rows(row_ptr, nnz).data_ptr(), col.data_ptr(),
                a.data_ptr(), x.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), n_rows, nnz, h, dv,
                stream)
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


def sddmm_csr_backward_reference(row_ptr, col, g, x) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (d_a [n_rows, h, dv], d_b [n_rows, h]), head j's
    ``d_a[:, j]`` the product of the CSR with ``g[:, j]`` as edge values and
    ``x``, ``d_b`` each row's sum of ``g``."""
    d_a = torch.stack([spmm_csr_reference(row_ptr, col, g[:, j], x) for j in range(g.shape[1])], dim=1)
    d_b = g.new_zeros(row_ptr.shape[0] - 1, g.shape[1]).index_add_(0, row_of_edges(row_ptr, g.shape[0]).long(), g)
    return d_a, d_b


def sddmm_csr_backward_cuda(row_ptr, col, g, x, route="attention") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``sddmm_csr_backward`` on the current stream: (d_a, d_b);
    counted under ``"sddmm_csr_backward/<route>"``, two launches when the
    edges span more than one chunk."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, col=col, g=g, x=x)
    _check_edges("g", g, col.shape[0])
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be [n_cols, dv >= 1], got {tuple(x.shape)}")
    n_rows, (nnz, h), dv = row_ptr.shape[0] - 1, g.shape, x.shape[1]
    if nnz >= 2**31:
        raise ValueError("the kernel indexes edges with int32")
    d_a = torch.empty(n_rows, h, dv, dtype=torch.float32, device=device)
    d_b = torch.empty(n_rows, h, dtype=torch.float32, device=device)
    if n_rows == 0:
        return d_a, d_b
    n_chunks = n_softmax_chunks(nnz)
    # the parts of the rows cut by chunk boundaries, [chunk][run-in, cut][h](dv)
    carry_a = torch.empty(n_chunks, 2, h, dv, dtype=torch.float32, device=device)
    carry_b = torch.empty(n_chunks, 2, h, dtype=torch.float32, device=device)
    cut_row = torch.empty(n_chunks, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("sddmm_csr_backward", row_ptr.data_ptr(), chunk_first_rows(row_ptr, nnz).data_ptr(), col.data_ptr(),
                g.data_ptr(), x.data_ptr(), d_a.data_ptr(), d_b.data_ptr(), carry_a.data_ptr(), carry_b.data_ptr(),
                cut_row.data_ptr(), n_rows, nnz, h, dv, n_chunks, stream)
    for _ in range(1 + (n_chunks > 1)):  # the chunks, then the rows they cut
        _count("sddmm_csr_backward", route)
    return d_a, d_b


def sddmm_csr_backward(row_ptr, col, g, x, route="attention") -> tuple[torch.Tensor, torch.Tensor]:
    """(d_a [n_rows, h, dv], d_b [n_rows, h]): ``d_a[r, j] = sum over r's
    edges of g[e, j] x[col[e]]`` and ``d_b[r, j] = sum g[e, j]``, the
    gradient of :func:`sddmm_csr`'s ``a`` and ``b`` from the scores' ``g``
    [nnz, h]. The kernel on CUDA tensors (counted under ``route``), the
    plain version on CPU ones."""
    return _run(
        [row_ptr, col, g, x],
        lambda: sddmm_csr_backward_reference(row_ptr, col, g, x),
        lambda: sddmm_csr_backward_cuda(row_ptr, col, g.contiguous(), x.contiguous(), route),
    )


# -- K2 and K3: the row softmax's statistics and apply passes -----------------------


def n_softmax_chunks(nnz: int) -> int:
    """Edge chunks of the softmax passes: one even for a CSR with no edges."""
    return max(1, -(-nnz // SOFTMAX_CHUNK))


_first_rows = WeakTensorKeyDictionary()


def chunk_first_rows(row_ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """int32 [n_softmax_chunks(nnz)]: the first row starting at or after each
    softmax chunk's first edge, where the passes' walk of the chunk's rows
    starts (instead of a search of ``row_ptr`` in every chunk). Found once
    for each ``row_ptr`` tensor, on its device with no read to the host, and
    kept while the tensor lives."""
    rows = _first_rows.get(row_ptr)
    if rows is None:
        starts = torch.arange(0, n_softmax_chunks(nnz) * SOFTMAX_CHUNK, SOFTMAX_CHUNK, dtype=row_ptr.dtype,
                              device=row_ptr.device)
        rows = torch.searchsorted(row_ptr, starts).to(torch.int32)
        _first_rows[row_ptr] = rows
    return rows


def _check_edges(name, x, nnz=None, h=None):
    if x.ndim != 2 or not 1 <= x.shape[1] <= MAX_HEADS or (nnz is not None and x.shape[0] != nnz):
        raise ValueError(f"{name} must be [nnz, h <= {MAX_HEADS}], got {tuple(x.shape)}")
    if h is not None and x.shape[1] != h:
        raise ValueError(f"{name} has {x.shape[1]} heads, not {h}")


def _check_rows(n_rows, h, **stats):
    for name, t in stats.items():
        if t.shape != (n_rows, h):
            raise ValueError(f"{name} must be [n_rows, h] = {(n_rows, h)}, got {tuple(t.shape)}")


def _row_stats(n_rows, h, device, out, k):
    """``out`` (checked) or ``k`` new [n_rows, h] tensors."""
    outs = tuple(torch.empty(n_rows, h, dtype=torch.float32, device=device) for _ in range(k)) if out is None else out
    _check_cuda({}, **{f"out[{i}]": t for i, t in enumerate(outs)})
    _check_rows(n_rows, h, **{f"out[{i}]": t for i, t in enumerate(outs)})
    return outs


def _launch_stats(kernel, row_ptr, x, g, outs, temperature, route):
    n_rows, (nnz, h) = row_ptr.shape[0] - 1, x.shape
    n_chunks = n_softmax_chunks(nnz)
    carry = torch.empty(n_chunks, 2, 2, h, dtype=torch.float32, device=x.device)
    cut_row = torch.empty(n_chunks, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("softmax_stats", row_ptr.data_ptr(), chunk_first_rows(row_ptr, nnz).data_ptr(), x.data_ptr(),
                None if g is None else g.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
                carry.data_ptr(), cut_row.data_ptr(), n_rows, nnz, h, float(temperature), n_chunks, int(g is not None),
                stream)
    for _ in range(1 + (n_chunks > 1)):  # the chunks, then the rows they cut
        _count(kernel, route)


def softmax_stats_reference(row_ptr, scores, temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (m, s), each [n_rows, h]: every row's largest
    score of each head (-inf for a row with none) and ``s = sum exp((x -
    m') / T)`` over its edges, m' = m where it is finite, else 0 (so s = 0
    where m = -inf)."""
    n_rows, h = row_ptr.shape[0] - 1, scores.shape[1]
    rows = row_of_edges(row_ptr, scores.shape[0]).long()
    m = scores.new_full((n_rows, h), -torch.inf).scatter_reduce(0, rows[:, None].expand(-1, h), scores, "amax")
    finite = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp((scores - finite.index_select(0, rows)) / temperature)
    return m, scores.new_zeros(n_rows, h).index_add_(0, rows, ex)


def softmax_stats_cuda(row_ptr, scores, temperature: float, route="attention", out=None):
    """Launch the statistics pass on the current stream: (m, s), into ``out``
    = (m, s) when given (contiguous [n_rows, h], e.g. a shard's rows of a
    larger table). Two launches when the edges span more than one chunk,
    each counted under ``"softmax_stats/<route>"``."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, scores=scores)
    _check_edges("scores", scores)
    outs = _row_stats(row_ptr.shape[0] - 1, scores.shape[1], device, out, 2)
    _launch_stats("softmax_stats", row_ptr, scores, None, outs, temperature, route)
    return outs


def softmax_stats(row_ptr, scores, temperature: float, route="attention", out=None):
    """(m, s) [n_rows, h]: each row's max score of each head and its sum of
    exp((x - m) / T), the statistics a row softmax needs (rows with no
    finite max: m -inf and s 0). Written into ``out`` = (m, s) when given.
    The kernel on CUDA tensors (counted under ``route``), the plain version
    on CPU ones."""
    def reference():
        stats = softmax_stats_reference(row_ptr, scores, temperature)
        return stats if out is None else tuple(o.copy_(t) for o, t in zip(out, stats))

    return _run([row_ptr, scores], reference,
                lambda: softmax_stats_cuda(row_ptr, scores.contiguous(), temperature, route, out))


def softmax_stats_backward_reference(row_ptr, p, g) -> torch.Tensor:
    """Plain PyTorch version: c [n_rows, h], ``c[r, j] = sum over r's edges
    of p[., j] g[.]``."""
    rows = row_of_edges(row_ptr, p.shape[0]).long()
    return p.new_zeros(row_ptr.shape[0] - 1, p.shape[1]).index_add_(0, rows, p * g[:, None])


def softmax_stats_backward_cuda(row_ptr, p, g, route="attention", out=None) -> torch.Tensor:
    """Launch the statistics pass in backward mode: c, into ``out`` when
    given; counted under ``"softmax_stats_backward/<route>"`` (two launches
    when the edges span more than one chunk)."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, p=p, g=g)
    _check_edges("p", p)
    if g.shape != p.shape[:1]:
        raise ValueError(f"g must be [nnz] = {tuple(p.shape[:1])}, got {tuple(g.shape)}")
    (c,) = _row_stats(row_ptr.shape[0] - 1, p.shape[1], device, None if out is None else (out,), 1)
    _launch_stats("softmax_stats_backward", row_ptr, p, g, (c,), 0.0, route)
    return c


def softmax_stats_backward(row_ptr, p, g, route="attention", out=None) -> torch.Tensor:
    """c [n_rows, h] = each row's sum of p[., j] g[.] (into ``out`` when
    given), the statistic of the softmax's backward."""
    def reference():
        c = softmax_stats_backward_reference(row_ptr, p, g)
        return c if out is None else out.copy_(c)

    return _run([row_ptr, p, g], reference,
                lambda: softmax_stats_backward_cuda(row_ptr, p.contiguous(), g.contiguous(), route, out))


def softmax_apply_reference(row_ptr, scores, m, s, temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (p [nnz, h], its head mean [nnz]), ``p = exp((x
    - m') / T) / s'`` with the row's m' (m, or 0 where m is not finite) and
    s' (s, or 1 where s is not > 0)."""
    rows = row_of_edges(row_ptr, scores.shape[0]).long()
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.where(s > 0, s, 1.0)
    p = torch.exp((scores - m.index_select(0, rows)) / temperature) / s.index_select(0, rows)
    return p, p.mean(dim=-1)


def softmax_apply_cuda(row_ptr, scores, m, s, temperature: float, route="attention"):
    """Launch the apply pass on the current stream: (p, attn); counted under
    ``"softmax_apply/<route>"``."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, scores=scores, m=m, s=s)
    _check_edges("scores", scores)
    n_rows, (nnz, h) = row_ptr.shape[0] - 1, scores.shape
    _check_rows(n_rows, h, m=m, s=s)
    p = torch.empty(nnz, h, dtype=torch.float32, device=device)
    attn = torch.empty(nnz, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("softmax_apply", row_ptr.data_ptr(), chunk_first_rows(row_ptr, nnz).data_ptr(), scores.data_ptr(),
                None, m.data_ptr(), s.data_ptr(), p.data_ptr(), attn.data_ptr(), n_rows, nnz, h, float(temperature),
                n_softmax_chunks(nnz), 0, stream)
    _count("softmax_apply", route)
    return p, attn


def softmax_apply(row_ptr, scores, m, s, temperature: float, route="attention"):
    """(p [nnz, h], attn [nnz]): each edge's softmax of each head from its
    row's statistics (m, s) [n_rows, h] and their head mean; a row with no
    finite max uses 0, a zero sum is taken as 1."""
    return _run(
        [row_ptr, scores, m, s],
        lambda: softmax_apply_reference(row_ptr, scores, m, s, temperature),
        lambda: softmax_apply_cuda(row_ptr, scores.contiguous(), m.contiguous(), s.contiguous(), temperature, route),
    )


def softmax_apply_backward_reference(row_ptr, p, g, c, temperature: float) -> torch.Tensor:
    """Plain PyTorch version: ``g_s = p (g - c[row]) / (h T)``."""
    rows = row_of_edges(row_ptr, p.shape[0]).long()
    return p * (g[:, None] - c.index_select(0, rows)) / (p.shape[1] * temperature)


def softmax_apply_backward_cuda(row_ptr, p, g, c, temperature: float, route="attention") -> torch.Tensor:
    """Launch the apply pass in backward mode: g_s; counted under
    ``"softmax_apply_backward/<route>"``."""
    device = _check_cuda(_INDEX, row_ptr=row_ptr, p=p, g=g, c=c)
    _check_edges("p", p)
    n_rows, (nnz, h) = row_ptr.shape[0] - 1, p.shape
    if g.shape != (nnz,):
        raise ValueError(f"g must be [nnz] = {(nnz,)}, got {tuple(g.shape)}")
    _check_rows(n_rows, h, c=c)
    g_s = torch.empty(nnz, h, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("softmax_apply", row_ptr.data_ptr(), chunk_first_rows(row_ptr, nnz).data_ptr(), p.data_ptr(),
                g.data_ptr(), c.data_ptr(), None, g_s.data_ptr(), None, n_rows, nnz, h, float(temperature),
                n_softmax_chunks(nnz), 1, stream)
    _count("softmax_apply_backward", route)
    return g_s


def softmax_apply_backward(row_ptr, p, g, c, temperature: float, route="attention") -> torch.Tensor:
    """g_s [nnz, h] = ``p (g - c[row]) / (h T)``: the scores' cotangent from
    the head-mean attention's ``g`` [nnz], given the forward's ``p`` and the
    rows' ``c`` (:func:`softmax_stats_backward`)."""
    return _run(
        [row_ptr, p, g, c],
        lambda: softmax_apply_backward_reference(row_ptr, p, g, c, temperature),
        lambda: softmax_apply_backward_cuda(row_ptr, p.contiguous(), g.contiguous(), c.contiguous(), temperature,
                                            route),
    )


def rescale_stats(m, s, m_all, temperature: float) -> torch.Tensor:
    """s [n_rows, h] taken from its own row maxima ``m`` to ``m_all`` (>= m,
    e.g. the maxima over every shard): ``s exp((m - m_all) / T)``, 0 where m
    is -inf. Torch ops on any device (small: one row a row)."""
    return s * torch.exp((m - m_all) / temperature).nan_to_num_(0.0)


def segment_softmax_csr_reference(row_ptr, scores, temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (p [nnz, h], the per-row softmax of each head at
    ``temperature`` (``ops.spmm.segment_softmax``), and its head mean [nnz])."""
    p = segment_softmax(scores, row_ptr, temperature)
    return p, p.mean(dim=-1)


def segment_softmax_csr(row_ptr, scores, temperature: float, route="attention"):
    """(p [nnz, h], attn [nnz]): the per-row softmax of every head of
    ``scores`` at ``temperature`` and its head mean, the statistics pass then
    the apply pass; a row with no edges writes nothing, a zero sum is taken
    as 1."""
    return _run(
        [row_ptr, scores],
        lambda: segment_softmax_csr_reference(row_ptr, scores, temperature),
        lambda: softmax_apply(row_ptr, scores, *softmax_stats(row_ptr, scores, temperature, route), temperature,
                              route),
    )


def segment_softmax_csr_backward_reference(row_ptr, p, g, temperature: float) -> torch.Tensor:
    """Plain PyTorch version: ``g_s = p (g - c[row]) / (h T)`` with ``c[r, j]
    = sum over r's edges of p[., j] g[.]``."""
    c = softmax_stats_backward_reference(row_ptr, p, g)
    return softmax_apply_backward_reference(row_ptr, p, g, c, temperature)


def segment_softmax_csr_backward(row_ptr, p, g, temperature: float, route="attention") -> torch.Tensor:
    """The scores' cotangent [nnz, h] from the head-mean attention's ``g``
    [nnz], given the forward's per-head softmax ``p``: the statistics pass in
    backward mode, then the apply pass."""
    return _run(
        [row_ptr, p, g],
        lambda: segment_softmax_csr_backward_reference(row_ptr, p, g, temperature),
        lambda: softmax_apply_backward(row_ptr, p, g, softmax_stats_backward(row_ptr, p, g, route), temperature,
                                       route),
    )


# -- autograd ---------------------------------------------------------------------------


class _Scores(torch.autograd.Function):
    """scores [nnz, h] = qk[r_e] . v[c_e] + qb[r_e] (K1) on ``mat``'s edges;
    ``v`` is the detached value table and gets no gradient. Backward:
    ``sddmm_csr_backward`` on ``mat``, d_qk and d_qb in one kernel, in the
    span ``irt.attention.scores_backward``."""

    @staticmethod
    def forward(ctx, qk, qb, v, mat):
        ctx.mat = mat
        ctx.save_for_backward(v)
        return sddmm_csr(mat.row_ptr, mat.col, qk, v, qb, route=route_key(mat))

    @staticmethod
    def backward(ctx, g_s):
        mat, (v,) = ctx.mat, ctx.saved_tensors
        with span("irt.attention.scores_backward"):
            d_qk, d_qb = sddmm_csr_backward(mat.row_ptr, mat.col, g_s, v, route=route_key(mat))
        return d_qk, d_qb, None, None


class _SoftmaxMean(torch.autograd.Function):
    """attn [nnz] = the head mean of the per-row softmax of scores / T (the
    statistics and apply passes); backward the two passes in backward mode
    from the kept per-head softmax, in the span
    ``irt.attention.softmax_backward``."""

    @staticmethod
    def forward(ctx, scores, mat, temperature):
        p, attn = segment_softmax_csr(mat.row_ptr, scores, temperature, route=route_key(mat))
        ctx.mat, ctx.temperature = mat, temperature
        ctx.save_for_backward(p)
        return attn

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        with span("irt.attention.softmax_backward"):
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
