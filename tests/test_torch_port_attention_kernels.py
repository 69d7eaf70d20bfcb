"""AttIGCN's attention kernels (``ops/attention_csr.py``, ``csrc/attention_csr.cu``)
on the CPU, where every wrapper runs its plain PyTorch version:

- each plain version against the torch-ops composition it replaces (the
  folded-query gathers and row dots, ``segment_softmax(...).mean(-1)`` and
  autograd's backward through it), to 1e-6;
- ``fused_kv_attention`` and ``attention_spmm_fused_kv`` through the autograd
  Functions ``_Scores`` / ``_SoftmaxMean`` against the JAX package's
  attention and ``jax.vjp`` of ``attention_spmm_fused_kv`` in q, Wk, bk
  and v, to 1e-5 * max(1, max |ref|) (fp32 sums in other orders); bk's
  gradient is 0 in exact arithmetic (a per-row shift of the scores) and is
  held to a small share of Wk's, as in ``test_torch_port_att.py``;
- the scores' gradient (``sddmm_csr_backward_reference``, and ``_Scores``'
  backward through ``attention_scores``) against ``jax.vjp`` of the score
  einsum as ``_attention_forward_qk`` writes it, at h 1, 3, 4, 8 and dv 16,
  64, 67, on a CSR with runs of empty rows and a 1,100-edge row;
- d(values) of ``spmm_csr_values`` (the SDDMM with one head) against JAX's
  ``_bilinear_bwd`` on its bucketed layout;
- the sharded scores of ``parallel/attention.py`` against the single-device
  scores at S = 1, 2, 4, forward and backward;
- the kernels' wrappers refuse what they cannot launch.

The feature matrix is synthetic (300 rows: an empty row, a 1,100-edge row
that spans several of the softmax passes' chunks, the rest 0-10 edges),
inputs from numpy seeds, h in {1, 4}, dv in {8, 64}. The kernels themselves
are held to these plain versions on the card by ``chip_smoke.py`` (phase
10); the softmax passes alone against JAX in
``test_torch_port_softmax_passes.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu.ops import attention_spmm as jax_att
from inductive_recommendation_tpu.ops import build_bucketed_spmm
from inductive_recommendation_tpu.ops.spmm import segment_softmax as jax_segment_softmax
from inductive_recommendation_tpu_torch.ops import attention_csr as K
from inductive_recommendation_tpu_torch.ops import build_csr_spmm, spmm_csr_values, values_layout
from inductive_recommendation_tpu_torch.ops.attention_spmm import (
    attention_spmm_fused_kv,
    fused_kv_attention,
    fused_kv_attention_reference,
)
from inductive_recommendation_tpu_torch.ops.csr_spmm import ROUTES as SPMM_ROUTES
from inductive_recommendation_tpu_torch.ops.spmm import segment_softmax

N_ROWS, N_COLS, EMPTY_ROW, LONG_ROW, LONG_DEGREE = 300, 1200, 7, 100, 1100
HEADS, WIDTHS = (1, 4), (8, 64)
T = float(np.sqrt(64) * 10.0)
TOL, PLAIN_TOL = 1e-5, 1e-6


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(11)
    degrees = rng.integers(0, 11, N_ROWS)
    degrees[EMPTY_ROW], degrees[LONG_ROW] = 0, LONG_DEGREE
    cols = [rng.choice(N_COLS, size=k, replace=False) for k in degrees]
    row = np.repeat(np.arange(N_ROWS), degrees)
    col = np.concatenate(cols)
    val = rng.uniform(0.5, 1.5, len(row)).astype(np.float32)
    return row, col, val


@pytest.fixture(scope="module")
def mats(coo):
    """The port's values layout and JAX's bucketed layout of the same COO."""
    row, col, val = coo
    port = values_layout(build_csr_spmm(row, col, val, (N_ROWS, N_COLS)))
    jmat = build_bucketed_spmm(row, col, val, (N_ROWS, N_COLS), symmetric=False)
    return port, jmat


def _inputs(h, dv, seed=0):
    """q [n_rows, h, dh = dv], Wk [dv, h * dh], bk, v [n_cols, dv], g [n_rows, dv]."""
    rng = np.random.default_rng(seed + 10 * h + dv)
    q = rng.standard_normal((N_ROWS, h, dv)).astype(np.float32)
    w_k = (rng.standard_normal((dv, h * dv)) * 2.0).astype(np.float32)
    b_k = rng.standard_normal(h * dv).astype(np.float32)
    v = rng.standard_normal((N_COLS, dv)).astype(np.float32)
    g = rng.standard_normal((N_ROWS, dv)).astype(np.float32)
    return q, w_k, b_k, v, g


def _rows(mat):
    return mat.edge_rows().long()


# -- each plain version against the composition it replaces ---------------------------


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("dv", WIDTHS)
def test_sddmm_reference_is_the_gather_composition(mats, h, dv):
    """K1's plain version against the folded-query gathers and row dots
    (with the bias), and with one head against d(values)' gather and
    elementwise row dot."""
    mat, _ = mats
    rng = np.random.default_rng(h * dv)
    qk = torch.as_tensor(rng.standard_normal((N_ROWS, h, dv)), dtype=torch.float32)
    qb = torch.as_tensor(rng.standard_normal((N_ROWS, h)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((N_COLS, dv)), dtype=torch.float32)
    rows, cols = _rows(mat), mat.col.long()
    want = torch.einsum("ehv,ev->eh", qk.index_select(0, rows), v.index_select(0, cols)) + qb.index_select(0, rows)
    got = K.sddmm_csr_reference(mat.row_ptr, mat.col, qk, v, qb)
    assert got.shape == (mat.nnz, h)
    _close(got, want.numpy(), PLAIN_TOL)
    g = qk[:, 0, :]
    want1 = (g.index_select(0, rows) * v.index_select(0, cols)).sum(-1)
    _close(K.sddmm_csr_reference(mat.row_ptr, mat.col, g[:, None, :], v)[:, 0], want1.numpy(), PLAIN_TOL)


@pytest.mark.parametrize("h", HEADS)
def test_softmax_reference_is_segment_softmax_mean(mats, h):
    """K2's plain version: p is ``segment_softmax`` at T, attn its head mean;
    every non-empty row's p sums to 1 per head."""
    mat, _ = mats
    rng = np.random.default_rng(h)
    scores = torch.as_tensor(rng.standard_normal((mat.nnz, h)) * 50.0, dtype=torch.float32)
    p, attn = K.segment_softmax_csr(mat.row_ptr, scores, T)
    want = segment_softmax(scores, mat.row_ptr, T)
    _close(p, want.numpy(), PLAIN_TOL)
    _close(attn, want.mean(-1).numpy(), PLAIN_TOL)
    sums = torch.zeros(N_ROWS, h, dtype=torch.float64).index_add_(0, _rows(mat), p.double())
    deg = torch.diff(mat.row_ptr).numpy()
    np.testing.assert_allclose(sums.numpy()[deg > 0], 1.0, rtol=1e-5)
    assert deg[EMPTY_ROW] == 0 and deg[LONG_ROW] == LONG_DEGREE


@pytest.mark.parametrize("h", HEADS)
def test_softmax_backward_reference_is_autograd(mats, h):
    """K3's plain version against autograd's backward through
    ``segment_softmax(...).mean(-1)``."""
    mat, _ = mats
    rng = np.random.default_rng(100 + h)
    scores = torch.as_tensor(rng.standard_normal((mat.nnz, h)) * 50.0, dtype=torch.float32).requires_grad_(True)
    g = torch.as_tensor(rng.standard_normal(mat.nnz), dtype=torch.float32)
    (segment_softmax(scores, mat.row_ptr, T).mean(-1) * g).sum().backward()
    p, _ = K.segment_softmax_csr_reference(mat.row_ptr, scores.detach(), T)
    got = K.segment_softmax_csr_backward(mat.row_ptr, p, g, T)
    # |g_s| is about 1 / (h T) of |g|: held to its own largest entry
    np.testing.assert_allclose(got.numpy(), scores.grad.numpy(), rtol=0,
                               atol=PLAIN_TOL * float(np.abs(scores.grad.numpy()).max()))


def test_softmax_of_single_heads_and_the_head_mean(mats):
    """With h heads the head mean is the mean of h one-head softmaxes."""
    mat, _ = mats
    rng = np.random.default_rng(5)
    scores = torch.as_tensor(rng.standard_normal((mat.nnz, 4)) * 50.0, dtype=torch.float32)
    _, attn = K.segment_softmax_csr(mat.row_ptr, scores, T)
    heads = [K.segment_softmax_csr(mat.row_ptr, scores[:, j : j + 1].contiguous(), T)[1] for j in range(4)]
    _close(attn, torch.stack(heads, -1).mean(-1).numpy(), PLAIN_TOL)


# -- the attention through the autograd Functions, against JAX --------------------------


def _jax_attention(mat, q, w_k, b_k, v, h, dv):
    """JAX's per-edge attention on the port layout's edges: its folded query,
    its ``segment_softmax`` at T, the head mean."""
    rows, cols = jnp.asarray(_rows(mat).numpy()), jnp.asarray(mat.col.long().numpy())
    qk = jnp.einsum("nhd,vhd->nhv", q, w_k.reshape(dv, h, dv))
    qb = jnp.einsum("nhd,hd->nh", q, b_k.reshape(h, dv))
    scores = jnp.einsum("ehv,ev->eh", qk[rows], jax.lax.stop_gradient(v)[cols]) + qb[rows]
    return jax_segment_softmax(scores / T, rows, N_ROWS).mean(-1)


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("dv", WIDTHS)
def test_fused_kv_attention_matches_jax(mats, h, dv):
    """The attention through ``_Scores`` / ``_SoftmaxMean`` and its gradients
    in q, Wk, bk against JAX's per-edge attention and ``jax.vjp``."""
    mat, _ = mats
    q, w_k, b_k, v, _ = _inputs(h, dv)
    gw = np.random.default_rng(dv + h).standard_normal(mat.nnz).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: _jax_attention(mat, *a, h, dv), *map(jnp.asarray, (q, w_k, b_k, v)))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, w_k, b_k)]
    got = fused_kv_attention(mat, *ts, torch.as_tensor(v), T)
    (got * torch.as_tensor(gw)).sum().backward()
    _close(got, want)
    wq, wwk, wbk, wv = vjp(jnp.asarray(gw))
    _close(ts[0].grad, wq, what="q")
    _close(ts[1].grad, wwk, what="w_k")
    assert np.abs(wv).max() == 0.0  # the values are detached in the scores
    scale = float(np.abs(ts[1].grad.numpy()).max())
    assert np.abs(ts[2].grad.numpy()).max() < 1e-5 * scale and np.abs(np.asarray(wbk)).max() < 1e-5 * scale


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("dv", WIDTHS)
def test_attention_spmm_fused_kv_matches_jax(mats, h, dv):
    """The whole aggregation and its VJP in q, Wk, bk and v against JAX's
    ``attention_spmm_fused_kv`` on its bucketed layout."""
    mat, jmat = mats
    q, w_k, b_k, v, g = _inputs(h, dv, seed=1)
    want, vjp = jax.vjp(lambda *a: jax_att.attention_spmm_fused_kv(jmat, *a, T), *map(jnp.asarray, (q, w_k, b_k, v)))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, w_k, b_k, v)]
    out = attention_spmm_fused_kv(mat, *ts, T)
    (out * torch.as_tensor(g)).sum().backward()
    _close(out, want)
    for name, t, w in zip(("q", "w_k", "b_k", "v"), ts, vjp(jnp.asarray(g))):
        if name == "b_k":
            scale = float(np.abs(ts[1].grad.numpy()).max())
            assert np.abs(t.grad.numpy()).max() < 1e-5 * scale and np.abs(np.asarray(w)).max() < 1e-5 * scale
            continue
        _close(t.grad, w, what=name)


@pytest.mark.parametrize("h", HEADS)
def test_functions_equal_the_plain_composition(mats, h):
    """``fused_kv_attention`` (the Functions) and
    ``fused_kv_attention_reference`` (autograd through the plain torch ops)
    agree forward and in every gradient, float64 against float64."""
    mat, _ = mats
    q, w_k, b_k, v, _ = _inputs(h, 8, seed=2)
    gw = torch.as_tensor(np.random.default_rng(3).standard_normal(mat.nnz))
    outs, grads = [], []
    for fn in (fused_kv_attention, fused_kv_attention_reference):
        ts = [torch.as_tensor(a, dtype=torch.float64).requires_grad_(True) for a in (q, w_k, b_k)]
        out = fn(mat, *ts, torch.as_tensor(v, dtype=torch.float64), T)
        (out * gw).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in ts])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-12, atol=1e-14)
    for got, want in zip(grads[0][:2], grads[1][:2]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10 * float(want.abs().max()))
    assert float(grads[0][2].abs().max()) < 1e-10 * float(grads[0][1].abs().max())


def test_softmax_chunks_mirror_the_kernel(mats):
    """``SOFTMAX_CHUNK`` is the kernel's ``kSoftmaxChunk`` (32 lanes of
    ``kSoftmaxLane`` edges; it sizes the carry buffer and the grid), a CSR
    with no edge still has a chunk (it writes the empty rows' statistics),
    and the 1,100-edge row is cut across several chunks."""
    import re
    from pathlib import Path

    src = (Path(K.__file__).parent / "csrc" / "attention_csr.cu").read_text()
    lane = int(re.search(r"constexpr int kSoftmaxLane = (\d+);", src).group(1))
    assert re.search(r"constexpr int kSoftmaxChunk = 32 \* kSoftmaxLane;", src)
    assert K.SOFTMAX_CHUNK == 32 * lane
    assert [K.n_softmax_chunks(n) for n in (0, 1, K.SOFTMAX_CHUNK, K.SOFTMAX_CHUNK + 1)] == [1, 1, 1, 2]
    mat, _ = mats
    start, end = (int(v) for v in mat.row_ptr[[LONG_ROW, LONG_ROW + 1]])
    assert end - start == LONG_DEGREE and end // K.SOFTMAX_CHUNK - start // K.SOFTMAX_CHUNK >= 4


def test_chunk_first_rows_are_found_once_a_layout(mats):
    """Each softmax chunk's first row starting at or after its first edge (a
    lower bound in ``row_ptr``; where the card's passes start their walk),
    found once for a ``row_ptr`` and kept; one entry for a CSR without
    edges."""
    mat, _ = mats
    rows = K.chunk_first_rows(mat.row_ptr, mat.nnz)
    assert rows.dtype == torch.int32 and rows.shape == (K.n_softmax_chunks(mat.nnz),)
    starts = np.arange(rows.shape[0]) * K.SOFTMAX_CHUNK
    np.testing.assert_array_equal(rows.numpy(), np.searchsorted(mat.row_ptr.numpy(), starts, side="left"))
    assert K.chunk_first_rows(mat.row_ptr, mat.nnz) is rows
    assert K.chunk_first_rows(torch.zeros(4, dtype=torch.int32), 0).tolist() == [0]


def test_softmax_routes():
    """Each softmax pass counts under its own key, on the single-device
    layout's route and on a shard's."""
    for kernel in K.SOFTMAX_KERNELS:
        assert {f"{kernel}/attention", f"{kernel}/edge_shard_attention"} <= set(K.ROUTES)
    assert not any(k.startswith("segment_softmax") for k in K.ROUTES)


def test_scores_gradient_routes(mats, monkeypatch):
    """The scores' gradient counts under ``sddmm_csr_backward/<route>`` on
    the single-device layout's route and on a shard's; the SpMM has no
    query-gradient route left, and ``_Scores``' backward calls no SpMM
    product; the attention kernels' routes reset to 0."""
    from inductive_recommendation_tpu_torch.ops import csr_spmm

    assert {"sddmm_csr_backward/attention", "sddmm_csr_backward/edge_shard_attention"} <= set(K.ROUTES)
    assert not any(r.endswith("_dq") for r in SPMM_ROUTES)

    def no_product(*args, **kwargs):
        raise AssertionError("the scores' gradient called an SpMM product")

    monkeypatch.setattr(csr_spmm, "_product", no_product)
    monkeypatch.setattr(csr_spmm, "spmm_csr_cuda", no_product)
    mat, _ = mats
    qk = torch.zeros(N_ROWS, 4, 8, requires_grad=True)
    qb = torch.zeros(N_ROWS, 4, requires_grad=True)
    K.attention_scores(mat, qk, qb, torch.ones(N_COLS, 8)).sum().backward()
    assert float(qb.grad.sum()) == mat.nnz * 4
    K.route_launches["sddmm_csr_backward/attention"] = 3
    K.reset_launch_counts()
    assert K.route_launches == dict.fromkeys(K.ROUTES, 0)


# -- the scores' gradient against JAX's autodiff of its score einsum --------------------


@pytest.fixture(scope="module")
def runs_mats():
    """The port's values layout and JAX's bucketed layout of a COO with runs
    of empty rows (30 at the start, 20 after the long row) and a 1,100-edge
    row, the rest 0-10 edges."""
    rng = np.random.default_rng(12)
    degrees = np.concatenate([np.zeros(30, np.int64), rng.integers(0, 11, 100), [LONG_DEGREE],
                              np.zeros(20, np.int64), rng.integers(0, 11, 149)])
    cols = [rng.choice(N_COLS, size=k, replace=False) for k in degrees]
    row, col = np.repeat(np.arange(N_ROWS), degrees), np.concatenate(cols)
    val = rng.uniform(0.5, 1.5, len(row)).astype(np.float32)
    port = values_layout(build_csr_spmm(row, col, val, (N_ROWS, N_COLS)))
    return port, build_bucketed_spmm(row, col, val, (N_ROWS, N_COLS), symmetric=False)


def _jax_bucket_scores(jmat, qk, qb, v):
    """The scores as ``_attention_forward_qk`` writes them (attention_spmm.py
    :198-202), bucket by bucket: ``qk[rows]`` against the stop-gradient
    value gather, plus ``qb``; [m, k, h] a bucket."""
    out = []
    for b, rows in jax_att._iter_buckets(jmat.fwd):
        vals_sg = jax.lax.stop_gradient(jnp.take(v, b.idx, axis=0))
        out.append(jnp.einsum("mhd,mkd->mkh", qk[rows], vals_sg) + qb[rows][:, None, :])
    return tuple(out)


@pytest.mark.parametrize("h", [1, 3, 4, 8])
@pytest.mark.parametrize("dv", [16, 64, 67])
def test_scores_gradient_matches_jax(runs_mats, h, dv):
    """``sddmm_csr_backward_reference`` and ``_Scores``' gradient (through
    ``attention_scores``) against ``jax.vjp`` of the score einsum in qk and
    qb, the port's edge cotangent laid into JAX's bucket slots by edge id;
    the scores themselves edge by edge."""
    mat, jmat = runs_mats
    rng = np.random.default_rng(100 * h + dv)
    qk = rng.standard_normal((N_ROWS, h, dv)).astype(np.float32)
    qb = rng.standard_normal((N_ROWS, h)).astype(np.float32)
    v = rng.standard_normal((N_COLS, dv)).astype(np.float32)
    g_s = rng.standard_normal((mat.nnz, h)).astype(np.float32)
    by_eid = np.zeros((int(mat.eid.max()) + 1, h), np.float32)
    by_eid[mat.eid.numpy()] = g_s
    want, vjp = jax.vjp(lambda a, b: _jax_bucket_scores(jmat, a, b, jnp.asarray(v)), jnp.asarray(qk), jnp.asarray(qb))
    cts = tuple(jnp.asarray(by_eid[np.asarray(b.eid)] * (np.asarray(b.val) != 0)[:, :, None]) for b in jmat.fwd.buckets)
    want_qk, want_qb = vjp(cts)
    d_qk, d_qb = K.sddmm_csr_backward_reference(mat.row_ptr, mat.col, torch.as_tensor(g_s), torch.as_tensor(v))
    _close(d_qk, want_qk, what="sddmm_csr_backward_reference d_qk")
    _close(d_qb, want_qb, what="sddmm_csr_backward_reference d_qb")
    ts = [torch.as_tensor(qk).requires_grad_(True), torch.as_tensor(qb).requires_grad_(True)]
    got = K.attention_scores(mat, *ts, torch.as_tensor(v))
    (got * torch.as_tensor(g_s)).sum().backward()
    _close(ts[0].grad, want_qk, what="_Scores d_qk")
    _close(ts[1].grad, want_qb, what="_Scores d_qb")
    scores = np.zeros_like(by_eid)
    for b, s in zip(jmat.fwd.buckets, want):
        keep = np.asarray(b.val) != 0
        scores[np.asarray(b.eid)[keep]] = np.asarray(s)[keep]
    _close(got, scores[mat.eid.numpy()], what="scores")
    deg = torch.diff(mat.row_ptr).numpy()
    assert (deg[:30] == 0).all() and deg.max() == LONG_DEGREE
    assert not d_qk.numpy()[deg == 0].any() and not d_qb.numpy()[deg == 0].any()


# -- d(values) of the product with learned edge values ---------------------------------


@pytest.mark.parametrize("dv", WIDTHS)
def test_values_product_d_values_matches_jax_bilinear_bwd(mats, dv):
    """d(values) of ``spmm_csr_values`` (the one-head SDDMM) and d(x) against
    JAX's gather-only ``_bilinear_bwd`` on the bucketed layout, the port's
    edge values laid into JAX's slots by edge id."""
    mat, jmat = mats
    rng = np.random.default_rng(dv)
    x = rng.standard_normal((N_COLS, dv)).astype(np.float32)
    values = rng.random(mat.nnz).astype(np.float32)
    g = rng.standard_normal((N_ROWS, dv)).astype(np.float32)
    by_eid = np.zeros(int(mat.eid.max()) + 1, np.float32)
    by_eid[mat.eid.numpy()] = values
    buckets = jmat.fwd.buckets
    attns = tuple(jnp.asarray(by_eid[np.asarray(b.eid)] * (np.asarray(b.val) != 0)) for b in buckets)
    slots = jax_att.build_dv_slot_tables(jmat)
    res = (jmat.fwd, jmat.bwd, slots, attns, jnp.asarray(x))
    d_attns, want_dx = jax_att._bilinear_bwd(res, jnp.asarray(g))[3:]
    want = np.zeros_like(by_eid)
    for b, d in zip(buckets, d_attns):
        keep = np.asarray(b.val) != 0
        want[np.asarray(b.eid)[keep]] = np.asarray(d)[keep]
    xt = torch.as_tensor(x).requires_grad_(True)
    vt = torch.as_tensor(values).requires_grad_(True)
    (spmm_csr_values(mat, xt, vt) * torch.as_tensor(g)).sum().backward()
    _close(vt.grad, want[mat.eid.numpy()])
    _close(xt.grad, want_dx)


# -- the sharded scores ------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 4])
def test_sharded_scores_equal_single_device(coo, mats, S):
    """Every shard's scores (``parallel.attention.shard_scores``: the
    query's row window against the shard's value rows) equal the
    single-device scores edge by edge, and the shards' query gradients
    summed equal the single-device ones; each shard edge's global row is its
    row in the whole matrix."""
    from inductive_recommendation_tpu_torch.parallel.attention import shard_scores
    from inductive_recommendation_tpu_torch.parallel.spmm import build_edge_sharded_spmm, values_shard

    mat, _ = mats
    h, dv = 4, 8
    rng = np.random.default_rng(S)
    qk0 = rng.standard_normal((N_ROWS, h, dv)).astype(np.float32)
    qb0 = rng.standard_normal((N_ROWS, h)).astype(np.float32)
    v = torch.as_tensor(rng.standard_normal((N_COLS, dv)), dtype=torch.float32)
    gs = rng.standard_normal((int(mat.eid.max()) + 1, h)).astype(np.float32)  # a cotangent by edge id
    qk, qb = torch.as_tensor(qk0).requires_grad_(True), torch.as_tensor(qb0).requires_grad_(True)
    want = K.attention_scores(mat, qk, qb, v)
    (want * torch.as_tensor(gs[mat.eid.numpy()])).sum().backward()
    shards = [values_shard(build_edge_sharded_spmm(*coo, (N_ROWS, N_COLS), S, s)) for s in range(S)]
    n_pad, blk = shards[0].n_rows_pad, shards[0].block
    qk_pad = torch.zeros(n_pad, h, dv)
    qk_pad[:N_ROWS] = torch.as_tensor(qk0)
    qb_pad = torch.zeros(n_pad, h)
    qb_pad[:N_ROWS] = torch.as_tensor(qb0)
    qk_pad.requires_grad_(True)
    qb_pad.requires_grad_(True)
    v_pad = torch.zeros(shards[0].n_cols_pad, dv)
    v_pad[:N_COLS] = v
    rows_by_eid = np.zeros(len(gs), np.int64)
    rows_by_eid[mat.eid.numpy()] = _rows(mat).numpy()
    got = np.zeros_like(gs)
    total = 0
    for s, sh in enumerate(shards):
        scores = shard_scores(sh, qk_pad, qb_pad, v_pad[s * blk : (s + 1) * blk])
        eid = sh.fwd.eid.numpy()
        got[eid] = scores.detach().numpy()
        np.testing.assert_array_equal(sh.fwd.edge_rows().long().numpy() + sh.row_lo, rows_by_eid[eid])
        total = total + (scores * torch.as_tensor(gs[eid])).sum()
    total.backward()
    want_by_eid = np.zeros_like(gs)
    want_by_eid[mat.eid.numpy()] = want.detach().numpy()
    _close(got, want_by_eid, PLAIN_TOL)
    _close(qk_pad.grad[:N_ROWS], qk.grad.numpy(), what="d_qk")
    _close(qb_pad.grad[:N_ROWS], qb.grad.numpy(), what="d_qb")
    assert not bool(qk_pad.grad[N_ROWS:].any())


# -- what the wrappers refuse -------------------------------------------------------------


def test_kernel_wrappers_refuse_what_they_cannot_launch(mats):
    """The CUDA wrappers refuse CPU tensors before any build (the scores
    and their gradient too); the dispatchers refuse other devices and mixed
    ones; more than 8 heads and mismatched shapes are refused, also by the
    softmax passes."""
    mat, _ = mats
    qk, v = torch.zeros(N_ROWS, 4, 8), torch.zeros(N_COLS, 8)
    scores, g, stats = torch.zeros(mat.nnz, 4), torch.zeros(mat.nnz), torch.zeros(N_ROWS, 4)
    with pytest.raises(ValueError, match="cuda"):
        K.sddmm_csr_cuda(mat.row_ptr, mat.col, qk, v)
    with pytest.raises(ValueError, match="cuda"):
        K.sddmm_csr_backward_cuda(mat.row_ptr, mat.col, scores, v)
    with pytest.raises(ValueError, match="cuda"):
        K.softmax_stats_cuda(mat.row_ptr, scores, T)
    with pytest.raises(ValueError, match="cuda"):
        K.softmax_apply_cuda(mat.row_ptr, scores, stats, stats, T)
    with pytest.raises(ValueError, match="cuda"):
        K.softmax_stats_backward_cuda(mat.row_ptr, scores, g)
    with pytest.raises(ValueError, match="cuda"):
        K.softmax_apply_backward_cuda(mat.row_ptr, scores, g, stats, T)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.sddmm_csr(mat.row_ptr, mat.col, qk.to("meta"), v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.sddmm_csr_backward(mat.row_ptr, mat.col, scores, v.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.segment_softmax_csr(mat.row_ptr.to("meta"), scores, T)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.softmax_apply(mat.row_ptr, scores, stats.to("meta"), stats, T)
    with pytest.raises(ValueError, match="heads"):
        K._check_sddmm(mat.row_ptr, mat.col, torch.zeros(N_ROWS, 9, 8), v, None)
    with pytest.raises(ValueError, match="n_rows"):
        K._check_sddmm(mat.row_ptr, mat.col, torch.zeros(N_ROWS + 1, 4, 8), v, None)
    with pytest.raises(ValueError, match="b must"):
        K._check_sddmm(mat.row_ptr, mat.col, qk, v, torch.zeros(N_ROWS, 3))
    with pytest.raises(ValueError, match="h <= 8"):
        K._check_edges("scores", torch.zeros(mat.nnz, 9))
    with pytest.raises(ValueError, match="n_rows, h"):
        K._check_rows(N_ROWS, 4, m=torch.zeros(N_ROWS + 1, 4))
