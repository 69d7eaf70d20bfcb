"""The row softmax's two passes (``ops/attention_csr.py``: ``softmax_stats``,
``softmax_apply`` and their backward modes; on the card the kernels of
``csrc/attention_csr.cu``) on the CPU, where each runs its plain PyTorch
version:

- the statistics (each row's max and its sum of exp((x - m) / T)) against
  ``jax.ops.segment_max`` / ``segment_sum``, the forward (p and its head
  mean) against the JAX package's ``segment_softmax`` at T, and the backward
  (``softmax_stats_backward`` then ``softmax_apply_backward``) against
  ``jax.vjp`` of its head mean, for h in {1, 3, 4, 8} and T in {1, 80};
- the statistics of S = 2 and 4 column shards, their maxima combined and
  their sums rescaled to them (``rescale_stats``) and added, equal the whole
  matrix's, and the shards' apply passes give the whole softmax edge by
  edge (``parallel/attention.py``: ``shard_stats``, ``shard_apply``);
- the passes write into given row windows (``out=``), as the shard path
  does.

The matrix is synthetic (400 rows: runs of empty rows, a 1,100-edge row, a
row of -inf scores, the rest 0-12 edges), inputs from numpy seeds.
Tolerance 1e-5 * max(1, max |ref|) (fp32 sums in other orders); the
backward, about 1 / (h T) of g, 1e-5 of its own largest entry. The kernels
are held to these plain versions on the card by ``chip_smoke.py`` (phase 10
(a)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu.ops.spmm import segment_softmax as jax_segment_softmax
from inductive_recommendation_tpu_torch.ops import attention_csr as K
from inductive_recommendation_tpu_torch.ops import build_csr_spmm

N_ROWS, N_COLS = 400, 1500
EMPTY_RUNS = ((20, 70), (300, 330))  # [start, end) of rows with no edge
LONG_ROW, LONG_DEGREE, NEG_ROW = 150, 1100, 7  # NEG_ROW's scores are all -inf
HEADS, TEMPERATURES = (1, 3, 4, 8), (1.0, 80.0)
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(13)
    degrees = rng.integers(0, 13, N_ROWS)
    for a, b in EMPTY_RUNS:
        degrees[a:b] = 0
    degrees[LONG_ROW], degrees[NEG_ROW] = LONG_DEGREE, 6
    cols = [rng.choice(N_COLS, size=k, replace=False) for k in degrees]
    row = np.repeat(np.arange(N_ROWS), degrees)
    return row, np.concatenate(cols), np.ones(len(row), np.float32)


@pytest.fixture(scope="module")
def mat(coo):
    return build_csr_spmm(*coo, (N_ROWS, N_COLS))


def _scores(mat, h, seed):
    rng = np.random.default_rng(seed)
    scores = (rng.standard_normal((mat.nnz, h)) * 40.0).astype(np.float32)
    rp = mat.row_ptr.numpy()
    scores[rp[NEG_ROW] : rp[NEG_ROW + 1]] = -np.inf
    return scores


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_stats_match_jax_segment_reductions(mat, h, temperature):
    """m is ``segment_max`` (-inf for the empty rows and the -inf row), s is
    ``segment_sum`` of exp((x - m') / T), m' = m where finite, else 0."""
    scores = _scores(mat, h, 10 * h)
    rows = jnp.asarray(mat.edge_rows().long().numpy())
    x = jnp.asarray(scores)
    want_m = jax.ops.segment_max(x, rows, num_segments=N_ROWS)
    finite = jnp.where(jnp.isfinite(want_m), want_m, 0.0)
    want_s = jax.ops.segment_sum(jnp.exp((x - finite[rows]) / temperature), rows, num_segments=N_ROWS)
    m, s = K.softmax_stats(mat.row_ptr, torch.as_tensor(scores), temperature)
    assert m.shape == s.shape == (N_ROWS, h)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))
    _close(s, want_s, what="s")
    deg = torch.diff(mat.row_ptr).numpy()
    assert np.isneginf(m.numpy()[deg == 0]).all() and np.isneginf(m.numpy()[NEG_ROW]).all()
    assert not s.numpy()[deg == 0].any() and not s.numpy()[NEG_ROW].any()


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_passes_match_jax_segment_softmax_and_its_vjp(mat, h, temperature):
    """The apply pass from the statistics against JAX's ``segment_softmax``
    at T and its head mean; the backward passes against ``jax.vjp`` of the
    head mean. The -inf row's softmax and its gradient are 0."""
    scores = _scores(mat, h, 20 * h)
    g = np.random.default_rng(30 + h).standard_normal(mat.nnz).astype(np.float32)
    rows = jnp.asarray(mat.edge_rows().long().numpy())

    def head_mean(x):
        return jax_segment_softmax(x / temperature, rows, N_ROWS).mean(-1)

    want_p = jax_segment_softmax(jnp.asarray(scores) / temperature, rows, N_ROWS)
    want_attn, vjp = jax.vjp(head_mean, jnp.asarray(scores))
    (want_gs,) = vjp(jnp.asarray(g))
    x, gt = torch.as_tensor(scores), torch.as_tensor(g)
    p, attn = K.softmax_apply(mat.row_ptr, x, *K.softmax_stats(mat.row_ptr, x, temperature), temperature)
    _close(p, want_p, what="p")
    _close(attn, want_attn, what="attn")
    c = K.softmax_stats_backward(mat.row_ptr, p, gt)
    _close(c, K.softmax_stats_backward_reference(mat.row_ptr, p.double(), gt.double()).numpy(), what="c")
    g_s = K.softmax_apply_backward(mat.row_ptr, p, gt, c, temperature)
    np.testing.assert_allclose(g_s.numpy(), np.asarray(want_gs), rtol=0,
                               atol=TOL * float(np.abs(np.asarray(want_gs)).max()), err_msg="g_s")
    rp = mat.row_ptr.numpy()
    neg = slice(rp[NEG_ROW], rp[NEG_ROW + 1])
    assert not p.numpy()[neg].any() and not g_s.numpy()[neg].any()
    # the whole-softmax entry points are the same two passes
    p2, attn2 = K.segment_softmax_csr(mat.row_ptr, x, temperature)
    torch.testing.assert_close(p2, p, rtol=0, atol=1e-7)
    torch.testing.assert_close(K.segment_softmax_csr_backward(mat.row_ptr, p, gt, temperature), g_s, rtol=0,
                               atol=0)


def test_stats_write_into_a_row_window(mat):
    """``out=`` writes the statistics into given [n_rows, h] views (a row
    window of a larger table) and leaves the rest alone."""
    scores = torch.as_tensor(_scores(mat, 4, 5))
    g = torch.as_tensor(np.random.default_rng(6).standard_normal(mat.nnz), dtype=torch.float32)
    m_big, s_big = torch.full((N_ROWS + 9, 4), 7.0), torch.full((N_ROWS + 9, 4), 7.0)
    got = K.softmax_stats(mat.row_ptr, scores, 3.0, out=(m_big[5 : 5 + N_ROWS], s_big[5 : 5 + N_ROWS]))
    m, s = K.softmax_stats(mat.row_ptr, scores, 3.0)
    assert got[0].data_ptr() == m_big[5].data_ptr()
    assert torch.equal(m_big[5 : 5 + N_ROWS], m) and torch.equal(s_big[5 : 5 + N_ROWS], s)
    assert (m_big[:5] == 7.0).all() and (s_big[N_ROWS + 5 :] == 7.0).all()
    p, c_big = torch.rand(mat.nnz, 4, generator=torch.Generator().manual_seed(7)), torch.zeros(N_ROWS + 2, 4)
    K.softmax_stats_backward(mat.row_ptr, p, g, out=c_big[1 : 1 + N_ROWS])
    assert torch.equal(c_big[1 : 1 + N_ROWS], K.softmax_stats_backward(mat.row_ptr, p, g))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("h", [1, 4])
def test_shard_statistics_combine_to_the_whole(coo, mat, S, h):
    """The statistics of S column shards (``shard_stats``), maxima combined
    by max and sums rescaled to them and added (the two all-reduces of the
    shard path), equal the whole matrix's; the shards' apply passes
    (``shard_apply``) give the whole softmax edge by edge. Some rows have
    all their edges on one shard (the 1,100-edge row spans them all)."""
    from inductive_recommendation_tpu_torch.parallel.attention import shard_apply, shard_stats
    from inductive_recommendation_tpu_torch.parallel.spmm import build_edge_sharded_spmm, values_shard

    temperature = 80.0
    by_eid = _scores(mat, h, 40 + S)  # scores by the raw COO edge id
    x_whole = torch.as_tensor(by_eid[mat.eid.numpy()])
    want_m, want_s = K.softmax_stats(mat.row_ptr, x_whole, temperature)
    want_p, want_attn = K.segment_softmax_csr(mat.row_ptr, x_whole, temperature)
    shards = [values_shard(build_edge_sharded_spmm(*coo, (N_ROWS, N_COLS), S, s)) for s in range(S)]
    xs = [torch.as_tensor(by_eid[sh.fwd.eid.numpy()]) for sh in shards]
    stats = [shard_stats(sh, x, temperature) for sh, x in zip(shards, xs)]
    m_all = torch.stack([m for m, _ in stats]).amax(dim=0)
    s_all = sum(K.rescale_stats(m, s, m_all, temperature) for m, s in stats)
    np.testing.assert_array_equal(m_all[:N_ROWS].numpy(), want_m.numpy())
    _close(s_all[:N_ROWS], want_s.numpy(), what="s")
    assert np.isneginf(m_all[N_ROWS:].numpy()).all() and not s_all[N_ROWS:].any()
    one_shard = [sum(int(sh.fwd.eid.numel() and (sh.fwd.edge_rows().long() + sh.row_lo == r).any()) for sh in shards)
                 == 1 for r in range(N_ROWS) if int(torch.diff(mat.row_ptr)[r]) > 1]
    assert any(one_shard) and not all(one_shard)
    got_p, got_attn = np.zeros((mat.nnz, h), np.float32), np.zeros(mat.nnz, np.float32)
    pos = np.empty(int(mat.eid.max()) + 1, np.int64)
    pos[mat.eid.numpy()] = np.arange(mat.nnz)
    for sh, x in zip(shards, xs):
        p, attn = shard_apply(sh, x, m_all, s_all, temperature)
        got_p[pos[sh.fwd.eid.numpy()]] = p.numpy()
        got_attn[pos[sh.fwd.eid.numpy()]] = attn.numpy()
    _close(got_p, want_p.numpy(), what="p")
    _close(got_attn, want_attn.numpy(), what="attn")


def test_rescale_stats_rules():
    """A shard's sum rescaled to the global max: exp((m - m_all) / T) as the
    factor, 1 where the maxima agree, 0 where the shard's max is -inf (no
    edge there, or only -inf scores), whatever the global max."""
    inf = float("inf")
    m = torch.tensor([[1.0, -inf, -inf, 2.0]])
    m_all = torch.tensor([[3.0, -inf, 5.0, 2.0]])
    s = torch.tensor([[2.0, 0.0, 0.0, 4.0]])
    got = K.rescale_stats(m, s, m_all, 4.0)
    np.testing.assert_allclose(got.numpy(), [[2.0 * np.exp(-0.5), 0.0, 0.0, 4.0]], rtol=1e-7)
    assert got[0, 3] == 4.0
