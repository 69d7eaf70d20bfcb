"""The schedule of the port's CSR SpMM kernel (``ops/csrc/spmm_csr.cu``),
emulated in plain PyTorch, against the plain version and the JAX package.

The kernel cannot run on the CPU, so this file transcribes its two launches
rule for rule and checks the rules: launch 1 cuts ``[0, nnz)`` into chunks of
E edges, writes every row that ends inside the chunk where it starts and
leaves the pieces of the others in ``carry[chunk][slot]``; launch 2 adds each
cut row's pieces in chunk order. ``chip_smoke.py`` holds the kernel itself
against the plain version on the card. Tolerance rtol 1e-5 / atol 1e-6: the
pieces are summed in another order than the plain version's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from inductive_recommendation_tpu.graph import coo_to_device
from inductive_recommendation_tpu.ops import build_bucketed_spmm, spmm_bucketed
from inductive_recommendation_tpu.ops.spmm import spmm_coo
from inductive_recommendation_tpu_torch.ops import build_csr_spmm, spmm_csr_reference
from inductive_recommendation_tpu_torch.ops.csr_spmm import EDGES_PER_CHUNK, n_chunks

TOL = dict(rtol=1e-5, atol=1e-6)


def chunk_count(nnz, chunk):
    """``n_chunks`` of the wrapper at any chunk size."""
    return max(1, -(-nnz // chunk))


def warp_lower_bound(a, n, v):
    """``warp_lower_bound`` of the kernel: the first i in [0, n] with
    a[i] >= v, by rounds of 32 evenly spaced probes."""
    lo, hi = 0, n
    while lo < hi:
        stride = (hi - lo + 31) // 32
        ge = [p >= hi or a[p] >= v for p in (lo + lane * stride for lane in range(32))]
        k = ge.index(True) if any(ge) else 32
        if k == 0:
            hi = lo
        else:
            nlo = lo + (k - 1) * stride + 1
            if k < 32:
                hi = min(lo + k * stride, hi)
            lo = nlo
    return lo


def chunk_pieces(row_ptr, chunk):
    """Launch 1: (chunk, row, first edge, end edge, slot) for every piece a
    warp sums, slot None for a row written to ``out`` directly; and
    ``cut_row``, the row each chunk but the last leaves unfinished (-1 for none)."""
    rp = [int(v) for v in row_ptr]
    n_rows, nnz = len(rp) - 1, rp[-1]
    count = chunk_count(nnz, chunk)
    pieces, cut_row = [], []
    for c in range(count):
        cs, ce, last = c * chunk, min((c + 1) * chunk, nnz), c == count - 1
        r = warp_lower_bound(rp, n_rows, cs)
        start = rp[r]
        if r > 0 and start > cs:  # the row that runs in from an earlier chunk
            pieces.append((c, r - 1, cs, min(start, ce), 0))
        cut = -1
        while r < n_rows and (last or rp[r] < ce):
            end = rp[r + 1]
            pieces.append((c, r, rp[r], min(end, ce), None if end <= ce else 1))
            cut = r if end > ce else cut
            r += 1
        if not last:
            cut_row.append(cut)
    return pieces, cut_row


def carry_sums(row_ptr, cut_row, chunk):
    """Launch 2: (row, [(chunk, slot), ...]) for every cut row, the carries in
    the order they are added."""
    sums = []
    for c, r in enumerate(cut_row):
        if r >= 0:
            c1 = (int(row_ptr[r + 1]) - 1) // chunk
            sums.append((r, [(c, 1)] + [(k, 0) for k in range(c + 1, c1 + 1)]))
    return sums


def emulate_spmm(mat, x, chunk):
    """out = A @ x by the kernel's two launches; rows and carries never
    written stay NaN."""
    d = x.shape[1]
    out = torch.full((mat.n_rows, d), float("nan"))
    carry = torch.full((chunk_count(mat.nnz, chunk), 2, d), float("nan"))
    pieces, cut_row = chunk_pieces(mat.row_ptr, chunk)
    for c, r, lo, hi, slot in pieces:
        part = (mat.val[lo:hi, None] * x[mat.col[lo:hi].long()]).sum(0)
        if slot is None:
            out[r] = part
        else:
            carry[c, slot] = part
    for r, order in carry_sums(mat.row_ptr, cut_row, chunk):
        total = carry[order[0]]
        for c, slot in order[1:]:
            total = total + carry[c, slot]
        out[r] = total
    return out


def _degrees_matrix(degrees, n_cols, seed=0):
    """Rows of the given degrees; values divided by the row's degree, as in
    the row-normalized matrices of the main path, so that a row's sum stays
    near 1 in magnitude however long the row."""
    rng = np.random.default_rng(seed)
    degrees = np.asarray(degrees, np.int64)
    row = np.repeat(np.arange(len(degrees)), degrees)
    col = rng.integers(0, n_cols, len(row))
    val = (rng.standard_normal(len(row)) + 0.1) / degrees[row]
    return row, col, val, (len(degrees), n_cols)


def _power_law_degrees(n_rows, seed=0):
    """Zipf-like degrees: a few rows of hundreds of edges, many of 0-3."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.6, n_rows) - 1, 600)


CASES = {
    "power law": _power_law_degrees(400),
    "trailing empty rows": np.concatenate([_power_law_degrees(100, seed=1), np.zeros(40, np.int64)]),
    "leading and boundary empty rows": [0, 0, 0, 32, 0, 0, 32, 0, 16, 16, 0, 64, 0],
    "no edges": [0] * 9,
    "one row of 12,345 edges": [3, 12_345, 2, 0, 5],
}


def _check_schedule(row_ptr, chunk):
    rp = [int(v) for v in row_ptr]
    n_rows, nnz = len(rp) - 1, rp[-1]
    pieces, cut_row = chunk_pieces(row_ptr, chunk)
    assert len(cut_row) == chunk_count(nnz, chunk) - 1
    sums = carry_sums(row_ptr, cut_row, chunk)
    # every edge lies in exactly one piece, and each piece in its own chunk
    covered = np.zeros(nnz, np.int64)
    for c, r, lo, hi, _ in pieces:
        assert c * chunk <= lo <= hi <= min((c + 1) * chunk, nnz)
        assert rp[r] <= lo and hi <= rp[r + 1]
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # every row is written exactly once: directly, or by the carry pass
    written = np.zeros(n_rows, np.int64)
    for _, r, _, _, slot in pieces:
        written[r] += slot is None
    for r, _ in sums:
        written[r] += 1
    assert (written == 1).all()
    # a cut row's carries are the chunks that hold its pieces, in chunk order
    for r, order in sums:
        held = [(c, slot) for c, row, _, _, slot in pieces if row == r]
        assert order == held
        assert [c for c, _ in order] == list(range(order[0][0], order[0][0] + len(order)))
        assert all(slot is not None for _, slot in held)
    return pieces, sums


@pytest.mark.parametrize("chunk", [1, 32, EDGES_PER_CHUNK])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_writes_every_row_once(case, chunk):
    row, col, val, shape = _degrees_matrix(CASES[case], 50)
    mat = build_csr_spmm(row, col, val, shape)
    _check_schedule(mat.row_ptr, chunk)


def test_schedule_splits_a_long_row_over_many_chunks():
    row_ptr = np.cumsum([0, 3, 12_345, 2, 0, 5])
    pieces, sums = _check_schedule(row_ptr, EDGES_PER_CHUNK)
    (r, order), *rest = [s for s in sums if s[0] == 1]
    assert not rest and len(order) == (3 + 12_345 - 1) // EDGES_PER_CHUNK + 1 >= 48
    # the short rows after it share its last chunk and are written directly
    assert {(r, slot) for _, r, _, _, slot in pieces if r != 1} == {(0, None), (2, None), (3, None), (4, None)}


def test_schedule_of_a_matrix_with_no_edges():
    assert n_chunks(0) == 1 and n_chunks(EDGES_PER_CHUNK) == 1 and n_chunks(EDGES_PER_CHUNK + 1) == 2
    assert all(n_chunks(nnz) == chunk_count(nnz, EDGES_PER_CHUNK) for nnz in range(0, 5 * EDGES_PER_CHUNK, 7))
    pieces, sums = _check_schedule(np.zeros(8, np.int64), EDGES_PER_CHUNK)
    assert [(r, lo, hi, slot) for _, r, lo, hi, slot in pieces] == [(r, 0, 0, None) for r in range(7)]
    assert sums == []


@settings(max_examples=150, deadline=None)
@given(
    st.lists(st.integers(0, 2000), min_size=1, max_size=200),
    st.integers(0, 2**20),
)
def test_warp_lower_bound_is_lower_bound(steps, v):
    a = np.concatenate([[0], np.cumsum(steps)])
    v = min(v, int(a[-1]))
    assert warp_lower_bound(a, len(a) - 1, v) == int(np.searchsorted(a, v, side="left"))


@settings(max_examples=60, deadline=None)
@given(
    st.lists(st.one_of(st.just(0), st.integers(1, 8), st.integers(9, 300)), min_size=1, max_size=60),
    st.sampled_from([1, 5, 32, 96, EDGES_PER_CHUNK]),
)
def test_emulation_matches_plain_on_random_degrees(degrees, chunk):
    row, col, val, shape = _degrees_matrix(degrees, 23)
    mat = build_csr_spmm(row, col, val, shape)
    _check_schedule(mat.row_ptr, chunk)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((23, 8)), dtype=torch.float32)
    out = emulate_spmm(mat, x, chunk)
    np.testing.assert_allclose(out.numpy(), spmm_csr_reference(mat.row_ptr, mat.col, mat.val, x).numpy(), **TOL)


@pytest.mark.parametrize("oracle", ["plain", "bucketed", "coo"])
@pytest.mark.parametrize("chunk", [32, EDGES_PER_CHUNK])
def test_emulation_matches_jax_on_power_law_graph(oracle, chunk):
    degrees = np.concatenate([_power_law_degrees(300, seed=2), [900], np.zeros(25, np.int64)])
    row, col, val, shape = _degrees_matrix(degrees, 120, seed=3)
    x = np.random.default_rng(4).standard_normal((shape[1], 16)).astype(np.float32)
    mat = build_csr_spmm(row, col, val, shape)
    out = emulate_spmm(mat, torch.as_tensor(x), chunk)
    if oracle == "plain":
        ref = spmm_csr_reference(mat.row_ptr, mat.col, mat.val, torch.as_tensor(x)).numpy()
    elif oracle == "bucketed":
        ref = np.asarray(spmm_bucketed(build_bucketed_spmm(row, col, val, shape), jnp.asarray(x)))
    else:
        ref = np.asarray(spmm_coo(coo_to_device(row, col, val, shape), jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
