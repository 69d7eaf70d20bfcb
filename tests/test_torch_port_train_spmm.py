"""The training uses of the port's CSR SpMM against the JAX package: the
transpose layout and the autograd backward, and the edge dropout drawn from
the edge id.

On CPU tensors the products run their plain PyTorch versions; the kernel
itself is held against them on the card by ``chip_smoke.py`` (phase 7).
Inputs come from numpy seeds. Tolerance rtol 1e-5 / atol 1e-6: both sides sum
fp32 products, in different orders. JAX draws its dropout with threefry, so
the JAX side is given the port's mask as an ``edge_scale``; there the atol is
1e-6 times the output's largest magnitude (sums reach 10 there), since a
kept value is val / (1 - p) on the port's side and val * (1 / (1 - p)) on
JAX's, one ulp apart."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.graph import build_feat_matrix, sym_normalized_adjacency
from inductive_recommendation_tpu.ops import build_bucketed_spmm, spmm_bucketed
from inductive_recommendation_tpu.ops import bucketed_spmm as jax_bucketed
from inductive_recommendation_tpu.ops import propagate_mean as jax_propagate_mean
from inductive_recommendation_tpu_torch.ops import (
    CsrSpMM,
    build_csr_spmm,
    edge_uniform,
    propagate_mean,
    spmm_csr,
    spmm_csr_dropout,
    spmm_csr_dropout_reference,
    spmm_csr_reference,
    with_annealed_values,
)
from inductive_recommendation_tpu_torch.ops.csr_spmm import EDGES_PER_CHUNK, dropout_values, philox_word0

TOL = dict(rtol=1e-5, atol=1e-6)
ALPHA = 0.99**3  # after three anneals
P = 0.3


@pytest.fixture(scope="module")
def feat():
    """The IGCN feature matrix of one small synthetic set as COO arrays, with
    its row sums."""
    ds = quick_synthetic_dataset(200, 150, 3000, seed=0)
    row, col, counts, row_sum = build_feat_matrix(
        ds.train_array, ds.n_users, ds.n_items, np.arange(ds.n_users), np.arange(ds.n_items)
    )
    shape = (ds.n_users + ds.n_items, ds.n_users + ds.n_items + 2)
    return row, col, counts, row_sum, shape


def _grad_port(fn, x, w):
    xt = torch.as_tensor(x).requires_grad_(True)
    out = fn(xt)
    (out * torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _grad_jax(fn, x, w):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(w))[0])


def _inputs(shape, d=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((shape[1], d)).astype(np.float32)
    w = rng.standard_normal((shape[0], d)).astype(np.float32)
    return x, w


def _coo_mask(n_edges, seed, p):
    """keep / (1 - p) for every raw COO edge id, in COO order."""
    ids = torch.arange(n_edges, dtype=torch.int32)
    return dropout_values(torch.ones(n_edges), ids, seed, p).numpy()


def test_transpose_layout_contract():
    """A^T: rows are A's columns sorted stably, with the same edge ids; the
    forward arrays are those of a layout without a transpose."""
    row = np.array([2, 0, 2, 1, 0, 2])
    col = np.array([1, 3, 0, 2, 0, 3])
    val = np.array([1.0, 2.0, 0.0, 3.0, 4.0, 5.0])
    mat = build_csr_spmm(row, col, val, (4, 5))
    assert mat.eid.tolist() == [1, 4, 3, 0, 5] and mat.row_ptr.tolist() == [0, 2, 3, 5, 5]
    t = mat.T
    assert t.transposed and not mat.transposed and t.shape == (5, 4)
    assert t.row_ptr.tolist() == [0, 1, 2, 3, 5, 5]
    assert t.col.tolist() == [0, 2, 1, 0, 2]
    assert t.eid.tolist() == [4, 0, 3, 1, 5]
    assert t.val.tolist() == [4.0, 1.0, 3.0, 2.0, 5.0]
    sym = build_csr_spmm(row, col, val, (4, 5), symmetric=True)
    assert sym.T is sym and sym.transpose is None
    bare = CsrSpMM(mat.row_ptr, mat.col, mat.val, mat.eid, 4, 5)
    with pytest.raises(ValueError, match="transpose"):
        spmm_csr(bare, torch.zeros(5, 2, requires_grad=True)).sum().backward()


@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_backward_matches_jax_grad(feat, scaled, annealed):
    """grad_x of (A o S) @ x through the transpose layout against jax.vjp
    through spmm_bucketed built with symmetric=False, plain and with an
    edge_scale, at alpha 1 and after three anneals."""
    row, col, counts, row_sum, shape = feat
    x, w = _inputs(shape)
    scale = np.random.default_rng(5).random(len(row)).astype(np.float32) if scaled else None
    port = build_csr_spmm(row, col, counts, shape)
    jmat = build_bucketed_spmm(row, col, counts, shape, symmetric=False)
    if annealed:
        port = with_annealed_values(port, torch.as_tensor(row_sum), ALPHA)
        jmat = jax_bucketed.with_annealed_values(jmat, jnp.asarray(row_sum), ALPHA)
    t_scale = None if scale is None else torch.as_tensor(scale)
    j_scale = None if scale is None else jnp.asarray(scale)
    out, grad = _grad_port(lambda xt: spmm_csr(port, xt, edge_scale=t_scale), x, w)
    j_out, j_grad = _grad_jax(lambda xj: spmm_bucketed(jmat, xj, edge_scale=j_scale), x, w)
    np.testing.assert_allclose(out, j_out, **TOL)
    np.testing.assert_allclose(grad, j_grad, **TOL)
    assert np.abs(grad).max() > 0


def test_propagate_mean_backward_matches_jax(feat):
    """A symmetric layout is its own transpose: the gradient of the layer mean
    over the sym-normalized adjacency."""
    ds = quick_synthetic_dataset(200, 150, 3000, seed=0)
    n = ds.n_users + ds.n_items
    adj = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
    port = build_csr_spmm(*adj, (n, n), symmetric=True)
    jmat = build_bucketed_spmm(*adj, (n, n), symmetric=True)
    x, w = _inputs((n, n), d=16, seed=3)
    out, grad = _grad_port(lambda xt: propagate_mean(port, xt, 3), x, w)
    j_out, j_grad = _grad_jax(lambda xj: jax_propagate_mean(jmat, xj, 3), x, w)
    np.testing.assert_allclose(out, j_out, **TOL)
    np.testing.assert_allclose(grad, j_grad, **TOL)


@pytest.mark.parametrize("annealed", [False, True])
def test_dropout_product_matches_jax_given_the_mask(feat, annealed):
    """The dropout product and its gradient against spmm_bucketed handed the
    port's mask, keep / (1 - p) in COO order, as its edge_scale."""
    row, col, counts, row_sum, shape = feat
    x, w = _inputs(shape, seed=4)
    seed = 0x1234_5678_9ABC_DEF0
    port = build_csr_spmm(row, col, counts, shape)
    jmat = build_bucketed_spmm(row, col, counts, shape, symmetric=False)
    if annealed:
        port = with_annealed_values(port, torch.as_tensor(row_sum), ALPHA)
        jmat = jax_bucketed.with_annealed_values(jmat, jnp.asarray(row_sum), ALPHA)
    mask = jnp.asarray(_coo_mask(len(row), seed, P))
    out, grad = _grad_port(lambda xt: spmm_csr_dropout(port, xt, seed, P), x, w)
    j_out, j_grad = _grad_jax(lambda xj: spmm_bucketed(jmat, xj, edge_scale=mask), x, w)
    for got, want in ((out, j_out), (grad, j_grad)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():
        np.testing.assert_array_equal(
            spmm_csr_dropout(port, torch.as_tensor(x), seed, P).numpy(),
            spmm_csr_dropout_reference(port, torch.as_tensor(x), seed, P).numpy(),
        )


def _philox_ints(counter, key):
    """Philox4x32-10 with Python integers: all four output words."""
    m = 0xFFFFFFFF
    c, k = list(counter), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & m, p1 & m, ((p0 >> 32) ^ c[3] ^ k[1]) & m, p0 & m]
    return c


@pytest.mark.parametrize(
    "counter, key, expected",
    [  # the Random123 known-answer vectors of philox4x32-10
        ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
        ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
        (
            [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
            [0xA4093822, 0x299F31D0],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1],
        ),
    ],
)
def test_philox_known_answers(counter, key, expected):
    assert _philox_ints(counter, key) == expected
    if counter[1:] == [0, 0, 0]:
        seed = key[0] | key[1] << 32
        assert philox_word0(seed, torch.tensor([counter[0]])).tolist() == [expected[0]]


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**64 - 1), st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=50))
def test_philox_word0_matches_integer_philox(seed, counters):
    """The torch version (16-bit halves in int64) equals Python-integer Philox."""
    key = [seed & 0xFFFFFFFF, seed >> 32]
    got = philox_word0(seed, torch.tensor(counters, dtype=torch.int32)).tolist()
    assert got == [_philox_ints([c, 0, 0, 0], key)[0] for c in counters]
    u = edge_uniform(seed, torch.tensor(counters, dtype=torch.int32))
    assert u.dtype == torch.float32 and bool(((u >= 0) & (u < 1)).all())
    np.testing.assert_array_equal(u.numpy() * 2**24, np.asarray(got) >> 8)


def _edge_table(mat: CsrSpMM, seed, p):
    """(eid, row, col, masked value) of every edge, ordered by edge id."""
    order = torch.argsort(mat.eid)
    vals = dropout_values(mat.val, mat.eid, seed, p)
    return [t[order].tolist() for t in (mat.eid, mat.edge_rows(), mat.col, vals)]


@settings(max_examples=25, deadline=None)
@given(
    st.lists(st.one_of(st.just(0), st.integers(1, 8), st.integers(9, 300)), min_size=1, max_size=30),
    st.integers(0, 30),
    st.integers(40 * EDGES_PER_CHUNK + 1, 42 * EDGES_PER_CHUNK),
    st.integers(1, 70),
    st.integers(0, 2**64 - 1),
    st.sampled_from([0.1, 0.3, 0.5]),
)
def test_one_mask_for_the_forward_and_the_transpose(degrees, at, long_row, n_cols, seed, p):
    """(A o M) read from the forward layout equals ((A^T) o M)^T read from the
    transpose, edge for edge, on power-law degree profiles with a row longer
    than 40 chunks; the backward is the transpose product under that mask, and
    p = 0 is the plain product bit for bit."""
    degrees = list(degrees)
    degrees.insert(at % (len(degrees) + 1), long_row)
    rng = np.random.default_rng(len(degrees))
    row = np.repeat(np.arange(len(degrees)), degrees)
    col = rng.integers(0, n_cols, len(row))
    val = rng.standard_normal(len(row)).astype(np.float32) + 0.1
    mat = build_csr_spmm(row, col, val, (len(degrees), n_cols))
    f_eid, f_row, f_col, f_val = _edge_table(mat, seed, p)
    t_eid, t_row, t_col, t_val = _edge_table(mat.T, seed, p)
    assert f_eid == t_eid and f_row == t_col and f_col == t_row and f_val == t_val

    x = torch.as_tensor(rng.standard_normal((n_cols, 4)), dtype=torch.float32).requires_grad_(True)
    g = torch.as_tensor(rng.standard_normal((len(degrees), 4)), dtype=torch.float32)
    spmm_csr_dropout(mat, x, seed, p).backward(g)
    masked_t = dataclasses.replace(mat.T, val=dropout_values(mat.T.val, mat.T.eid, seed, p))
    ref = spmm_csr_reference(masked_t.row_ptr, masked_t.col, masked_t.val, g)
    np.testing.assert_allclose(x.grad.numpy(), ref.numpy(), **TOL)
    with torch.no_grad():
        assert torch.equal(spmm_csr_dropout(mat, x, seed, 0.0), spmm_csr(mat, x))


def test_products_take_their_operands_without_copies(feat, monkeypatch):
    """Through IGCN's get_rep and its backward (dropout product, then
    propagate_mean over the adjacency), every operand reaches the product
    contiguous, so the kernel's ``.contiguous()`` copies nothing."""
    from inductive_recommendation_tpu_torch.ops import csr_spmm

    ds = quick_synthetic_dataset(200, 150, 3000, seed=0)
    n = ds.n_users + ds.n_items
    adj = build_csr_spmm(*sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items), (n, n), symmetric=True)
    row, col, counts, _, shape = feat
    mat = build_csr_spmm(row, col, counts, shape)
    seen = []
    product = csr_spmm._product

    def recording(m, x, edge_scale=None, drop=None):
        seen.append((m.transposed, x.is_contiguous()))
        return product(m, x, edge_scale, drop)

    monkeypatch.setattr(csr_spmm, "_product", recording)
    emb = torch.as_tensor(_inputs(shape, d=16)[0]).requires_grad_(True)
    propagate_mean(adj, spmm_csr_dropout(mat, emb[: shape[1]], 5, P), 3).sum().backward()
    assert seen == [(False, True)] * 4 + [(False, True)] * 3 + [(True, True)]


def test_dropout_seeds_and_refusals(feat):
    row, col, counts, _, shape = feat
    mat = build_csr_spmm(row, col, counts, shape)
    x = torch.as_tensor(_inputs(shape)[0])
    a = spmm_csr_dropout(mat, x, 7, P)
    assert torch.equal(a, spmm_csr_dropout(mat, x, 7, P))
    assert not torch.equal(a, spmm_csr_dropout(mat, x, 8, P))
    sym = build_csr_spmm(row, col, counts, shape, symmetric=True)
    with pytest.raises(ValueError, match="symmetric"):
        spmm_csr_dropout(sym, x, 7, P)
    for seed, p in ((7, 1.0), (7, -0.1), (-1, P), (2**64, P)):
        with pytest.raises(ValueError):
            spmm_csr_dropout(mat, x, seed, p)
