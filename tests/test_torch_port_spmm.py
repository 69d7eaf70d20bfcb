"""The PyTorch port's CSR SpMM layer against the JAX package's SpMMs.

On CPU tensors ``spmm_csr`` runs its plain PyTorch version (the CUDA kernel
needs the card and is checked against the same plain version by
``chip_smoke.py``). Tolerance rtol 1e-5 / atol 1e-6: both sides sum fp32
products, in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.graph import (
    build_feat_matrix,
    coo_to_device,
    ell_from_coo,
    sym_normalized_adjacency,
)
from inductive_recommendation_tpu.graph.build import feat_values_for_alpha
from inductive_recommendation_tpu.ops import build_bucketed_spmm, propagate_mean as jax_propagate_mean
from inductive_recommendation_tpu.ops import spmm_bucketed
from inductive_recommendation_tpu.ops import bucketed_spmm as jax_bucketed
from inductive_recommendation_tpu.ops.pallas_spmm import spmm_ell_pallas
from inductive_recommendation_tpu.ops.spmm import spmm_coo
from inductive_recommendation_tpu.ops.topk import mask_scores as jax_mask_scores
from inductive_recommendation_tpu.ops.topk import masked_topk as jax_masked_topk
from inductive_recommendation_tpu_torch.ops import (
    build_csr_spmm,
    mask_scores,
    masked_topk,
    propagate_mean,
    spmm,
    spmm_csr,
    spmm_csr_cuda,
    with_annealed_values,
)

TOL = dict(rtol=1e-5, atol=1e-6)
ALPHA = 0.99**2  # after two anneals


@pytest.fixture(scope="module")
def graphs():
    """The symmetric adjacency and the annealed rectangular IGCN feature
    matrix of one small synthetic set, as COO arrays."""
    ds = quick_synthetic_dataset(200, 150, 3000, seed=0)
    n = ds.n_users + ds.n_items
    adj = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
    user_map, item_map = np.arange(ds.n_users), np.arange(ds.n_items)
    row, col, counts, row_sum = build_feat_matrix(ds.train_array, ds.n_users, ds.n_items, user_map, item_map)
    return {
        "adj": dict(coo=adj, shape=(n, n), symmetric=True, row_sum=None),
        "feat": dict(coo=(row, col, counts), shape=(n, ds.n_users + ds.n_items + 2), symmetric=False, row_sum=row_sum),
    }


def _port_mat(g):
    mat = build_csr_spmm(*g["coo"], g["shape"], symmetric=g["symmetric"])
    if g["row_sum"] is not None:
        mat = with_annealed_values(mat, torch.as_tensor(g["row_sum"]), ALPHA)
    return mat


def _jax_oracle(g, oracle, x):
    row, col, val = g["coo"]
    if g["row_sum"] is not None and oracle != "bucketed":
        val = np.asarray(feat_values_for_alpha(jnp.asarray(row), jnp.asarray(val), jnp.asarray(g["row_sum"]), ALPHA))
    if oracle == "bucketed":
        mat = build_bucketed_spmm(row, col, val, g["shape"], symmetric=g["symmetric"])
        if g["row_sum"] is not None:
            mat = jax_bucketed.with_annealed_values(mat, jnp.asarray(g["row_sum"]), ALPHA)
        return spmm_bucketed(mat, jnp.asarray(x))
    if oracle == "coo":
        return spmm_coo(coo_to_device(row, col, val, g["shape"]), jnp.asarray(x))
    return spmm_ell_pallas(ell_from_coo(row, col, val, g["shape"]), jnp.asarray(x), tile_rows=8, interpret=True)


@pytest.mark.parametrize("oracle", ["bucketed", "coo", "pallas"])
@pytest.mark.parametrize("matrix", ["adj", "feat"])
def test_spmm_csr_matches_jax(graphs, matrix, oracle):
    g = graphs[matrix]
    x = np.random.default_rng(2).standard_normal((g["shape"][1], 16)).astype(np.float32)
    out = spmm_csr(_port_mat(g), torch.as_tensor(x))
    assert out.shape == (g["shape"][0], 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_oracle(g, oracle, x)), **TOL)


def test_propagate_mean_matches_jax(graphs):
    g = graphs["adj"]
    x = np.random.default_rng(3).standard_normal((g["shape"][0], 16)).astype(np.float32)
    jmat = build_bucketed_spmm(*g["coo"], g["shape"], symmetric=True)
    for n_layers in (0, 1, 3):
        out = propagate_mean(_port_mat(g), torch.as_tensor(x), n_layers)
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_propagate_mean(jmat, jnp.asarray(x), n_layers)), **TOL)


def test_csr_layout_contract():
    """Edge ids count the raw COO order before explicit zeros are dropped;
    rows are sorted stably; the arrays have the kernel's dtypes."""
    row = np.array([2, 0, 2, 1, 0, 2])
    col = np.array([1, 3, 0, 2, 0, 3])
    val = np.array([1.0, 2.0, 0.0, 3.0, 4.0, 5.0])
    mat = build_csr_spmm(row, col, val, (4, 4))
    assert mat.row_ptr.tolist() == [0, 2, 3, 5, 5]
    assert mat.eid.tolist() == [1, 4, 3, 0, 5]
    assert mat.col.tolist() == [3, 0, 2, 1, 3]
    assert mat.val.tolist() == [2.0, 4.0, 3.0, 1.0, 5.0]
    assert mat.edge_rows().tolist() == [0, 0, 1, 2, 2]
    assert (mat.row_ptr.dtype, mat.col.dtype, mat.val.dtype, mat.eid.dtype) == (
        torch.int32, torch.int32, torch.float32, torch.int32,
    )
    assert mat.nnz == 5 and mat.shape == (4, 4)


def test_edge_scale_matches_jax(graphs):
    row, col, counts = graphs["feat"]["coo"]
    shape = graphs["feat"]["shape"]
    rng = np.random.default_rng(4)
    scale = rng.random(len(row)).astype(np.float32)
    x = rng.standard_normal((shape[1], 8)).astype(np.float32)
    out = spmm_csr(build_csr_spmm(row, col, counts, shape), torch.as_tensor(x), edge_scale=torch.as_tensor(scale))
    ref = spmm_bucketed(build_bucketed_spmm(row, col, counts, shape), jnp.asarray(x), edge_scale=jnp.asarray(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    sym = build_csr_spmm(*graphs["adj"]["coo"], graphs["adj"]["shape"], symmetric=True)
    with pytest.raises(ValueError, match="symmetric"):
        spmm_csr(sym, torch.zeros(sym.n_cols, 8), edge_scale=torch.ones(sym.nnz))
    with pytest.raises(ValueError, match="symmetric"):
        with_annealed_values(sym, torch.ones(sym.n_rows), 0.5)


def test_spmm_refuses_what_it_cannot_run(graphs):
    mat = _port_mat(graphs["adj"])
    with pytest.raises(ValueError):
        spmm_csr(mat, torch.zeros(mat.n_cols + 1, 4))
    with pytest.raises(ValueError):
        spmm_csr(mat, torch.zeros(mat.n_cols, 4, device="meta"))
    with pytest.raises(TypeError):
        spmm(graphs["adj"]["coo"], torch.zeros(mat.n_cols, 4))
    # the kernel's wrapper takes CUDA tensors only, and counts no launch otherwise
    before = spmm_csr_cuda.launches
    with pytest.raises(ValueError, match="cuda"):
        spmm_csr_cuda(mat, torch.zeros(mat.n_cols, 4))
    assert spmm_csr_cuda.launches == before


def test_masked_topk_matches_jax():
    rng = np.random.default_rng(5)
    n_items = 40
    # distinct scores: no ties, so both frameworks rank alike
    scores = rng.permutation(32 * n_items).reshape(32, n_items).astype(np.float32)
    excl = np.full((32, 6), n_items, dtype=np.int32)  # the sentinel pads every row
    for r in range(32):
        k = rng.integers(0, 6)
        excl[r, :k] = rng.choice(n_items, size=k, replace=False)
    banned = rng.random(n_items) < 0.2
    t_scores = torch.as_tensor(scores)
    masked = mask_scores(t_scores, torch.as_tensor(excl), torch.as_tensor(banned))
    ref = np.asarray(jax_mask_scores(jnp.asarray(scores), jnp.asarray(excl), jnp.asarray(banned)))
    np.testing.assert_array_equal(masked.numpy(), ref)
    assert torch.equal(t_scores, torch.as_tensor(scores))  # the input is left as it was
    vals, idx = masked_topk(t_scores, 10, torch.as_tensor(excl), torch.as_tensor(banned))
    jvals, jidx = jax_masked_topk(jnp.asarray(scores), 10, jnp.asarray(excl), jnp.asarray(banned))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_masked_topk_plain_path_with_ties_and_a_ban_matches_jax():
    """The plain path (CPU tensors) where scores tie, also at the k-th place:
    the values equal JAX's, each id scores its value, the ids above the k-th
    value are JAX's as a set, and the rest are distinct ids of the k-th value
    (``torch.topk`` on the CPU does not promise JAX's lower-index-first order
    among ties)."""
    rng = np.random.default_rng(11)
    n_items, k = 60, 12
    scores = np.round(rng.normal(0.0, 1.0, (16, n_items)), 0).astype(np.float32)  # a few levels
    excl = np.full((16, 8), n_items, dtype=np.int32)
    for r in range(16):
        excl[r, : r % 8] = rng.choice(n_items, size=r % 8, replace=False)
    banned = rng.random(n_items) < 0.25
    vals, idx = masked_topk(torch.as_tensor(scores), k, torch.as_tensor(excl), torch.as_tensor(banned))
    jvals, jidx = jax_masked_topk(jnp.asarray(scores), k, jnp.asarray(excl), jnp.asarray(banned))
    jvals, jidx = np.asarray(jvals), np.asarray(jidx)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    masked = np.asarray(jax_mask_scores(jnp.asarray(scores), jnp.asarray(excl), jnp.asarray(banned)))
    above = jvals > jvals[:, -1:]
    for row, want, sel in zip(idx.numpy(), jidx, above):
        assert set(row[sel].tolist()) == set(want[sel].tolist())
    np.testing.assert_array_equal(np.take_along_axis(masked, idx.numpy(), 1), jvals)
    assert all(len(set(row)) == k for row in idx.numpy().tolist())
    assert (jvals[:, -1:] == jvals[:, -2:-1]).any(), "the case has ties at the k-th place"
