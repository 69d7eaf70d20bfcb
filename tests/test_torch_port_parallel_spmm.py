"""The port's multi-GPU layer, its mesh and edge-sharded SpMM
(``parallel/mesh.py``, ``parallel/spmm.py``), against the JAX package's
``make_edge_sharded_spmm`` / ``make_edge_sharded_propagation`` on
``shard_map`` over conftest's 8 virtual CPU devices, and against the port's
single-device product.

The port runs in 1, 2 and 4 gloo ranks (``parallel.launch.run_ranks``): one
launch a world size, module-scoped, runs every case, and the tests read its
results. The rank bodies live in this module and import no JAX (the ranks
are fresh processes that import this module); the JAX references are made
in the test process. Inputs come from numpy seeds. Tolerance: 1e-5 *
max(1, max |ref|), since the fp32 sums run in another order; the dropout
masks, keyed by the global edge id, are compared bitwise.
"""

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

WORLDS = (1, 2, 4)
TOL = 1e-5
P_DROP, DROP_SEED = 0.3, 987_654_321


def _coo(seed, n_rows, n_cols, nnz, zeros=()):
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz)
    _, keep = np.unique(row * n_cols + col, return_index=True)  # one entry per (r, c)
    row, col = row[keep], col[keep]
    val = rng.normal(size=len(row)).astype(np.float32)
    val[list(zeros)] = 0.0
    return row, col, val


def _inputs():
    rng = np.random.default_rng(42)
    rect = _coo(1, 45, 37, 400)
    zeros = _coo(2, 24, 24, 150, zeros=(3, 17))
    square = _coo(3, 40, 40, 350)
    feat = _coo(4, 50, 30, 500)
    return {
        "rect": (rect, (45, 37), rng.normal(size=(37, 8)).astype(np.float32), rng.normal(size=(48, 8)).astype(np.float32)),
        "zeros": (zeros, (24, 24), rng.normal(size=(24, 5)).astype(np.float32),
                  rng.uniform(0.5, 1.5, len(zeros[0])).astype(np.float32)),
        "square": (square, (40, 40), rng.normal(size=(40, 8)).astype(np.float32)),
        "feat": (feat, (50, 30), rng.normal(size=(30, 6)).astype(np.float32), rng.normal(size=(52, 6)).astype(np.float32)),
    }


# -- the rank side (no JAX) -------------------------------------------------------


def spmm_ranks(inputs):
    """Every case on this rank: its pieces of the results, in numpy."""
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch.ops.csr_spmm import build_csr_spmm, dropout_values, spmm_csr_dropout
    from inductive_recommendation_tpu_torch.parallel import (
        build_edge_sharded_spmm,
        counts,
        make_edge_sharded_propagation,
        make_edge_sharded_spmm,
        make_mesh,
        reset_collective_counts,
        shard_operand,
        shard_params,
    )
    from inductive_recommendation_tpu_torch.parallel.mesh import gather_rows

    S, s = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh()
    out = {"rank": s, "model_rank": mesh.get_local_rank("model"), "data_rank": mesh.get_local_rank("data")}

    (row, col, val), shape, x, w = inputs["rect"]
    emat = build_edge_sharded_spmm(row, col, val, shape, S, s)
    out["nnz"], out["block"], out["row_block"], out["n_rows_pad"] = emat.fwd.nnz, emat.block, emat.row_block, emat.n_rows_pad
    for mode in ("scatter", "replicated"):
        fn = make_edge_sharded_spmm(emat, mesh, mode=mode)
        xl = shard_operand(x, emat, mesh).requires_grad_(True)
        reset_collective_counts()
        y = fn(xl)
        w_part = w[s * emat.row_block : (s + 1) * emat.row_block] if mode == "scatter" else w[: emat.n_rows_pad]
        (y * torch.as_tensor(w_part)).sum().backward()
        out[f"{mode}_fwd"] = y.detach().numpy()
        out[f"{mode}_grad"] = xl.grad.numpy()
        out[f"{mode}_collectives"] = dict(counts.by_kind)

    (row, col, val), shape, x, scale = inputs["zeros"]
    emat = build_edge_sharded_spmm(row, col, val, shape, S, s)
    fn = make_edge_sharded_spmm(emat, mesh)
    out["scale_fwd"] = fn(shard_operand(x, emat, mesh), torch.as_tensor(scale)).numpy()

    (row, col, val), shape, x = inputs["square"]
    emat = build_edge_sharded_spmm(row, col, val, shape, S, s)
    out["prop"] = make_edge_sharded_propagation(emat, mesh, 3)(shard_operand(x, emat, mesh)).numpy()

    # dropout: the shard's kept edges and product against the single-device port
    (row, col, val), shape, x, g = inputs["feat"]
    emat = build_edge_sharded_spmm(row, col, val, shape, S, s)
    xl = shard_operand(x, emat, mesh).requires_grad_(True)
    y = make_edge_sharded_spmm(emat, mesh)(xl, drop=(DROP_SEED, P_DROP))
    (y * torch.as_tensor(g[s * emat.row_block : (s + 1) * emat.row_block])).sum().backward()
    out["drop_fwd"], out["drop_grad"] = y.detach().numpy(), xl.grad.numpy()
    out["drop_values"] = {
        side: dict(zip(m.eid.tolist(), dropout_values(m.val, m.eid, DROP_SEED, P_DROP).tolist()))
        for side, m in (("fwd", emat.fwd), ("bwd", emat.bwd))
    }
    single = build_csr_spmm(row, col, val, shape)
    x1 = torch.as_tensor(x).requires_grad_(True)
    y1 = spmm_csr_dropout(single, x1, DROP_SEED, P_DROP)
    (y1 * torch.as_tensor(g[: shape[0]])).sum().backward()
    out["drop_single"] = (y1.detach().numpy(), x1.grad.numpy())
    out["drop_values_single"] = dict(zip(single.eid.tolist(), dropout_values(single.val, single.eid, DROP_SEED, P_DROP).tolist()))

    # the sharding rule: tables row-sharded (padded), the rest copied
    table = torch.arange(7 * 3, dtype=torch.float32).view(7, 3)
    sharded = shard_params({"embedding": table, "w": torch.ones(3)}, mesh)
    out["table_local"] = sharded["embedding"].detach().numpy()
    out["table_back"] = gather_rows(sharded["embedding"], mesh)[:7].numpy()
    return out


# -- the test side ------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs):
    return {S: run_ranks(f"{__name__}:spmm_ranks", S, inputs) for S in WORLDS}


def _jax(S):
    from inductive_recommendation_tpu.parallel import make_mesh

    return make_mesh(n_data=8 // S, n_model=S)


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


def _dense(row, col, val, shape):
    a = np.zeros(shape, np.float64)
    np.add.at(a, (row, col), val)
    return a


@pytest.mark.parametrize("S", WORLDS)
@pytest.mark.parametrize("mode", ["scatter", "replicated"])
def test_forward_and_grad_match_jax(runs, inputs, S, mode):
    import jax
    import jax.numpy as jnp

    from inductive_recommendation_tpu.parallel.spmm import build_edge_sharded_spmm, make_edge_sharded_spmm, shard_operand

    (row, col, val), shape, x, w = inputs["rect"]
    mesh = _jax(S)
    mat = build_edge_sharded_spmm(row, col, val, shape, S)
    fn = make_edge_sharded_spmm(mat, mesh, mode=mode)
    y, vjp = jax.vjp(fn, shard_operand(x, mat, mesh))
    (gx,) = vjp(jnp.asarray(w[: mat.n_rows_pad]))
    ranks = runs[S]
    fwd = np.concatenate([r[f"{mode}_fwd"] for r in ranks]) if mode == "scatter" else ranks[0][f"{mode}_fwd"]
    _close(fwd, np.asarray(y))
    _close(np.concatenate([r[f"{mode}_grad"] for r in ranks]), np.asarray(gx))
    if mode == "replicated":  # every rank holds all of out
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{mode}_fwd"], ranks[0][f"{mode}_fwd"])
    # one reduce-scatter (or all-reduce) forward; an all-gather backward in scatter mode only
    want = {"scatter": {"reduce_scatter": 1, "all_gather": 1, "all_reduce": 0, "all_reduce_max": 0},
            "replicated": {"reduce_scatter": 0, "all_gather": 0, "all_reduce": 1, "all_reduce_max": 0}}[mode]
    assert all(r[f"{mode}_collectives"] == want for r in ranks)


@pytest.mark.parametrize("S", WORLDS)
def test_edge_scale_with_zero_entries_matches_jax(runs, inputs, S):
    """Global edge ids count the raw COO order, zero-valued entries included,
    so a scale vector in that order reaches the right edges (JAX
    tests/test_edge_sharded_spmm.py:337)."""
    import jax.numpy as jnp

    from inductive_recommendation_tpu.parallel.spmm import build_edge_sharded_spmm, make_edge_sharded_spmm, shard_operand

    (row, col, val), shape, x, scale = inputs["zeros"]
    mesh = _jax(S)
    mat = build_edge_sharded_spmm(row, col, val, shape, S)
    ref = np.asarray(make_edge_sharded_spmm(mat, mesh)(shard_operand(x, mat, mesh), jnp.asarray(scale)))
    got = np.concatenate([r["scale_fwd"] for r in runs[S]])
    _close(got, ref)
    _close(got[: shape[0]], _dense(row, col, val * scale, shape) @ x)


@pytest.mark.parametrize("S", WORLDS)
def test_propagation_chain_matches_jax(runs, inputs, S):
    from inductive_recommendation_tpu.parallel.spmm import build_edge_sharded_spmm, make_edge_sharded_propagation, shard_operand

    (row, col, val), shape, x = inputs["square"]
    mesh = _jax(S)
    mat = build_edge_sharded_spmm(row, col, val, shape, S)
    ref = np.asarray(make_edge_sharded_propagation(mat, mesh, n_layers=3)(shard_operand(x, mat, mesh)))
    _close(np.concatenate([r["prop"] for r in runs[S]]), ref)


@pytest.mark.parametrize("S", WORLDS)
def test_dropout_matches_single_device_port(runs, inputs, S):
    """Under dropout the shards drop exactly the single-device product's
    edges (the mask is keyed by the global edge id): the kept edges and
    their values are bitwise equal on both sides of every shard, and the
    product and its gradient agree."""
    ranks = runs[S]
    single = ranks[0]["drop_values_single"]
    for side in ("fwd", "bwd"):
        merged = {}
        for r in ranks:
            merged.update(r["drop_values"][side])
        assert merged == single
    y1, g1 = ranks[0]["drop_single"]
    (_, _, _), shape, _, _ = inputs["feat"]
    _close(np.concatenate([r["drop_fwd"] for r in ranks])[: shape[0]], y1)
    _close(np.concatenate([r["drop_grad"] for r in ranks])[: shape[1]], g1)
    kept = sum(v != 0 for v in single.values())
    assert 0 < kept < len(single)


@pytest.mark.parametrize("S", WORLDS)
def test_shards_hold_a_share(runs, inputs, S):
    """Each rank holds about 1/S of the edges, a column block of the operand
    and a row block of the output; the mesh puts every rank on 'model'."""
    (row, _, _), shape, _, _ = inputs["rect"]
    ranks = runs[S]
    nnz = [r["nnz"] for r in ranks]
    assert sum(nnz) == len(row)
    assert all(0.5 * len(row) / S <= n <= 1.5 * len(row) / S for n in nnz)
    assert all(r["block"] == -(-shape[1] // S) and r["row_block"] * S == r["n_rows_pad"] for r in ranks)
    assert [r["model_rank"] for r in ranks] == list(range(S)) and all(r["data_rank"] == 0 for r in ranks)


@pytest.mark.parametrize("S", WORLDS)
def test_table_rows_shard_and_gather(runs, S):
    table = np.arange(21, dtype=np.float32).reshape(7, 3)
    blk = -(-7 // S)
    padded = np.zeros((blk * S, 3), np.float32)
    padded[:7] = table
    for r in runs[S]:
        np.testing.assert_array_equal(r["table_local"], padded[r["rank"] * blk : (r["rank"] + 1) * blk])
        np.testing.assert_array_equal(r["table_back"], table)


@pytest.mark.parametrize("S", WORLDS)
def test_shard_layout_spans_only_its_rows(S):
    """On a bipartite adjacency a block of user columns has its edges in item
    rows only, and a block of item columns in user rows only: each shard's
    CSR spans just the rows from its first edge to its last, and its
    products, placed back at those rows, are the dense column block's."""
    from inductive_recommendation_tpu_torch.graph import sym_normalized_adjacency
    from inductive_recommendation_tpu_torch.ops.csr_spmm import spmm_csr_reference
    from inductive_recommendation_tpu_torch.parallel.spmm import build_edge_sharded_spmm, place_rows

    rng = np.random.default_rng(5)
    n_users, n_items = 40, 50
    row, col, val = sym_normalized_adjacency(
        np.stack([rng.integers(0, n_users, 400), rng.integers(0, n_items, 400)], axis=1), n_users, n_items
    )
    n = n_users + n_items
    a = _dense(row, col, val, (n, n))
    x, g = rng.normal(size=(n, 8)), rng.normal(size=(n, 8))
    one_sided = 0
    for s in range(S):
        emat = build_edge_sharded_spmm(row, col, val, (n, n), S, s)
        lo, hi, blk = emat.row_lo, emat.row_hi, emat.block
        cols = slice(s * blk, min((s + 1) * blk, n))
        nz = np.nonzero(a[:, cols].any(axis=1))[0]
        assert (lo, hi) == (nz.min(), nz.max() + 1) and emat.fwd.n_rows == hi - lo == emat.bwd.n_cols
        counts = np.diff(emat.fwd.row_ptr.numpy())
        assert counts[0] > 0 and counts[-1] > 0
        xs = np.zeros((blk, 8))
        xs[: cols.stop - cols.start] = x[cols]
        fwd = place_rows(emat, spmm_csr_reference(emat.fwd.row_ptr, emat.fwd.col, emat.fwd.val, torch.as_tensor(xs, dtype=torch.float32)))
        _close(fwd.numpy()[:n], a[:, cols] @ x[cols])
        bwd = spmm_csr_reference(emat.bwd.row_ptr, emat.bwd.col, emat.bwd.val, torch.as_tensor(g[lo:hi], dtype=torch.float32))
        _close(bwd.numpy()[: cols.stop - cols.start], a[:, cols].T @ g)
        # a block of one side's columns skips that side's rows
        if cols.stop <= n_users:
            assert lo >= n_users
            one_sided += 1
        if cols.start >= n_users:
            assert hi <= n_users
            one_sided += 1
    assert one_sided == {1: 0, 2: 1, 4: 3}[S]


def test_layout_refuses_a_wrong_mesh():
    from inductive_recommendation_tpu_torch.parallel.spmm import build_edge_sharded_spmm

    (row, col, val), shape, _, _ = _inputs()["rect"]
    with pytest.raises(ValueError, match="rank 2 outside 2 shards"):
        build_edge_sharded_spmm(row, col, val, shape, 2, 2)
    mat = build_edge_sharded_spmm(row, col, val, shape, 2, 1)
    assert mat.fwd.route == mat.bwd.route == "edge_shard" and mat.bwd.transposed
    assert int(mat.eid_map.max()) < len(row) and sorted(mat.eid_map.tolist()) == sorted(mat.fwd.eid.tolist())
    from inductive_recommendation_tpu_torch.ops.csr_spmm import route_key

    assert route_key(mat.fwd) == "edge_shard" and route_key(mat.bwd, (1, 0.3)) == "edge_shard_transpose_dropout"


def test_init_distributed_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a card the layer joins no NCCL group on its own: it raises,
    and only ``device="cpu"`` takes gloo (checked before any group exists)."""
    from inductive_recommendation_tpu_torch.parallel.mesh import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="start the ranks with torchrun"):
        init_distributed(device="cpu")
