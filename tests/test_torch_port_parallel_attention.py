"""The port's edge-sharded attention (``parallel/attention.py``) and its
AttIGCN edge step against the JAX package's: the attention aggregation and
its gradients in the folded query, Wk, bk and the value table against
``make_edge_sharded_attention`` under ``shard_map`` and ``jax.grad`` (as
``tests/test_edge_sharded_attention.py:77-130`` holds JAX's to its single
device), the shard's attention against the port's single-device
``fused_kv_attention``, the collectives of one forward and of its backward, and
AttIGCN's ``IGCNTrainer`` in edge mode (its model's forward under the edge
placement) against JAX's ``make_edge_sharded_att_igcn_step`` for 3 Adam
steps at S = 1, 2, 4 with JAX's batches handed in and from JAX's init, and
its first step's gradients of every parameter (Wq and Wk get theirs through
``collectives.shared``) against JAX's, read from an optax transformation
that keeps them as its state.

Ranks run over gloo (``parallel.launch.run_ranks``), one launch per world
size; JAX runs on conftest's 8 virtual devices at (8 / S, S). The loss of
the aggregation test is sum(out * w), each rank its own rows' term, so the
gradients are each rank's parts of the one loss's (torch's convention,
``parallel/collectives.py``). Tolerance 1e-5 * max(1, max |ref|) (fp32 sums
in another order); tables after Adam within 1e-4 (an Adam step does not
shrink with the gradient, so noise-level gradients move an entry by up to lr).
"""

import math

import numpy as np
import pytest

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

WORLDS = (1, 2, 4)
TEMPERATURE = 3.7
TOL = 1e-5
TABLE_TOL = 1e-4
D, N_LAYERS, N_HEADS, BATCH, LR, L2, AUX = 16, 2, 2, 64, 1e-3, 1e-4, 0.01
N_USERS, N_ITEMS, N_INTER = 50, 40, 600
ALPHA_STEPS = 3


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    n_rows, n_cols, nnz, h, dh, dv = 24, 20, 150, 2, 4, 5
    pairs = np.unique(np.stack([rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz)], 1), axis=0)
    row, col = pairs[:, 0], pairs[:, 1]
    val = rng.uniform(0.5, 1.5, len(row)).astype(np.float32)
    return {
        "coo": (row, col, val), "shape": (n_rows, n_cols),
        "q": rng.normal(size=(n_rows, h, dh)).astype(np.float32),
        "wk": rng.normal(size=(dv, h * dh)).astype(np.float32),
        "bk": rng.normal(size=(h * dh,)).astype(np.float32),
        "v": rng.normal(size=(n_cols, dv)).astype(np.float32),
        "w": rng.normal(size=(n_rows, dv)).astype(np.float32),
    }


def _model_inputs():
    """The AttIGCN step's inputs from the JAX package's builders, JAX's init
    params and the batches its step draws at counters 1..3."""
    import jax

    from inductive_recommendation_tpu import get_model as jax_get_model
    from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset, quick_synthetic_dataset
    from inductive_recommendation_tpu.data.sampling import build_sampler_state, sample_bpr_batch
    from inductive_recommendation_tpu.graph import build_feat_matrix
    from inductive_recommendation_tpu.graph.build import sym_normalized_adjacency
    from inductive_recommendation_tpu.parallel.step import _ensure_key
    from inductive_recommendation_tpu_torch.models import flatten_params

    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=4)
    cfg = {"name": "AttIGCN", "embedding_size": D, "n_layers": N_LAYERS, "dropout": 0.0, "n_heads": N_HEADS}
    jm = jax_get_model(cfg, ds)
    init = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(3)))
    smp = build_sampler_state(ds.train_data, ds.n_items)
    aux = AuxiliaryDataset(ds, jm.user_map, jm.item_map)
    aux_smp = build_sampler_state(aux.train_data, aux.n_items)
    batches = []
    for i in range(1, ALPHA_STEPS + 1):
        r_s, r_a, _ = jax.random.split(_ensure_key(np.int64(i), 0), 3)
        u, p, n = sample_bpr_batch(smp, r_s, BATCH)
        au, ap, an = sample_bpr_batch(aux_smp, r_a, BATCH)
        batches.append([np.asarray(a, np.int64) for a in (u, p, n[:, 0], au, ap, an[:, 0])])
    feat = build_feat_matrix(ds.train_array, ds.n_users, ds.n_items, jm.user_map, jm.item_map)
    return ds, jm, init, {
        "adj": sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items), "feat": feat,
        "init": {k: np.array(v, np.float32) for k, v in flatten_params(init).items()}, "batches": batches,
        "feat_n_cols": jm.feat_n_cols, "user_dim": jm.user_dim,
    }


@pytest.fixture(scope="module")
def model_inputs():
    return _model_inputs()


# -- the rank side (no JAX) -------------------------------------------------------


def attention_ranks(inputs, step_inputs):
    import torch
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch.parallel import build_edge_sharded_spmm, make_mesh
    from inductive_recommendation_tpu_torch.parallel.attention import edge_sharded_attention, sharded_attention
    from inductive_recommendation_tpu_torch.parallel.collectives import all_gather, counts, reset_collective_counts, shared
    from inductive_recommendation_tpu_torch.parallel.mesh import gather_rows, local_rows
    from inductive_recommendation_tpu_torch.parallel.spmm import values_shard

    S, s = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(1, S)
    group = mesh.get_group("model")
    out = {}

    # the aggregation and its gradients
    mat = values_shard(build_edge_sharded_spmm(*inputs["coo"], inputs["shape"], S, s))
    t = {k: torch.as_tensor(inputs[k]) for k in ("q", "wk", "bk", "v", "w")}
    q = local_rows(t["q"], mesh, n_rows=mat.n_rows_pad).requires_grad_(True)
    v = local_rows(t["v"], mesh, n_rows=mat.n_cols_pad).requires_grad_(True)
    wk, bk = t["wk"].clone().requires_grad_(True), t["bk"].clone().requires_grad_(True)
    h, dh, dv = q.shape[1], q.shape[2], v.shape[1]
    reset_collective_counts()
    wk_s, bk_s = shared([wk, bk], group)
    qk = torch.einsum("nhd,vhd->nhv", q, wk_s.reshape(dv, h, dh))
    qb = torch.einsum("nhd,hd->nh", q, bk_s.reshape(h, dh))
    agg = edge_sharded_attention(mat, qk, qb, v, TEMPERATURE, group)
    out["collectives"] = dict(counts.by_kind)
    reset_collective_counts()
    (agg * local_rows(t["w"], mesh, n_rows=mat.n_rows_pad)).sum().backward()
    out["backward_collectives"] = dict(counts.by_kind)
    out.update(out=agg.detach().numpy(), dq=q.grad.numpy(), dv=v.grad.numpy(), dwk=wk.grad.numpy(),
               dbk=bk.grad.numpy())
    with torch.no_grad():
        qk_all, qb_all = all_gather(qk.contiguous(), group), all_gather(qb.contiguous(), group)
        out["attn"] = sharded_attention(mat, qk_all, qb_all, v, TEMPERATURE, group).numpy()
        out["eid"] = mat.fwd.eid.numpy()

    # the AttIGCN step: IGCNTrainer in edge mode
    from inductive_recommendation_tpu_torch import get_model, get_trainer
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset

    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=4)
    cfg = {"name": "AttIGCN", "embedding_size": D, "n_layers": N_LAYERS, "dropout": 0.0, "n_heads": N_HEADS}
    tcfg = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": LR, "l2_reg": L2, "aux_reg": AUX, "batch_size": BATCH,
            "test_batch_size": BATCH, "topks": [20], "n_epochs": 1}
    trainer = get_trainer(tcfg, ds, get_model(cfg, ds, device="cpu"), mesh=mesh, mesh_mode="edge")
    assert trainer.model.feat_n_cols == step_inputs["feat_n_cols"] and trainer.model.temperature == math.sqrt(D) * 10.0
    init = {k: torch.as_tensor(a) for k, a in step_inputs["init"].items()}
    init["embedding"] = init["embedding"][: trainer.model.feat_n_cols]
    trainer._restore_params(init)
    out["losses"] = []
    for b in step_inputs["batches"]:
        out["losses"].append(float(trainer.step(*(torch.as_tensor(a) for a in b))))
        if "grads" not in out:  # the first step's, the table's gathered (Adam leaves them in .grad)
            out["grads"] = {k: (gather_rows(p.grad, mesh) if k == "embedding" else p.grad).numpy().copy()
                            for k, p in trainer.params.items()}
    out["table"] = gather_rows(trainer.params["embedding"], mesh).numpy()
    with trainer.model.placed(trainer.placement):
        out["rep"] = trainer.model.make_scoring_state(trainer.params).numpy()
    return out


@pytest.fixture(scope="module")
def runs(inputs, model_inputs):
    return {S: run_ranks(f"{__name__}:attention_ranks", S, inputs, model_inputs[3]) for S in WORLDS}


# -- JAX's side --------------------------------------------------------------------------


def _jax_attention(inputs, S):
    """JAX's sharded aggregation and its gradients in (q, wk, bk, v)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from inductive_recommendation_tpu.parallel import build_edge_sharded_spmm, make_mesh
    from inductive_recommendation_tpu.parallel.attention import build_attention_perm, make_edge_sharded_attention
    from inductive_recommendation_tpu.parallel.spmm import shard_operand

    q, v, w = inputs["q"], inputs["v"], inputs["w"]
    h, dh, dv = q.shape[1], q.shape[2], v.shape[1]
    mesh = make_mesh(n_data=8 // S, n_model=S)
    mat = build_edge_sharded_spmm(*inputs["coo"], inputs["shape"], S)
    perm = build_attention_perm(mat)
    fn = make_edge_sharded_attention(mat, mesh, temperature=TEMPERATURE)
    qp = np.zeros((mat.n_rows_pad, h, dh), np.float32)
    qp[: len(q)] = q
    wp = np.zeros((mat.n_rows_pad, dv), np.float32)
    wp[: len(w)] = w
    qs = jax.device_put(jnp.asarray(qp), NamedSharding(mesh, P("model", None, None)))

    def agg(q_, wk_, bk_, v_):
        qk = jnp.einsum("nhd,vhd->nhv", q_, wk_.reshape(dv, h, dh))
        qb = jnp.einsum("nhd,hd->nh", q_, bk_.reshape(h, dh))
        return fn(mat.fwd, perm, qk, qb, v_)

    args = (qs, jnp.asarray(inputs["wk"]), jnp.asarray(inputs["bk"]), shard_operand(v, mat, mesh))
    with mesh:
        out = np.asarray(jax.jit(agg)(*args))
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(agg(*a) * wp), argnums=(0, 1, 2, 3)))(*args)
    return out, [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def jax_attention(inputs):
    return {S: _jax_attention(inputs, S) for S in WORLDS}


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max(initial=0.0))))


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_attention_matches_jax(runs, jax_attention, inputs, S):
    ref_out, (dq, dwk, dbk, dv) = jax_attention[S]
    n_rows, n_cols = inputs["shape"]
    ranks = runs[S]
    _close(np.concatenate([r["out"] for r in ranks])[:n_rows], ref_out[:n_rows])
    _close(np.concatenate([r["dq"] for r in ranks])[:n_rows], dq[:n_rows])
    _close(np.concatenate([r["dv"] for r in ranks])[:n_cols], dv[:n_cols])
    for r in ranks:  # the replicated weights' gradients are whole on every rank
        _close(r["dwk"], dwk)
        _close(r["dbk"], dbk)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_attention_is_the_single_device_softmax(runs, inputs, S):
    """Every edge's attention, from its shard, equals the port's
    single-device ``fused_kv_attention`` on the whole matrix."""
    import torch

    from inductive_recommendation_tpu_torch.ops import build_csr_spmm
    from inductive_recommendation_tpu_torch.ops.attention_spmm import fused_kv_attention

    mat = build_csr_spmm(*inputs["coo"], inputs["shape"])
    want = fused_kv_attention(mat, torch.as_tensor(inputs["q"]), torch.as_tensor(inputs["wk"]),
                              torch.as_tensor(inputs["bk"]), torch.as_tensor(inputs["v"]), TEMPERATURE)
    by_eid = np.zeros(mat.nnz, np.float32)
    by_eid[mat.eid.numpy()] = want.numpy()
    got = np.zeros(mat.nnz, np.float32)
    for r in runs[S]:
        got[r["eid"]] = r["attn"]
    np.testing.assert_allclose(got, by_eid, rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_attention_collectives(runs, S):
    """One forward: the folded query's two all-gathers, the row maxima's MAX
    all-reduce, the row sums' all-reduce and the output's reduce-scatter."""
    want = {"all_gather": 2, "all_reduce_max": 1, "all_reduce": 1, "reduce_scatter": 1}
    assert all(r["collectives"] == want for r in runs[S])


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_attention_backward_collectives(runs, S):
    """Its backward: the output's cotangent all-gathered, one all-reduce of
    the softmax's row statistics c (the softmax's only collective), the
    folded query's two gradients reduce-scattered and one all-reduce of the
    shared key weights' gradients; no MAX."""
    want = {"all_gather": 1, "all_reduce_max": 0, "all_reduce": 2, "reduce_scatter": 2}
    assert all(r["backward_collectives"] == want for r in runs[S])


def _jax_att_step(model_inputs, S, capture=False):
    """JAX's AttIGCN step from the init: 3 Adam steps -> (losses, table);
    with ``capture``, the first step's gradients (flat names) instead."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset
    from inductive_recommendation_tpu.data.sampling import build_sampler_state
    from inductive_recommendation_tpu.parallel import make_mesh
    from inductive_recommendation_tpu.parallel.step import make_edge_sharded_att_igcn_step

    ds, jm, init, _ = model_inputs
    mesh = make_mesh(n_data=8 // S, n_model=S)
    if capture:
        zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
        optimizer = optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))
    else:
        optimizer = optax.adam(LR)
    aux = AuxiliaryDataset(ds, jm.user_map, jm.item_map)
    step = make_edge_sharded_att_igcn_step(
        jm, mesh, optimizer, build_sampler_state(ds.train_data, ds.n_items),
        build_sampler_state(aux.train_data, aux.n_items), BATCH, L2, AUX,
    )
    rows = -(-jm.feat_n_cols // S) * S
    emb = np.zeros((rows, D), np.float32)
    emb[: jm.feat_n_cols] = init["embedding"][: jm.feat_n_cols]
    params = jax.tree_util.tree_map(jnp.asarray, dict(init))
    params["embedding"] = jax.device_put(emb, NamedSharding(mesh, P("model", None)))
    opt_state = optimizer.init(params)
    losses = []
    with mesh:
        for i in range(1, 2 if capture else ALPHA_STEPS + 1):
            params, opt_state, loss = step(params, opt_state, np.int64(i))
            losses.append(float(loss))
    if capture:
        from inductive_recommendation_tpu_torch.models import flatten_params

        return {k: np.asarray(v) for k, v in flatten_params(jax.tree_util.tree_map(np.asarray, opt_state)).items()}
    return losses, np.asarray(params["embedding"])


@pytest.mark.parametrize("S", WORLDS)
def test_att_igcn_step_matches_jax(runs, model_inputs, S):
    losses, table = _jax_att_step(model_inputs, S)
    for r in runs[S]:
        _close(r["losses"], losses)
        m = min(len(table), len(r["table"]))
        _close(r["table"][:m], table[:m], TABLE_TOL)
        np.testing.assert_array_equal(r["rep"], runs[S][0]["rep"])  # the gathered rep is the same on every rank
    assert np.isfinite(losses).all() and runs[S][0]["rep"].shape == (N_USERS + N_ITEMS, D)


@pytest.fixture(scope="module")
def jax_att_grads(model_inputs):
    return _jax_att_step(model_inputs, 4, capture=True)


@pytest.mark.parametrize("S", WORLDS)
def test_att_igcn_step_gradients_match_jax(runs, jax_att_grads, S):
    """The first step's gradients of every parameter (the table's real rows)
    within 1e-5 of the parameter's largest, against JAX's at S = 4 (its
    step is one program over the global batch whatever S). The key bias
    adds one score to every edge of a row, which the softmax does not see:
    its gradient is 0 in exact arithmetic, fp32 noise on both sides, held
    below 1e-6 of the largest gradient instead."""
    top = max(float(np.abs(v).max()) for v in jax_att_grads.values())
    for r in runs[S]:
        assert sorted(r["grads"]) == sorted(jax_att_grads)
        for name, want in jax_att_grads.items():
            got = r["grads"][name]
            m = min(len(want), len(got))
            if name == "weight_k.b":
                assert max(np.abs(want).max(), np.abs(got).max()) <= 1e-6 * top
                continue
            np.testing.assert_allclose(got[:m], want[:m], rtol=0, atol=TOL * float(np.abs(want).max()), err_msg=name)
