"""The port's sharded training steps (``parallel/step.py``) against the JAX
package's: edge mode, ``BPRTrainer`` on LightGCN and ``IGCNTrainer`` on IGCN
under the edge placement (``get_trainer(..., mesh_mode="edge")``: the
trainer's own objective over the model's own forward), at S = 2 and 4 and
on the hybrid (2, 2) mesh against ``make_edge_sharded_bpr_step`` /
``make_edge_sharded_igcn_step`` under ``shard_map`` (conftest's 8 virtual
CPU devices), and data mode on (2, 2) (``get_trainer(..., mesh=)``) against
the port's single-device trainer.

JAX draws its batches inside its steps; they are drawn here the same way
(the step counter folded into the base seed, ``sample_bpr_batch`` on the
same sampler) and handed to the port's steps, as
``benchmarks/golden_parity_flagships.py::make_batches`` hands batches to
both sides. Dropout is 0 against JAX (its per-shard masks are its own);
data mode runs IGCN at dropout 0.3, whose masks, keyed by the global edge
id, are the single-device ones. Loss and parameters after 3 Adam steps
agree within 1e-5 * max(1, max |ref|) (fp32 sums in another order). The
IGCN runs anneal alpha before the third step (the model's
``feat_mat_anneal``, alpha 0.99). Both sides build their graphs from the
same synthetic set, each with its own package's builders, and start from
the same weights.
"""

import numpy as np
import pytest

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

D, N_LAYERS, BATCH, LR, L2, AUX = 8, 2, 64, 1e-3, 1e-4, 0.01
N_USERS, N_ITEMS, N_INTER = 60, 50, 700
ALPHAS = (1.0, 1.0, 0.99)
TOL = 1e-5
EDGE_CASES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}


def _graph():
    """(COO of the normalized adjacency, COO and row sums of IGCN's feature
    matrix) with every node a core node, from the JAX package's builders."""
    from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
    from inductive_recommendation_tpu.graph import build_feat_matrix
    from inductive_recommendation_tpu.graph.build import sym_normalized_adjacency

    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=4)
    adj = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
    feat = build_feat_matrix(ds.train_array, ds.n_users, ds.n_items, np.arange(ds.n_users), np.arange(ds.n_items))
    return ds, adj, feat


def _jax_batches(ds, family, n_steps, base_seed=0):
    """The batches JAX's edge steps draw at step counters 1..n_steps."""
    import jax

    from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset
    from inductive_recommendation_tpu.data.sampling import build_sampler_state, sample_bpr_batch
    from inductive_recommendation_tpu.parallel.step import _ensure_key

    smp = build_sampler_state(ds.train_data, ds.n_items)
    aux = AuxiliaryDataset(ds, np.arange(ds.n_users), np.arange(ds.n_items))
    aux_smp = build_sampler_state(aux.train_data, aux.n_items)
    out = []
    for i in range(1, n_steps + 1):
        key = _ensure_key(np.int64(i), base_seed)
        if family == "bpr":
            rng_s, _ = jax.random.split(key)
            u, p, n = sample_bpr_batch(smp, rng_s, BATCH)
            out.append(tuple(np.asarray(a, np.int64) for a in (u, p, n[:, 0])))
        else:
            rng_s, rng_a, _ = jax.random.split(key, 3)
            u, p, n = sample_bpr_batch(smp, rng_s, BATCH)
            au, ap, an = sample_bpr_batch(aux_smp, rng_a, BATCH)
            out.append(tuple(np.asarray(a, np.int64) for a in (u, p, n[:, 0], au, ap, an[:, 0])))
    return out


def _init(n_rows, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 0.1, (n_rows, D)).astype(np.float32), rng.uniform(0.5, 1.5, D).astype(np.float32)


def _n_pad(n, S):
    return -(-n // S) * S


# -- the rank side (no JAX) -------------------------------------------------------


def _trainer(family, ds, mesh, mesh_mode, dropout):
    from inductive_recommendation_tpu_torch import get_model, get_trainer

    name, trainer = ("LightGCN", "BPRTrainer") if family == "bpr" else ("IGCN", "IGCNTrainer")
    cfg = {"name": name, "embedding_size": D, "n_layers": N_LAYERS, "dropout": dropout, "feature_ratio": 1.0}
    tcfg = {"name": trainer, "optimizer": "Adam", "lr": LR, "l2_reg": L2, "aux_reg": AUX, "batch_size": BATCH,
            "test_batch_size": BATCH, "topks": [20], "n_epochs": 1, "seed": 7}
    # each trainer re-initialises the model's weights from its seed
    return get_trainer(tcfg, ds, get_model(cfg, ds, device="cpu"), mesh=mesh, mesh_mode=mesh_mode)


def steps_ranks(inputs):
    import torch
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset
    from inductive_recommendation_tpu_torch.parallel import make_mesh
    from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, gather_rows

    world = dist.get_world_size()
    n = N_USERS + N_ITEMS
    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=4)
    out = {}

    def tensors(batch):
        return [torch.as_tensor(a) for a in batch]

    for shape in EDGE_CASES[world]:
        mesh = make_mesh(*shape)
        S = axis_size(mesh, "model")
        for family in ("bpr", "igcn"):
            t = _trainer(family, ds, mesh, "edge", 0.0)
            emb, w = inputs["init"][(family, S)]
            init = {"embedding": torch.as_tensor(emb[: n + (2 if family == "igcn" else 0)])}
            if family == "igcn":
                init["w"] = torch.as_tensor(w)
            t._restore_params(init)
            losses = []
            for i, b in enumerate(inputs["batches"][family]):
                if family == "igcn" and ALPHAS[i] != t.model.alpha:
                    t.model.feat_mat_anneal()
                    assert t.model.alpha == ALPHAS[i]
                losses.append(float(t.step(*tensors(b))))
            table = gather_rows(t.params["embedding"], mesh).numpy()
            out[("edge", shape, family)] = (losses, table, t.params.get("w", torch.zeros(0)).detach().numpy())

    if world == 4:  # data mode on (2, 2) against the single-device trainer of the same batches and masks
        mesh = make_mesh(2, 2)
        for family in ("bpr", "igcn"):
            runs = {}
            for mode, mesh_arg in (("single", None), ("data", mesh)):
                t = _trainer(family, ds, mesh_arg, "data", 0.3)
                losses = [float(t.step(*tensors(b))) for b in inputs["batches"][family]]
                runs[mode] = (losses, t._model_params()["embedding"].detach().numpy())
            out[("data", family)] = runs
    return out


# -- the test side ------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    ds, adj, feat = _graph()
    n = ds.n_users + ds.n_items
    batches = {"bpr": _jax_batches(ds, "bpr", 3), "igcn": _jax_batches(ds, "igcn", 3)}
    init = {}
    for S in (1, 2, 4):
        init[("bpr", S)] = _init(_n_pad(n, S), seed=S)
        init[("igcn", S)] = _init(_n_pad(n + 2, S), seed=10 + S)
    for key, (emb, w) in init.items():  # pad rows start at 0, as the trainers pad them
        emb[n + (2 if key[0] == "igcn" else 0) :] = 0.0
    return ds, {"adj": adj, "feat": feat, "batches": batches, "init": init}


@pytest.fixture(scope="module")
def runs(setup):
    _, inputs = setup
    out = {}
    for world in EDGE_CASES:
        for r in run_ranks(f"{__name__}:steps_ranks", world, inputs):
            out.setdefault(world, []).append(r)
    return out


def _jax_run(setup, family, S):
    """JAX's edge step, 3 steps from the same init: (losses, table, w)."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset
    from inductive_recommendation_tpu.data.sampling import build_sampler_state
    from inductive_recommendation_tpu.parallel import make_mesh
    from inductive_recommendation_tpu.parallel.spmm import build_edge_sharded_spmm
    from inductive_recommendation_tpu.parallel.step import make_edge_sharded_bpr_step, make_edge_sharded_igcn_step

    ds, inputs = setup
    n = ds.n_users + ds.n_items
    mesh = make_mesh(n_data=8 // S, n_model=S)
    rows = NamedSharding(mesh, P("model", None))
    optimizer = optax.adam(LR)
    smp = build_sampler_state(ds.train_data, ds.n_items)
    adj = build_edge_sharded_spmm(*inputs["adj"], (n, n), S)
    emb, w = inputs["init"][(family, S)]
    if family == "bpr":
        params = {"embedding": jax.device_put(emb, rows)}
        step = make_edge_sharded_bpr_step(adj, mesh, optimizer, smp, BATCH, L2, ds.n_users, N_LAYERS)
        run = lambda p, o, i, a: step(p, o, np.int64(i))  # noqa: E731
    else:
        fr, fc, fv, row_sum = inputs["feat"]
        feat = build_edge_sharded_spmm(fr, fc, fv, (n, n + 2), S)
        aux = AuxiliaryDataset(ds, np.arange(ds.n_users), np.arange(ds.n_items))
        params = {"embedding": jax.device_put(emb, rows), "w": jax.numpy.asarray(w)}
        step = make_edge_sharded_igcn_step(
            feat, adj, fr, row_sum, mesh, optimizer, smp, build_sampler_state(aux.train_data, aux.n_items), BATCH, L2,
            AUX, ds.n_users, ds.n_users, N_LAYERS, 0.0,
        )
        run = lambda p, o, i, a: step(p, o, np.int64(i), alpha=a)  # noqa: E731
    opt_state = optimizer.init(params)
    losses = []
    with mesh:
        for i, a in enumerate(ALPHAS, start=1):
            params, opt_state, loss = run(params, opt_state, i, a)
            losses.append(float(loss))
    return losses, np.asarray(params["embedding"]), np.asarray(params.get("w", np.zeros(0)))


@pytest.fixture(scope="module")
def jax_runs(setup):
    return {(family, S): _jax_run(setup, family, S) for family in ("bpr", "igcn") for S in (2, 4)}


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(1.0, float(np.abs(ref).max(initial=0.0))))


CASES = [(world, shape, family) for world, shapes in EDGE_CASES.items() for shape in shapes for family in ("bpr", "igcn")]


@pytest.mark.parametrize("world,shape,family", CASES)
def test_edge_step_matches_jax(runs, jax_runs, world, shape, family):
    losses, table, w = jax_runs[(family, shape[1])]
    for r in runs[world]:
        got_losses, got_table, got_w = r[("edge", shape, family)]
        _close(got_losses, losses)
        _close(got_table, table)
        if family == "igcn":
            _close(got_w, w)
    assert np.isfinite(losses).all() and len(losses) == len(ALPHAS)


@pytest.mark.parametrize("family", ["bpr", "igcn"])
def test_data_mode_matches_single_device(runs, family):
    """Data mode on (2, 2) through the trainers: each rank a quarter of the
    batch, the tables row-sharded over 'model'; both families under
    dropout 0.3."""
    for r in runs[4]:
        single, data = r[("data", family)]["single"], r[("data", family)]["data"]
        _close(data[0], single[0])
        _close(data[1], single[1])


def test_steps_check_the_batch(setup):
    """A batch that does not split over the mesh is refused."""
    from inductive_recommendation_tpu_torch.parallel.step import _slice

    with pytest.raises(ValueError, match="must divide over 3"):
        _slice(BATCH, 3, 0, "ranks")
    assert _slice(BATCH, 4, 2, "ranks") == slice(32, 48)
