"""Edge mode of the other families against the JAX package's
``make_edge_sharded_*_step`` under ``shard_map`` (conftest's 8 virtual CPU
devices): each model's own forward and its named trainer's own objective
under the edge placement (``get_trainer(..., mesh_mode="edge")``), for the
DOSE step's four contrastive modes (DOSE_aug and DOSE_aug2 ``single``,
DOSE_aug_drop ``double_same``, TEST2 ``cross``, DOSE_test ``mean``), SGL
(``cross``) and HALF (``single``), NGCF, IMCGAE and IDCF_LGCN, at S = 1, 2, 4
and on the hybrid (2, 2) mesh for DOSE_aug and SGL.

JAX draws its batches (and IDCF's samples) inside its steps; they are drawn
here the same way and handed to the port's trainers (IDCF's samples through
its model's ``draw_samples``). Both sides get the same views: the port's
view CSRs are built by its ``ViewEngine`` from the pairs and keep masks
JAX's ``make_view`` gets, and become the model's views, which the placement
shards on the rank's device; DOSE_aug2's augmented feature matrix likewise
(``build_aug_feat_csr`` against JAX's ``prepare_aug_feat``). Both sides
start from JAX's init weights. Dropout is 0 (JAX's per-shard masks are its
own).
Losses after 3 Adam steps agree within 1e-5 * max(1, max |ref|). Tables
agree within 1e-4: Adam's step does not shrink with the gradient, so an
entry whose gradient is at fp32 noise moves by up to lr (1e-3) in a
direction the order of the sums decides. The DOSE runs anneal alpha before
the third step (the model's ``feat_mat_anneal``).

The families whose replicated weights get their gradient through the
port's ``collectives.shared`` backward (NGCF's per-layer linears,
IMCGAE's shared rows, IDCF_LGCN's heads) are also held to JAX's gradients
of the first step, every parameter's: a factor of S there would hardly
move an Adam step. JAX's gradients are read from an optax transformation
that keeps them as its state and leaves the parameters as they are.

JAX's step is one program over the global batch whatever its mesh, so its
result does not depend on S beyond the order of fp32 sums: each family's
port runs at S = 1, 2, 4 (and (2, 2)) are held to JAX's run at S = 4 (mesh
(2, 4)), and for DOSE_aug and SGL also to JAX's at S = 1 and 2 (meshes
(8, 1) and (4, 2)), with the hybrid (2, 2) held to JAX's S = 2.
"""

import numpy as np
import pytest

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

D, N_LAYERS, BATCH, LR, L2, AUX, CREG = 16, 2, 64, 1e-3, 1e-4, 0.01, 0.05
N_USERS, N_ITEMS, N_INTER = 50, 40, 600
N_HEADS, N_SAMPLES = 2, 8
ALPHAS = (1.0, 1.0, 0.99)
TOL = 1e-5
TABLE_TOL = 1e-4
WORLDS = {1: [(1, 1)], 2: [(1, 2)], 4: [(1, 4), (2, 2)]}
HYBRID = ("DOSE_aug", "SGL")
# families whose first step's gradients are held to JAX's
GRAD_FAMILIES = ("NGCF", "IMCGAE", "IDCF_LGCN")

# family -> (model config, step kind, contrastive mode); the trainer each runs under
TRAINER_OF = {"DOSE_aug": "DOSEaugTrainer", "DOSE_aug2": "DOSEaugTrainer", "DOSE_aug_drop": "DOSEdropTrainer",
              "TEST2": "DOSEtestTrainer", "DOSE_test": "DOSEtestTrainer", "SGL": "SGLTrainer", "HALF": "HALFTrainer",
              "NGCF": "BPRTrainer", "IMCGAE": "BPRTrainer", "IDCF_LGCN": "IDCFTrainer"}
FAMILIES = {
    "DOSE_aug": ({"name": "DOSE_aug", "aug_num": 30}, "dose", "single"),
    "DOSE_aug2": ({"name": "DOSE_aug2", "aug_num": 30}, "dose", "single"),
    "DOSE_aug_drop": ({"name": "DOSE_aug_drop", "aug_num": 30, "aug_rate": 0.7}, "dose", "double_same"),
    "TEST2": ({"name": "TEST2", "aug_rate": 0.7}, "dose", "cross"),
    "DOSE_test": ({"name": "DOSE_test", "aug_num": 30}, "dose", "mean"),
    "SGL": ({"name": "SGL", "aug_rate": 0.7}, "sgl", "cross"),
    "HALF": ({"name": "HALF", "aug_rate": 0.7}, "sgl", "single"),
    "NGCF": ({"name": "NGCF", "layer_sizes": [D, D]}, "ngcf", None),
    "IMCGAE": ({"name": "IMCGAE"}, "imcgae", None),
    "IDCF_LGCN": ({"name": "IDCF_LGCN", "n_headers": N_HEADS, "n_samples": N_SAMPLES}, "idcf", None),
}
BASE = {"embedding_size": D, "n_layers": N_LAYERS, "dropout": 0.0, "feature_ratio": 1.0}
# the keys each step splits its counter into, and whether it draws an aux batch
SPLITS = {("dose", "single"): 4, ("dose", "mean"): 4, ("dose", "double_same"): 5, ("dose", "cross"): 5}


def _n_pad(n, S):
    return -(-n // S) * S


# -- the test side: inputs and JAX's runs --------------------------------------------


def _dataset():
    from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset

    return quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=4)


def _jax_model(family, ds):
    from inductive_recommendation_tpu import get_model as jax_get_model

    cfg, _, _ = FAMILIES[family]
    cfg = dict(BASE, **cfg)
    if family == "IDCF_LGCN":
        cfg["pretrained_embedding"] = np.random.default_rng(5).normal(0, 0.1, (N_USERS + N_ITEMS, D)).astype(np.float32)
    return jax_get_model(cfg, ds)


def _batches(ds, family, cache):
    """The batches (and IDCF's samples) JAX's step draws at counters 1..3;
    the steps that split their counter alike draw the same batches (kept in
    ``cache`` by split count)."""
    import jax

    from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset
    from inductive_recommendation_tpu.data.sampling import build_sampler_state, sample_bpr_batch
    from inductive_recommendation_tpu.parallel.step import _ensure_key

    _, kind, mode = FAMILIES[family]
    n_split = SPLITS.get((kind, mode), 2)
    if n_split not in cache:
        smp = build_sampler_state(ds.train_data, ds.n_items)
        aux = AuxiliaryDataset(ds, np.arange(ds.n_users), np.arange(ds.n_items))
        aux_smp = build_sampler_state(aux.train_data, aux.n_items)
        sample = jax.jit(sample_bpr_batch, static_argnums=2)
        drawn = []
        for i in range(1, len(ALPHAS) + 1):
            keys = jax.random.split(_ensure_key(np.int64(i), 0), n_split)
            main = [np.asarray(a, np.int64) for a in sample(smp, keys[0], BATCH)]
            aux_b = [np.asarray(a, np.int64) for a in sample(aux_smp, keys[1], BATCH)]
            drawn.append((keys[1], main[:2] + [main[2][:, 0]], aux_b[:2] + [aux_b[2][:, 0]]))
        cache[n_split] = drawn
    out = []
    for key, main, aux_b in cache[n_split]:
        batch = list(main) + (list(aux_b) if kind == "dose" else [])
        if kind == "idcf":  # representations(): rng, r_u, r_i = split(rng, 3) per head
            rng, heads = key, []
            for _ in range(N_HEADS):
                rng, r_u, r_i = jax.random.split(rng, 3)
                heads.append([np.asarray(jax.random.randint(r, (N_SAMPLES,), 0, hi), np.int64)
                              for r, hi in ((r_u, ds.n_users), (r_i, ds.n_items))])
            batch.append(np.asarray(heads))
        out.append(batch)
    return out


def _view_inputs(family, jm):
    """(JAX EdgeViews, the port's view COOs, DOSE_aug2's aug pairs): the
    same pairs and keep masks on both sides."""
    import torch

    from inductive_recommendation_tpu_torch.graph.views import ViewEngine

    _, kind, mode = FAMILIES[family]
    rng = np.random.default_rng(11)
    eng = jm.view_engine
    port_eng = ViewEngine(jm.dataset.train_array, N_USERS, N_ITEMS, delta_budget=eng.delta_budget)
    n_pairs = len(eng.train_pairs)
    if mode == "cross" or kind == "sgl":
        masks = [rng.permutation(n_pairs) < int(0.7 * n_pairs) for _ in range(2 if mode == "cross" else 1)]
        specs = [{"keep_pair_mask": m} for m in masks]
    else:
        pairs = np.stack([rng.integers(0, N_USERS, 30), rng.integers(0, N_ITEMS, 30)], axis=1)
        specs = [{"add_pairs": pairs}]
    jax_views = [eng.make_view(**s) for s in specs]
    coos = []
    for s in specs:
        v = port_eng.make_view_on_device(**{k: torch.as_tensor(a) for k, a in s.items()})
        coos.append(tuple(t.numpy() for t in (v.edge_rows().long(), v.col.long(), v.val, v.eid.long())))
    return jax_views, coos, specs[0].get("add_pairs")


def _aug_feat_coo(jm, pairs):
    import torch

    from inductive_recommendation_tpu_torch.graph.views import ViewEngine, aug_feat_base, build_aug_feat_csr

    port_eng = ViewEngine(jm.dataset.train_array, N_USERS, N_ITEMS)
    um, im = np.arange(N_USERS), np.arange(N_ITEMS)
    base = aug_feat_base(port_eng.train_pairs, N_USERS, N_ITEMS, um, im, "cpu")
    mat, _ = build_aug_feat_csr(base, port_eng.train_keys, torch.as_tensor(pairs), 1.0, n_users=N_USERS,
                                n_items=N_ITEMS, user_dim=N_USERS, n_cols=jm.feat_n_cols)
    return tuple(t.numpy() for t in (mat.edge_rows().long(), mat.col.long(), mat.val, mat.eid.long()))


def _init(family, jm):
    """JAX's init params as numpy leaves (nested), the table's pad rows 0."""
    import jax

    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(3)))
    return {k: (np.array(v, np.float32) if not isinstance(v, (dict, list)) else v) for k, v in params.items()}


@pytest.fixture(scope="module")
def setup():
    from inductive_recommendation_tpu.graph import bipartite_edges, build_feat_matrix
    from inductive_recommendation_tpu.graph.build import sym_normalized_adjacency
    from inductive_recommendation_tpu.models.ngcf import selfloop_l1_coo
    from inductive_recommendation_tpu_torch.models import flatten_params

    ds = _dataset()
    row, col = bipartite_edges(ds.train_array, ds.n_users, ds.n_items)
    inputs = {
        "adj": sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items),
        "feat": build_feat_matrix(ds.train_array, ds.n_users, ds.n_items, np.arange(ds.n_users), np.arange(ds.n_items)),
        "selfloop": selfloop_l1_coo(ds)[:3],
        "idcf_feat": (row, col, np.ones(len(row), np.float32)),
        "families": {},
    }
    models, drawn = {}, {}
    for family, (_, kind, _) in FAMILIES.items():
        jm = _jax_model(family, ds)
        init = _init(family, jm)
        fam = {"init": flatten_params(init), "batches": _batches(ds, family, drawn)}
        if kind in ("dose", "sgl"):
            jviews, fam["views"], pairs = _view_inputs(family, jm)
            models[family] = (jm, init, jviews, pairs)
            if family == "DOSE_aug2":
                fam["aug_feat"] = _aug_feat_coo(jm, pairs)
        else:
            models[family] = (jm, init, None, None)
        if kind == "idcf":
            fam["frozen"] = np.asarray(jm.buffers["frozen_embedding"])
        inputs["families"][family] = fam
    return ds, inputs, models


# -- the rank side (no JAX) -----------------------------------------------------------


def _csr(coo, shape, **flags):
    import torch

    from inductive_recommendation_tpu_torch.ops.csr_spmm import csr_on_device

    rows, cols, vals, eid = (torch.as_tensor(a) for a in coo)
    return csr_on_device(rows, cols, vals, shape, eid=eid, **flags)


def family_ranks(inputs):
    import torch
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch import get_model, get_trainer
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset
    from inductive_recommendation_tpu_torch.parallel import make_mesh
    from inductive_recommendation_tpu_torch.parallel.mesh import gather_rows

    n = N_USERS + N_ITEMS
    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=4)
    out = {}
    for shape in WORLDS[dist.get_world_size()]:
        mesh = make_mesh(*shape)
        for family, (cfg, kind, mode) in FAMILIES.items():
            if shape == (2, 2) and family not in HYBRID:
                continue
            fam = inputs["families"][family]
            cfg = dict(BASE, **cfg)
            if kind == "idcf":
                cfg["pretrained_embedding"] = fam["frozen"]
            tcfg = {"name": TRAINER_OF[family], "optimizer": "Adam", "lr": LR, "l2_reg": L2, "aux_reg": AUX,
                    "contrastive_reg": CREG, "batch_size": BATCH, "test_batch_size": BATCH, "topks": [20],
                    "n_epochs": 1}
            trainer = get_trainer(tcfg, ds, get_model(cfg, ds, device="cpu"), mesh=mesh, mesh_mode="edge")
            model = trainer.model
            init = {k: torch.as_tensor(v) for k, v in fam["init"].items()}
            if "embedding" in init:  # the table's rows past the model's are never read
                init["embedding"] = init["embedding"][: model.embedding.shape[0]]
            trainer._restore_params(init)
            if kind in ("dose", "sgl"):  # JAX's views; a key with no view of its own reads the first
                views = [_csr(c, (n, n), symmetric=True, route="view") for c in fam["views"]]
                model.views = {k: views[i] if i < len(views) else views[0] for i, k in enumerate(model.view_keys)}
            if "aug_feat" in fam:  # with its transpose, as the model builds it
                rows, cols, vals, eid = fam["aug_feat"]
                transpose = _csr((cols, rows, vals, eid), (n + 2, n), transposed=True, route="aug_feat")
                model.aug_feat = _csr(fam["aug_feat"], (n, n + 2), transpose=transpose, route="aug_feat")
            batches = [[torch.as_tensor(a) for a in b] for b in fam["batches"]]
            if kind == "idcf":
                samples = iter([b[3] for b in batches])
                model.draw_samples = lambda generator=None, samples=samples: next(samples)
            got = {"losses": []}
            for i, b in enumerate(batches):
                if kind == "dose" and ALPHAS[i] != model.alpha:
                    model.feat_mat_anneal()
                    assert model.alpha == ALPHAS[i]
                got["losses"].append(float(trainer.step(*b[:6 if kind == "dose" else 3])))
                if i == 0:  # the first step's, the table's gathered (Adam leaves them in .grad)
                    got["grads"] = {k: (gather_rows(p.grad, mesh) if k == "embedding" else p.grad).numpy().copy()
                                    for k, p in trainer.params.items()}
            if "embedding" in trainer.params:
                got["table"] = gather_rows(trainer.params["embedding"].detach(), mesh).numpy()
            else:
                got["table"] = trainer.params["w_out.w"].detach().numpy()
            out[(shape, family)] = got
    return out


@pytest.fixture(scope="module")
def runs(setup):
    _, inputs, _ = setup
    return {world: run_ranks(f"{__name__}:family_ranks", world, inputs) for world in WORLDS}


# -- JAX's steps --------------------------------------------------------------------------


def _grad_capture():
    """An optax transformation that leaves the parameters as they are and
    keeps the step's gradients as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


def _jax_run(setup, family, S, capture=False):
    """JAX's step from the init: 3 Adam steps -> (losses, table); with
    ``capture``, the first step's gradients (flat names) instead."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset
    from inductive_recommendation_tpu.data.sampling import build_sampler_state
    from inductive_recommendation_tpu.parallel import make_mesh
    from inductive_recommendation_tpu.parallel import step as js

    ds, inputs, models = setup
    jm, init, jviews, pairs = models[family]
    _, kind, mode = FAMILIES[family]
    n = N_USERS + N_ITEMS
    mesh = make_mesh(n_data=8 // S, n_model=S)
    rows = NamedSharding(mesh, P("model", None))
    optimizer = _grad_capture() if capture else optax.adam(LR)
    smp = build_sampler_state(ds.train_data, ds.n_items)

    def table(emb, n_rows):
        out = np.zeros((_n_pad(n_rows, S), emb.shape[1]), np.float32)
        out[: min(len(emb), n_rows)] = emb[:n_rows]
        return jax.device_put(out, rows)

    if kind == "dose":
        aux = AuxiliaryDataset(ds, np.arange(ds.n_users), np.arange(ds.n_items))
        run, prep, _ = js.make_edge_sharded_dose_step(
            jm, mesh, optimizer, smp, build_sampler_state(aux.train_data, aux.n_items), BATCH, L2, AUX, CREG,
            contrastive=mode, aug_feat=family == "DOSE_aug2",
        )
        states = tuple(prep(v) for v in jviews)
        vstate = states if mode == "cross" else states[0]
        aug = run.prepare_aug_feat(jnp.asarray(pairs), 1.0) if family == "DOSE_aug2" else None
        params = {"embedding": table(init["embedding"], n + 2), "w": jnp.asarray(init["w"])}
        call = lambda p, o, i, a: run(p, o, np.int64(i), vstate, alpha=a, aug_state=aug)  # noqa: E731
    elif kind == "sgl":
        run, prep = js.make_edge_sharded_sgl_step(jm, mesh, optimizer, smp, BATCH, L2, CREG, contrastive=mode)
        states = tuple(prep(v) for v in jviews)
        vstate = states if mode == "cross" else states[0]
        params = {"embedding": table(init["embedding"], n)}
        call = lambda p, o, i, a: run(p, o, np.int64(i), vstate)  # noqa: E731
    else:
        maker = {"ngcf": js.make_edge_sharded_ngcf_step, "imcgae": js.make_edge_sharded_imcgae_step}.get(kind)
        if kind == "idcf":
            run = js.make_edge_sharded_idcf_step(jm, mesh, optimizer, smp, BATCH, L2, CREG)
        else:
            run = maker(jm, mesh, optimizer, smp, BATCH, L2)
        params = jax.tree_util.tree_map(jnp.asarray, dict(init))
        if kind == "ngcf":
            params["embedding"] = table(init["embedding"], n)
        if kind == "imcgae":
            params = {"embedding": table(init["embedding"], n), "special": jnp.asarray(init["embedding"][n : n + 3])}
        call = lambda p, o, i, a: run(p, o, np.int64(i))  # noqa: E731
    opt_state = optimizer.init(params)
    losses = []
    with mesh:
        for i, a in enumerate(ALPHAS[: 1 if capture else None], start=1):
            params, opt_state, loss = call(params, opt_state, i, a)
            losses.append(float(loss))
    if capture:
        from inductive_recommendation_tpu_torch.models import flatten_params

        return {k: np.asarray(v) for k, v in flatten_params(jax.tree_util.tree_map(np.asarray, opt_state)).items()}
    tbl = params["embedding"] if "embedding" in params else params["w_out"]["w"]
    return losses, np.asarray(tbl)


JAX_S = {family: (1, 2, 4) if family in HYBRID else (4,) for family in FAMILIES}


@pytest.fixture(scope="module")
def jax_runs(setup):
    return {(family, S): _jax_run(setup, family, S) for family in FAMILIES for S in JAX_S[family]}


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max(initial=0.0))))


CASES = [(world, shape, family) for world, shapes in WORLDS.items() for shape in shapes for family in FAMILIES
         if shape != (2, 2) or family in HYBRID]


@pytest.mark.parametrize("world,shape,family", CASES)
def test_edge_step_matches_jax(runs, jax_runs, world, shape, family):
    S = shape[1] if shape[1] in JAX_S[family] else 4
    losses, table = jax_runs[(family, S)]
    for r in runs[world]:
        got = r[(shape, family)]
        _close(got["losses"], losses)
        m = min(len(table), len(got["table"]))  # the real rows; the pad rows depend on S
        _close(got["table"][:m], table[:m], TABLE_TOL)
    assert np.isfinite(losses).all() and len(losses) == len(ALPHAS)


def test_view_shard_keeps_global_edge_ids(setup):
    """A view shard cut on the device from the whole view keeps its edge
    ids, its row window holds every edge of its column block, and its
    transpose has the same triples."""
    import torch

    from inductive_recommendation_tpu_torch.ops.csr_spmm import csr_on_device, spmm_csr_reference
    from inductive_recommendation_tpu_torch.parallel.spmm import shard_csr

    _, inputs, _ = setup
    rows, cols, vals, eid = (torch.as_tensor(a) for a in inputs["families"]["DOSE_aug"]["views"][0])
    n = N_USERS + N_ITEMS
    transpose = csr_on_device(cols, rows, vals, (n, n), eid=eid, transposed=True, route="view")
    whole = csr_on_device(rows, cols, vals, (n, n), eid=eid, transpose=transpose, route="view")
    x = torch.randn(n, 5, dtype=torch.float64)
    dense = torch.zeros(n, n, dtype=torch.float64).index_put_((rows, cols), vals.double(), accumulate=True)
    total, seen = torch.zeros(n, 5, dtype=torch.float64), []
    for r in range(3):
        sh = shard_csr(whole, 3, r, route="edge_shard_view")
        blk = sh.block
        xs = torch.zeros(blk, 5, dtype=torch.float64)
        part = x[r * blk : (r + 1) * blk]
        xs[: len(part)] = part
        f = sh.fwd
        out = spmm_csr_reference(f.row_ptr, f.col, f.val.double(), xs)
        total[sh.row_lo : sh.row_hi] += out
        t = f.T
        assert sorted(t.eid.tolist()) == sorted(f.eid.tolist()) and t.route == "edge_shard_view" and t.transposed
        seen += f.eid.tolist()
    assert sorted(seen) == sorted(eid.tolist())
    torch.testing.assert_close(total, dense @ x)


@pytest.fixture(scope="module")
def jax_grads(setup):
    return {family: _jax_run(setup, family, 4, capture=True) for family in GRAD_FAMILIES}


GRAD_CASES = [c for c in CASES if c[2] in GRAD_FAMILIES]


@pytest.mark.parametrize("world,shape,family", GRAD_CASES)
def test_edge_step_gradients_match_jax(runs, jax_grads, world, shape, family):
    """The first step's gradients of every parameter (the table's real rows)
    within 1e-5 of the parameter's largest. IDCF's key biases add one score
    to every sample of a row, which the softmax does not see: their
    gradient is 0 in exact arithmetic, fp32 noise on both sides, held
    below 1e-6 of the largest gradient instead."""
    ref = jax_grads[family]
    top = max(float(np.abs(v).max()) for v in ref.values())
    for r in runs[world]:
        got = r[(shape, family)]["grads"]
        assert sorted(got) == sorted(ref)
        for name, want in ref.items():
            m = min(len(want), len(got[name]))
            if name.endswith(".wk.b"):
                assert max(np.abs(want).max(), np.abs(got[name]).max()) <= 1e-6 * top, name
                continue
            np.testing.assert_allclose(got[name][:m], want[:m], rtol=0, atol=TOL * float(np.abs(want).max()),
                                       err_msg=name)
