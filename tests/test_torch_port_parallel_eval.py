"""The port's sharded retrieval and mesh evaluator (``ops/topk.py::sharded_topk``,
``parallel/eval.py``, ``Evaluator(mesh=)``) against the JAX package's
``sharded_topk`` / ``make_sharded_recommender`` under ``shard_map`` and its
mesh ``Evaluator`` on conftest's 8 virtual CPU devices, and against the
port's single-device evaluator and one ``torch.topk``.

The port runs in 1, 2 and 4 gloo ranks, one module-scoped launch a world
size (``parallel.launch.run_ranks``); the rank bodies import no JAX. Scores
are random floats, so no tie decides an id; the evaluator's top-k lists are
compared up to ties of the model's scores. Metrics agree within 1e-6.
"""

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch.parallel.launch import run_ranks

WORLDS = (1, 2, 4)
TOPKS = [5, 20]
BATCH = 32
CFG = {"name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}
K, ROWS, N_ITEMS, D = 7, 12, 61, 6
BANNED_ITEMS = np.arange(0, 150, 7)


def _cases():
    rng = np.random.default_rng(11)
    n_pad = -(-N_ITEMS // 4) * 4
    scores = rng.normal(size=(ROWS, 64)).astype(np.float32)
    users_rep = rng.normal(size=(ROWS, D)).astype(np.float32)
    items_rep = rng.normal(size=(n_pad, D)).astype(np.float32)
    exclude = rng.integers(0, N_ITEMS + 1, (ROWS, 9)).astype(np.int64)  # N_ITEMS: the pad sentinel
    banned = np.zeros(n_pad, dtype=bool)
    banned[N_ITEMS:] = True
    banned[rng.choice(N_ITEMS, 5, replace=False)] = True
    return {"scores": scores, "users_rep": users_rep, "items_rep": items_rep, "exclude": exclude, "banned": banned}


def _dataset():
    from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset

    return quick_synthetic_dataset(200, 150, 3000, seed=0)


# -- the rank side (no JAX) -------------------------------------------------------


def eval_ranks(cases, emb, w):
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch import get_model
    from inductive_recommendation_tpu_torch.eval import Evaluator
    from inductive_recommendation_tpu_torch.models import params_from_jax
    from inductive_recommendation_tpu_torch.ops.topk import sharded_topk
    from inductive_recommendation_tpu_torch.parallel import make_mesh, make_sharded_recommender, pad_items_to_mesh

    S, s = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh()
    group = mesh.get_group("model")
    out = {}
    scores = torch.as_tensor(cases["scores"])
    n_local = scores.shape[1] // S
    vals, idx = sharded_topk(scores[:, s * n_local : (s + 1) * n_local], K, group)
    out["topk"] = (vals.numpy(), idx.numpy())

    n_pad = pad_items_to_mesh(N_ITEMS, mesh)
    n_local = n_pad // S
    rec = make_sharded_recommender(mesh, N_ITEMS, K)(
        torch.as_tensor(cases["users_rep"]),
        torch.as_tensor(cases["items_rep"][s * n_local : (s + 1) * n_local]),
        torch.as_tensor(cases["exclude"]),
        torch.as_tensor(cases["banned"][s * n_local : (s + 1) * n_local]),
    )
    out["recommender"] = rec.numpy()

    ds = _dataset()
    model = get_model(CFG, ds, device="cpu")
    params = params_from_jax(model, {"embedding": emb, "w": w})
    mesh_ev = Evaluator(ds, TOPKS, test_batch_size=BATCH, device="cpu", mesh=mesh)
    one_ev = Evaluator(ds, TOPKS, test_batch_size=BATCH, device="cpu")
    for key, ev in (("mesh", mesh_ev), ("single", one_ev)):
        out[key] = {
            "val": ev.evaluate(model, params, "val")[1],
            "test": ev.evaluate(model, params, "test")[1],
            "test_banned": ev.evaluate(model, params, "test", banned_items=BANNED_ITEMS)[1],
            "rec_test": ev.recommend(model, params, "test"),
            "rec_val": ev.recommend(model, params, "val"),
            "rec_train": ev.recommend(model, params, "train"),
            "rec_banned": ev.recommend(model, params, "test", banned_items=BANNED_ITEMS),
        }
    with torch.no_grad():
        out["rep"] = model.get_rep(params).numpy()
    return out


# -- the test side ------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(5)
    ds = _dataset()
    n = ds.n_users + ds.n_items + 2  # IGCN's table: every node a core row, plus the two type tokens
    return rng.normal(0.0, 0.1, (n, 16)).astype(np.float32), rng.uniform(0.5, 1.5, 16).astype(np.float32)


@pytest.fixture(scope="module")
def runs(cases, weights):
    return {S: run_ranks(f"{__name__}:eval_ranks", S, cases, *weights) for S in WORLDS}


def _jax_mesh(S):
    from inductive_recommendation_tpu.parallel import make_mesh

    return make_mesh(n_data=8 // S, n_model=S)


def _assert_metrics_equal(got, want, what=""):
    for metric in want:
        for k, v in want[metric].items():
            assert abs(got[metric][k] - v) <= 1e-6, (what, metric, k, got[metric][k], v)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_topk_matches_jax_and_one_topk(runs, cases, S):
    import jax
    from jax.sharding import PartitionSpec as P

    from inductive_recommendation_tpu.ops.topk import sharded_topk as jax_sharded_topk

    mesh = _jax_mesh(S)
    fn = jax.shard_map(
        lambda x: jax_sharded_topk(x, K, "model"), mesh=mesh, in_specs=P(None, "model"),
        out_specs=(P(None, None), P(None, None)), check_vma=False,
    )
    want_vals, want_idx = (np.asarray(a) for a in fn(cases["scores"]))
    one_vals, one_idx = torch.topk(torch.as_tensor(cases["scores"]), K)
    for r in runs[S]:
        vals, idx = r["topk"]
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(idx, one_idx.numpy())
        np.testing.assert_array_equal(vals, want_vals)


@pytest.mark.parametrize("S", WORLDS)
def test_sharded_recommender_matches_jax(runs, cases, S):
    """Exclusions by global id (a no-op outside a rank's block, the sentinel
    included) and banned items (the pad rows among them) mask as JAX masks."""
    from inductive_recommendation_tpu.parallel.eval import make_sharded_recommender

    n_pad = -(-N_ITEMS // S) * S  # items and ban padded to the mesh
    items, banned = cases["items_rep"][:n_pad], cases["banned"][:n_pad]
    want = np.asarray(
        make_sharded_recommender(_jax_mesh(S), N_ITEMS, K)(cases["users_rep"], items, cases["exclude"], banned)
    )
    scores = cases["users_rep"].astype(np.float64) @ items.T.astype(np.float64)
    scores[:, banned] = -np.inf
    for row, ids in enumerate(cases["exclude"]):
        scores[row, ids[ids < N_ITEMS]] = -np.inf  # the sentinel N_ITEMS masks nothing
    one = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    for r in runs[S]:
        np.testing.assert_array_equal(r["recommender"], want)
        np.testing.assert_array_equal(r["recommender"], one)


@pytest.fixture(scope="module")
def jax_side(weights):
    from inductive_recommendation_tpu import get_model as jax_get_model
    from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset

    ds = quick_synthetic_dataset(200, 150, 3000, seed=0)
    jm = jax_get_model(CFG, ds)
    return ds, jm, {"embedding": weights[0], "w": weights[1]}


@pytest.mark.parametrize("S", WORLDS)
@pytest.mark.parametrize("what", ["val", "test", "test_banned"])
def test_mesh_evaluate_matches_single_and_jax(runs, jax_side, S, what):
    from inductive_recommendation_tpu.eval.evaluator import Evaluator as JaxEvaluator

    ds, jm, jp = jax_side
    stage = what.split("_")[0]
    banned = BANNED_ITEMS if what.endswith("banned") else None
    want = JaxEvaluator(ds, TOPKS, test_batch_size=BATCH, mesh=_jax_mesh(S)).evaluate(jm, jp, stage, banned_items=banned)[1]
    for r in runs[S]:
        _assert_metrics_equal(r["mesh"][what], r["single"][what], what)
        _assert_metrics_equal(r["mesh"][what], want, what)


@pytest.mark.parametrize("S", WORLDS)
@pytest.mark.parametrize("what", ["rec_test", "rec_val", "rec_train", "rec_banned"])
def test_mesh_recommend_matches_single_up_to_ties(runs, S, what):
    """Every rank returns the same lists; they equal the single-device
    evaluator's where a rank is clear of its neighbours' scores by 1e-4, and
    the scores at each rank agree everywhere."""
    ranks = runs[S]
    got, single, rep = ranks[0]["mesh"][what], ranks[0]["single"][what], ranks[0]["rep"].astype(np.float64)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["mesh"][what], got)
    n_users = got.shape[0]
    scores = rep[:n_users] @ rep[n_users:].T
    rows = np.arange(n_users)[:, None]
    np.testing.assert_allclose(scores[rows, got], scores[rows, single], rtol=0, atol=1e-5)
    ranked = np.sort(scores[rows, single], axis=1)[:, ::-1]
    gap = np.abs(np.diff(ranked, axis=1))
    clear = np.ones_like(got, dtype=bool)
    clear[:, 1:] &= gap > 1e-4
    clear[:, :-1] &= gap > 1e-4
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], single[clear])
    if what == "rec_banned":
        assert not np.isin(got, BANNED_ITEMS).any()


def test_mesh_evaluator_checks_the_batch():
    """test_batch_size must split over the mesh's ranks (JAX
    evaluator.py:59-63)."""
    from inductive_recommendation_tpu_torch.eval import Evaluator

    class FakeMesh:
        def size(self):
            return 3

    with pytest.raises(ValueError, match="must divide over the mesh"):
        Evaluator(_dataset(), TOPKS, test_batch_size=BATCH, device="cpu", mesh=FakeMesh())
