"""The PyTorch port's evaluation layer against the JAX package's: metric
partial sums, full-catalog ``evaluate`` and ``recommend``, and the six-slice
``inductive_eval`` after ``attach_dataset``, with IGCN weights carried across
by ``params_from_jax``.

Tolerances: metric values to 1e-6 (fp32 sums over a few hundred users).
Recommendation lists are compared id for id only at ranks whose score is more
than 1e-4 away from its neighbours' (``torch.topk`` and ``lax.top_k`` order
near-ties apart); at every rank the two lists' scores agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.eval import device_metrics as jax_dm
from inductive_recommendation_tpu.eval.evaluator import Evaluator as JaxEvaluator
from inductive_recommendation_tpu.eval.metrics import calculate_metrics as jax_calculate_metrics
from inductive_recommendation_tpu_torch import get_model
from inductive_recommendation_tpu_torch.data import BasicDataset
from inductive_recommendation_tpu_torch.eval import (
    Evaluator,
    batch_metric_sums,
    calculate_metrics,
    combine_metric_sums,
)
from inductive_recommendation_tpu_torch.models import params_from_jax

TOPKS = [5, 20]
BATCH = 32
CFG = {"name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}


def _assert_metrics_equal(got, want, what=""):
    assert set(got) == set(want)
    for metric in want:
        assert set(got[metric]) == set(want[metric])
        for k, v in want[metric].items():
            assert abs(got[metric][k] - v) <= 1e-6, (what, metric, k, got[metric][k], v)


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(200, 150, 3000, seed=0)


@pytest.fixture(scope="module")
def models(ds):
    """(jax model, jax params, port model, port params) with equal weights."""
    jm = jax_get_model(CFG, ds)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(CFG, ds, device="cpu")
    tp = params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def _random_case(rng, n_users=45, n_items=400, K=25, max_gt=300):
    rec = np.stack([rng.choice(n_items, size=K, replace=False) for _ in range(n_users)]).astype(np.int32)
    # most rows short; a few wide ones, as the sorted (binary-search) branch sees
    lens = np.where(rng.random(n_users) < 0.2, rng.integers(100, max_gt, n_users), rng.integers(0, 12, n_users))
    gt = [list(rng.choice(n_items, size=n, replace=False)) for n in lens]
    gt[0] = []  # a user with nothing to find counts in no mean
    rows = np.full((n_users, max(len(l) for l in gt)), n_items, dtype=np.int32)
    for u, l in enumerate(gt):
        rows[u, : len(l)] = l
    return rec, gt, rows


@pytest.mark.parametrize("sorted_gt", [False, True])
def test_batch_metric_sums_matches_jax(sorted_gt):
    rng = np.random.default_rng(6)
    rec, gt, rows = _random_case(rng)
    if sorted_gt:
        rows = np.sort(rows, axis=1)
    gt_len = np.asarray([len(l) for l in gt], dtype=np.int32)
    valid = rng.random(len(gt)) < 0.9  # the padding users of a short batch
    topks = (1, 5, 20, 30)  # 30 > K: the cumulative sums saturate at K
    got_s, got_v = batch_metric_sums(
        torch.as_tensor(rec), torch.as_tensor(rows), torch.as_tensor(gt_len), torch.as_tensor(valid),
        topks, sorted_gt=sorted_gt,
    )
    want_s, want_v = jax_dm.batch_metric_sums(
        jnp.asarray(rec), jnp.asarray(rows), jnp.asarray(gt_len), jnp.asarray(valid), topks, sorted_gt=sorted_gt,
    )
    assert got_s.dtype == torch.float32 and got_s.shape == (len(topks), 3)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    assert float(got_v) == float(want_v)
    _assert_metrics_equal(
        combine_metric_sums([got_s.numpy()], [float(got_v)], topks),
        jax_dm.combine_metric_sums([np.asarray(want_s)], [float(want_v)], topks),
    )
    # the host oracle over the valid users agrees as well
    keep = valid.nonzero()[0]
    _assert_metrics_equal(
        combine_metric_sums([got_s.numpy()], [float(got_v)], topks),
        calculate_metrics([gt[u] for u in keep], rec[keep], topks),
    )


def test_calculate_metrics_matches_jax():
    rng = np.random.default_rng(7)
    rec, gt, _ = _random_case(rng)
    topks = (1, 10, 25, 40)
    _assert_metrics_equal(calculate_metrics(gt, rec, topks), jax_calculate_metrics(gt, rec, topks))


@pytest.mark.parametrize("stage", ["val", "test"])
def test_evaluate_matches_jax(ds, models, stage):
    jm, jp, tm, tp = models
    results, got = Evaluator(ds, TOPKS, test_batch_size=BATCH, device="cpu").evaluate(tm, tp, stage)
    want_results, want = JaxEvaluator(ds, TOPKS, test_batch_size=BATCH).evaluate(jm, jp, stage)
    _assert_metrics_equal(got, want, stage)
    assert results == want_results


def _masked_scores(ds, rep, stage):
    """[n_users, n_items] float64 scores with -inf at the stage's exclusions
    (train items for "val", train and val items for "test", none else)."""
    rep = np.asarray(rep, dtype=np.float64)
    scores = rep[: ds.n_users] @ rep[ds.n_users :].T
    if stage in ("val", "test"):
        for u in range(ds.n_users):
            excl = list(ds.train_data[u]) + (list(ds.val_data[u]) if stage == "test" else [])
            scores[u, excl] = -np.inf
    return scores


@pytest.mark.parametrize("stage", ["val", "test", "train"])
def test_recommend_matches_jax(ds, models, stage):
    jm, jp, tm, tp = models
    got = Evaluator(ds, TOPKS, test_batch_size=BATCH, device="cpu").recommend(tm, tp, stage)
    want = JaxEvaluator(ds, TOPKS, test_batch_size=BATCH).recommend(jm, jp, stage)
    k = max(TOPKS)
    assert got.shape == want.shape == (ds.n_users, k)
    assert got.dtype == np.int32
    scores = _masked_scores(ds, jm.get_rep(jp), stage)
    rows = np.arange(ds.n_users)[:, None]
    got_s, want_s = scores[rows, got], scores[rows, want]
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    # a rank is unambiguous where its score is > 1e-4 from the scores just
    # above and just below it (the k+1-th best included)
    ranked = -np.sort(-scores, axis=1)[:, : k + 1]
    gap = np.abs(np.diff(ranked, axis=1))  # [n_users, k]: gap[:, j] is rank j to j + 1
    above = np.concatenate([np.full((ds.n_users, 1), np.inf), gap[:, : k - 1]], axis=1)
    clear = (above > 1e-4) & (gap > 1e-4) & np.isfinite(ranked[:, :k])
    assert clear.mean() > 0.5  # most ranks are compared id for id
    np.testing.assert_array_equal(got[clear], want[clear])


def _grown(ds, n_new_users=20, n_new_items=15, seed=8):
    """``ds`` plus new users and items: each new user takes 10 items of the
    grown catalog (8 to train, 2 to test), each new item 6 old users (train
    or test); old users keep their lists."""
    rng = np.random.default_rng(seed)
    n_users, n_items = ds.n_users + n_new_users, ds.n_items + n_new_items
    g = BasicDataset({"name": "Grown", "split_ratio": [0.8, 0.1, 0.1]})
    g.n_users, g.n_items = n_users, n_items
    g.train_data = [list(t) for t in ds.train_data]
    g.val_data = [list(v) for v in ds.val_data] + [[] for _ in range(n_new_users)]
    g.test_data = [list(t) for t in ds.test_data]
    for _ in range(n_new_users):
        items = rng.choice(n_items, size=10, replace=False).tolist()
        g.train_data.append(items[:8])
        g.test_data.append(items[8:])
    for item in range(ds.n_items, n_items):
        for u in rng.choice(ds.n_users, size=6, replace=False).tolist():
            (g.train_data if rng.random() < 0.7 else g.test_data)[u].append(item)
    g.train_array = np.array([(u, i) for u, t in enumerate(g.train_data) for i in t], dtype=np.int64)
    return g


def test_inductive_eval_matches_jax(ds):
    jm = jax_get_model(CFG, ds)
    jp = jm.init_params(jax.random.key(1))
    tm = get_model(CFG, ds, device="cpu")
    tp = params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    jm.feat_mat_anneal()
    tm.feat_mat_anneal()
    grown = _grown(ds)
    jm.attach_dataset(grown)
    tm.attach_dataset(grown)
    got = Evaluator(grown, TOPKS, test_batch_size=BATCH, device="cpu").inductive_eval(
        tm, tp, ds.n_users, ds.n_items, verbose=False
    )
    want = JaxEvaluator(grown, TOPKS, test_batch_size=BATCH).inductive_eval(
        jm, jp, ds.n_users, ds.n_items, verbose=False
    )
    assert list(got) == list(want) and len(got) == 6
    for tag in want:
        _assert_metrics_equal(got[tag], want[tag], tag)
    # the new users' slice has something to find, so it is not trivially 0
    assert got["New users and all items"]["Recall"][20] > 0
