"""The port's DOSE building blocks against the JAX package: node rankings,
``info_nce``, the flat cosine top-k, the view CSR against JAX's
``make_view`` and its propagation with its gradient, and the device draws'
properties.

Tolerances: rankings exactly (the same numpy on both sides); view matrices
rtol 1e-6 (the same float64 arithmetic, cast to fp32); ``info_nce`` 1e-6
(its gradient rtol 1e-5 / atol 1e-6); similarity values
1e-5 with the selected pairs compared as sets (``torch.topk`` and
``lax.top_k`` break ties differently; the inputs have distinct
similarities); propagation and its gradient rtol 1e-5 / atol 1e-6, since the
view CSR sums a row's edges in another order than JAX's masked base plus
delta."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.graph import ranking as JR
from inductive_recommendation_tpu.graph.views import ViewEngine as JaxViewEngine
from inductive_recommendation_tpu.graph.views import view_propagate_mean as jax_view_propagate_mean
from inductive_recommendation_tpu.ops.cosine_topk import blockwise_cosine_topk as jax_cosine_topk
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch.graph import ranking as TR
from inductive_recommendation_tpu_torch.graph import sym_normalized_adjacency
from inductive_recommendation_tpu_torch.graph.views import ViewEngine, random_keep_mask_on_device, random_pairs_on_device
from inductive_recommendation_tpu_torch.ops import blockwise_cosine_topk, propagate_mean
from inductive_recommendation_tpu_torch.train import info_nce

PROP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(60, 50, 1500, seed=7)


# -- rankings ---------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["degree", "sort", "greedy", "page_rank"])
def test_rank_nodes_from_edges_matches_jax(ds, metric):
    want = JR.rank_nodes_from_edges(ds.train_array, ds.n_users, ds.n_items, metric)
    got = TR.rank_nodes_from_edges(ds.train_array, ds.n_users, ds.n_items, metric)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("metric", ["sort", "greedy"])
def test_svd_rank_nodes_matches_jax(ds, metric):
    np.random.seed(0)  # svds' start vector
    want = JR.svd_rank_nodes(ds.train_array, ds.n_users, ds.n_items, metric, rank=8)
    np.random.seed(0)
    got = TR.svd_rank_nodes(ds.train_array, ds.n_users, ds.n_items, metric, rank=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_aug_and_drop_rankings_match_jax(ds):
    rng = np.random.default_rng(0)
    aug = np.stack([rng.integers(0, ds.n_users, 80), rng.integers(0, ds.n_items, 80)], axis=1)
    aug = np.concatenate([aug, aug[:10]])  # duplicates collapse
    for got, want in (
        (TR.graph_aug_rank_nodes(ds, "sort", aug), JR.graph_aug_rank_nodes(ds, "sort", aug)),
        (TR.graph_drop_rank_nodes(ds, "degree", ds.train_array[::2]), JR.graph_drop_rank_nodes(ds, "degree", ds.train_array[::2])),
        (TR.graph_drop_rank_nodes(ds, "greedy"), JR.graph_drop_rank_nodes(ds, "greedy")),
    ):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="ranking_metric"):
        TR.rank_nodes_from_edges(ds.train_array, ds.n_users, ds.n_items, "nope")


# -- info_nce ---------------------------------------------------------------------


def test_info_nce_matches_jax():
    rng = np.random.default_rng(1)
    q, p, n = (rng.standard_normal((32, 16)).astype(np.float32) for _ in range(3))
    q[3] = 0.0  # an isolated user's all-zero row: finite loss and gradient
    t = [torch.as_tensor(a).requires_grad_(True) for a in (q, p, n)]
    loss = info_nce(*t)
    loss.sum().backward()
    j_loss = JL.info_nce(*map(jnp.asarray, (q, p, n)))
    j_grads = jax.grad(lambda *a: JL.info_nce(*a).sum(), argnums=(0, 1, 2))(*map(jnp.asarray, (q, p, n)))
    assert loss.shape == (32,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), rtol=1e-6, atol=1e-6)
    for a, g in zip(t, j_grads):
        assert torch.isfinite(a.grad).all()
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


# -- cosine top-k -----------------------------------------------------------------


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("k", [100, 1000])  # below and above one panel of 16 x 45
def test_blockwise_cosine_topk_matches_jax(negate, k):
    rng = np.random.default_rng(2)
    users = rng.standard_normal((70, 8)).astype(np.float32)
    items = rng.standard_normal((45, 8)).astype(np.float32)
    vals, uid, iid = blockwise_cosine_topk(torch.as_tensor(users), torch.as_tensor(items), k, negate, block_rows=16)
    j_vals, j_uid, j_iid = jax_cosine_topk(jnp.asarray(users), jnp.asarray(items), k, negate, block_rows=16)
    assert vals.shape == uid.shape == iid.shape == (k,) and uid.dtype == iid.dtype == torch.int32
    assert (torch.diff(vals) <= 0).all()
    assert set(zip(uid.tolist(), iid.tolist())) == set(zip(np.asarray(j_uid).tolist(), np.asarray(j_iid).tolist()))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=0, atol=1e-5)
    # each value is its pair's cosine (items negated), recomputed in float64
    un = users / np.linalg.norm(users, axis=1, keepdims=True)
    itn = items / np.linalg.norm(items, axis=1, keepdims=True) * (-1.0 if negate else 1.0)
    cos = (un.astype(np.float64) @ itn.astype(np.float64).T)[uid.numpy(), iid.numpy()]
    np.testing.assert_allclose(vals.numpy(), cos, rtol=0, atol=1e-5)


# -- views ------------------------------------------------------------------------


def _dense_csr(view):
    n = view.n_rows
    out = np.zeros((n, view.n_cols))
    rows = np.repeat(np.arange(n), np.diff(view.row_ptr.numpy()))
    np.add.at(out, (rows, view.col.numpy()), view.val.numpy())
    return out


def _dense_jax_view(engine, ev):
    n = engine.n_nodes
    out = np.zeros((n, n))
    np.add.at(out, (engine._base_rows, engine._base_cols), np.asarray(ev.base_scale))
    np.add.at(out, (np.asarray(ev.d_row), np.asarray(ev.d_col)), np.asarray(ev.d_val))
    return out


def _engines(ds, budget):
    return (
        ViewEngine(ds.train_array, ds.n_users, ds.n_items, delta_budget=budget, device="cpu"),
        JaxViewEngine(ds.train_array, ds.n_users, ds.n_items, delta_budget=budget),
    )


def _view_inputs(ds, eng, seed):
    """A keep mask of about 70% of the train pairs; injected pairs with random
    ones, four already in train (force-kept) and three duplicates."""
    rng = np.random.default_rng(seed)
    keep = rng.random(eng.n_pairs) < 0.7
    adds = np.concatenate(
        [np.stack([rng.integers(0, ds.n_users, 20), rng.integers(0, ds.n_items, 20)], axis=1), eng.train_pairs[:4]]
    )
    return keep, np.concatenate([adds, adds[:3]])


@pytest.mark.parametrize("case", ["drop_and_add", "add_only", "drop_only", "keep_all", "add_valid"])
def test_make_view_on_device_matches_jax(ds, case):
    """The view CSR against JAX's host ``make_view`` (or its device builder
    for ``add_valid``) on the same keep mask and injected pairs, as dense
    matrices; every view is symmetric."""
    eng, j_eng = _engines(ds, budget=32)
    keep, adds = _view_inputs(ds, eng, seed=3)
    kw = {
        "drop_and_add": dict(keep_pair_mask=keep, add_pairs=adds),
        "add_only": dict(add_pairs=adds),
        "drop_only": dict(keep_pair_mask=keep),
        "keep_all": {},
    }.get(case)
    if case == "add_valid":
        valid = np.arange(len(adds)) % 3 != 0  # a threshold that leaves out rows
        view = eng.make_view_on_device(keep_pair_mask=torch.as_tensor(keep), add_pairs=torch.as_tensor(adds), add_valid=torch.as_tensor(valid))
        want = j_eng.make_view_on_device(keep_pair_mask=jnp.asarray(keep), add_pairs=jnp.asarray(adds, jnp.int32), add_valid=jnp.asarray(valid))
    else:
        view = eng.make_view_on_device(**kw)
        want = j_eng.make_view(**kw)
    dense = _dense_csr(view)
    np.testing.assert_allclose(dense, _dense_jax_view(j_eng, want), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(dense, dense.T)
    assert view.symmetric and view.view and view.T is view
    assert (np.asarray(view.val) != 0).all()
    if case == "keep_all":
        r, c, v = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
        plain = np.zeros_like(dense)
        np.add.at(plain, (r, c), v)
        np.testing.assert_allclose(dense, plain, rtol=1e-6, atol=0)


def test_view_budget_is_enforced_after_dedup(ds):
    """Duplicates and in-train pairs do not count against the budget; more
    distinct new pairs than it raise, as JAX's ``make_view`` does."""
    eng, j_eng = _engines(ds, budget=5)
    train_keys = set((eng.train_pairs[:, 0] * ds.n_items + eng.train_pairs[:, 1]).tolist())
    new = [(u, i) for u in range(ds.n_users) for i in range(ds.n_items) if u * ds.n_items + i not in train_keys]
    fits = np.array(new[:5] * 3 + eng.train_pairs[:6].tolist())
    np.testing.assert_allclose(
        _dense_csr(eng.make_view_on_device(add_pairs=fits)), _dense_jax_view(j_eng, j_eng.make_view(add_pairs=fits)), rtol=1e-6
    )
    over = np.array(new[:6])
    with pytest.raises(ValueError, match="exceeds budget 5"):
        eng.make_view_on_device(add_pairs=over)
    with pytest.raises(ValueError, match="exceeds budget 5"):
        j_eng.make_view(add_pairs=over)
    drop_only, _ = _engines(ds, budget=0)
    with pytest.raises(ValueError, match="exceeds budget 0"):
        drop_only.make_view_on_device(add_pairs=over[:1])


def test_keep_mask_from_drop_pairs_matches_jax(ds):
    eng, j_eng = _engines(ds, budget=0)
    rng = np.random.default_rng(4)
    drop = np.concatenate(
        [eng.train_pairs[rng.choice(eng.n_pairs, 30, replace=False)], [[0, 0], [1, 1]], eng.train_pairs[:2]]
    )
    got = eng.keep_mask_from_drop_pairs_on_device(torch.as_tensor(drop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_eng.keep_mask_from_drop_pairs_on_device(jnp.asarray(drop, jnp.int32))))
    np.testing.assert_array_equal(got.numpy(), j_eng.keep_mask_from_drop_pairs(drop))


def test_view_propagate_mean_and_gradient_match_jax(ds):
    """``propagate_mean`` over the view CSR and the gradient of <out, g> with
    respect to x0 (the same symmetric CSR, backward) against JAX's
    ``view_propagate_mean`` over the same EdgeView and ``jax.vjp``."""
    eng, j_eng = _engines(ds, budget=32)
    keep, adds = _view_inputs(ds, eng, seed=5)
    view = eng.make_view_on_device(keep_pair_mask=keep, add_pairs=adds)
    ev = j_eng.make_view(keep_pair_mask=keep, add_pairs=adds)
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((eng.n_nodes, 8)).astype(np.float32)
    g = rng.standard_normal((eng.n_nodes, 8)).astype(np.float32)
    x = torch.as_tensor(x0).requires_grad_(True)
    out = propagate_mean(view, x, 3)
    out.backward(torch.as_tensor(g))
    j_out, vjp = jax.vjp(lambda a: jax_view_propagate_mean(j_eng.base, ev, a, 3), jnp.asarray(x0))
    (j_grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **PROP_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), **PROP_TOL)


# -- device draws -----------------------------------------------------------------


def test_random_draws_properties():
    """Pairs in range, exactly n_keep kept, the same (seed, counter) giving the
    same bits and another counter or seed other bits."""
    kw = dict(n=5000, n_users=37, n_items=23, device="cpu")
    pairs = random_pairs_on_device(3, seed=1, **kw)
    assert pairs.shape == (5000, 2) and pairs.dtype == torch.int64
    assert pairs[:, 0].min() >= 0 and pairs[:, 0].max() == 36 and pairs[:, 1].min() == 0 and pairs[:, 1].max() == 22
    assert torch.equal(pairs, random_pairs_on_device(3, seed=1, **kw))
    assert not torch.equal(pairs, random_pairs_on_device(4, seed=1, **kw))
    assert not torch.equal(pairs, random_pairs_on_device(3, seed=2, **kw))
    for n_keep in (0, 1, 499, 1000):
        keep = random_keep_mask_on_device(7, n_pairs=1000, n_keep=n_keep, seed=0, device="cpu")
        assert keep.dtype == torch.bool and int(keep.sum()) == n_keep
    a = random_keep_mask_on_device(7, n_pairs=1000, n_keep=400, seed=0, device="cpu")
    assert torch.equal(a, random_keep_mask_on_device(7, n_pairs=1000, n_keep=400, seed=0, device="cpu"))
    assert not torch.equal(a, random_keep_mask_on_device(8, n_pairs=1000, n_keep=400, seed=0, device="cpu"))
