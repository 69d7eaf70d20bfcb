"""The PyTorch port's IGCN, IMF and LightGCN representations against the JAX
package's, with the JAX parameters carried across by ``params_from_jax``.

Tolerance rtol 1e-5 / atol 1e-5: 1 + n_layers fp32 SpMMs summed in different
orders on the two sides."""

import jax
import numpy as np
import pytest
import torch

from inductive_recommendation_tpu import get_dataset as jax_get_dataset
from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu.data.dataset import BasicDataset as JaxBasicDataset
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu_torch import get_model
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.ops import edge_uniform, propagate_mean, spmm_csr_dropout_reference
from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(name, **kw):
    cfg = {"name": name, "embedding_size": 16, "n_layers": 2}
    if name != "LightGCN":
        cfg.update(dropout=0.3, feature_ratio=1.0)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(200, 150, 3000, seed=0)


def _pair(cfg, dataset, seed=0):
    """(jax model, jax params, port model, port params) with equal weights."""
    jm = jax_get_model(cfg, dataset)
    jp = jm.init_params(jax.random.key(seed))
    tm = get_model(cfg, dataset, device="cpu")
    tp = params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def _rep(model, params):
    return model.make_scoring_state(params).numpy()


@pytest.mark.parametrize("name", ["IGCN", "IMF", "LightGCN"])
def test_get_rep_matches_jax(ds, name):
    jm, jp, tm, tp = _pair(_cfg(name), ds)
    np.testing.assert_allclose(_rep(tm, tp), np.asarray(jm.get_rep(jp)), **TOL)
    if name == "LightGCN":
        return
    for _ in range(2):
        jm.feat_mat_anneal()
        tm.feat_mat_anneal()
    assert tm.alpha == jm.alpha
    np.testing.assert_allclose(_rep(tm, tp), np.asarray(jm.get_rep(jp)), **TOL)


@pytest.mark.parametrize("metric", ["degree", "sort", "page_rank"])
def test_select_core_feature_ratio_matches_jax(ds, metric):
    """IGCN at feature_ratio 0.8: the core maps of each ranking equal JAX's,
    the non-core nodes map to -1, and the representations agree."""
    jm, jp, tm, tp = _pair(_cfg("IGCN", feature_ratio=0.8, ranking_metric=metric), ds)
    np.testing.assert_array_equal(tm.user_map, jm.user_map)
    np.testing.assert_array_equal(tm.item_map, jm.item_map)
    assert (tm.user_map == -1).sum() == ds.n_users - int(ds.n_users * 0.8)
    assert tm.feat_n_cols == jm.feat_n_cols == tm.user_dim + tm.item_dim + 2
    np.testing.assert_allclose(_rep(tm, tp), np.asarray(jm.get_rep(jp)), **TOL)


def test_attach_dataset_matches_jax():
    """The retrain-free cold start of tests/test_igcn.py: 5 new users and 4 new
    items join after training; the trained table is kept."""
    base = jax_get_dataset(
        {
            "name": "SyntheticDataset",
            "n_users": 60,
            "n_items": 50,
            "n_interactions": 900,
            "seed": 11,
            "split_ratio": [0.7, 0.15, 0.15],
            "min_inter": 3,
        }
    )
    jm, jp, tm, tp = _pair(_cfg("IGCN"), base)
    new_ds = JaxBasicDataset({"name": "BasicDataset"})
    new_ds.n_users = base.n_users + 5
    new_ds.n_items = base.n_items + 4
    rng = np.random.default_rng(0)
    extra = []
    for nu in range(base.n_users, new_ds.n_users):
        for i in rng.choice(base.n_items, size=3, replace=False):
            extra.append([nu, int(i)])
    new_ds.train_data = [list(t) for t in base.train_data] + [[] for _ in range(5)]
    for u, i in extra:
        new_ds.train_data[u].append(i)
    new_ds.train_array = np.concatenate([np.asarray(base.train_array), np.asarray(extra)], axis=0)
    new_ds.val_data = [[] for _ in range(new_ds.n_users)]
    new_ds.test_data = [[] for _ in range(new_ds.n_users)]

    jm.attach_dataset(new_ds)
    tm.attach_dataset(new_ds)
    rep = _rep(tm, tp)
    assert rep.shape == (new_ds.n_users + new_ds.n_items, 16)
    np.testing.assert_allclose(rep, np.asarray(jm.get_rep(jp)), **TOL)
    assert np.abs(rep[base.n_users : new_ds.n_users]).sum() > 0
    np.testing.assert_array_equal(tm.user_map, jm.user_map)
    np.testing.assert_array_equal(tm.item_map, jm.item_map)


def test_checkpoint_aux_round_trip(ds):
    _, _, tm, tp = _pair(_cfg("IGCN"), ds)
    tm.feat_mat_anneal()
    aux = tm.checkpoint_aux()
    before = _rep(tm, tp)
    other = get_model(_cfg("IGCN"), ds, device="cpu")
    other.restore_aux(aux)
    assert other.alpha == tm.alpha
    np.testing.assert_array_equal(_rep(other, tp), before)


def test_params_from_jax_refuses_mismatch(ds):
    tm = get_model(_cfg("IGCN"), ds, device="cpu")
    good = {k: v.detach().numpy().copy() for k, v in tm.params().items()}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tm, {**good, "embedding": good["embedding"][:-1]})
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tm, {"embedding": good["embedding"]})
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(tm, {**good, "bias": good["w"]})
    assert set(params_from_jax(tm, good)) == {"embedding", "w"}


def test_unported_branches_raise(ds):
    # feature_ratio < 1 is ported (graph/ranking.py): the core maps are JAX's
    jm = jax_get_model(_cfg("IGCN", feature_ratio=0.8), ds)
    tm = get_model(_cfg("IGCN", feature_ratio=0.8), ds, device="cpu")
    np.testing.assert_array_equal(tm.user_map, jm.user_map)
    np.testing.assert_array_equal(tm.item_map, jm.item_map)
    assert (tm.user_dim, tm.item_dim) == (int(ds.n_users * 0.8), int(ds.n_items * 0.8))
    # training-time edge dropout is ported: at p 0.3 the rep differs from p 0's
    # and is the plain chain under the mask drawn from the generator's seed,
    # which keeps 70% of the feature edges within 4 binomial sigma
    tm = get_model(_cfg("IGCN"), ds, device="cpu")
    no_drop = get_model(_cfg("IGCN", dropout=0.0), ds, device="cpu")
    params = tm.params()
    with torch.no_grad():
        rep = tm.get_rep(params, training=True, generator=torch.Generator().manual_seed(3))
        rep_p0 = no_drop.get_rep(params, training=True, generator=torch.Generator().manual_seed(3))
        seed = dropout_seed(torch.Generator().manual_seed(3))
        x0 = spmm_csr_dropout_reference(tm.feat, params["embedding"][: tm.feat_n_cols], seed, 0.3)
        plain = propagate_mean(tm.norm_adj, x0, tm.n_layers)
    assert not torch.allclose(rep, rep_p0, **TOL)
    np.testing.assert_allclose(rep.numpy(), plain.numpy(), **TOL)
    keep = (edge_uniform(seed, tm.feat.eid) >= 0.3).double()
    assert abs(keep.mean().item() - 0.7) < 4 * (0.21 / keep.numel()) ** 0.5


def test_get_model_without_a_card_raises(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(_cfg("IGCN"), ds)
    from inductive_recommendation_tpu_torch.eval import Evaluator

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(ds, topks=[20])
