"""DOSE_aug2 in the port against the JAX package: the augmented feature matrix
(one CSR over train plus the selected pairs, and its transpose) densified
against JAX's base layout plus rectangular delta, at alpha 1, after anneals
and with a core selected from the first augmented graph; its row sums and
dropout mask; ``view_users`` at p = 0; two epochs of ``DOSEaugTrainer``;
``attach_dataset``; and the checkpoint's replay of the matrix.

Both sides get the same weights and batches and dropout 0 (torch and JAX
random streams never agree). Tolerances: matrices rtol 1e-6 (the same
float32 weights; JAX adds its delta in another order); representations,
losses and parameters rtol 1e-5, atol 1e-5 times the JAX side's largest
magnitude (fp32 sums in other orders); replay bitwise."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset as JaxAuxiliaryDataset
from inductive_recommendation_tpu.data.dataset import BasicDataset as JaxBasicDataset
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.graph.views import feat_delta_host
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_values, route_key
from inductive_recommendation_tpu_torch.train import trainer as trainer_module

RTOL = 1e-5


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(60, 50, 1500, seed=7)


def _cfg(**kw):
    cfg = {"name": "DOSE_aug2", "embedding_size": 16, "n_layers": 2, "dropout": 0.0, "feature_ratio": 1.0,
           "aug_num": 40}
    cfg.update(kw)
    return cfg


def _pair(dataset, **kw):
    jm = jax_get_model(_cfg(**kw), dataset)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(_cfg(**kw), dataset, device="cpu")
    tp = params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def _dense_csr(mat, val=None):
    out = np.zeros(mat.shape)
    rows = np.repeat(np.arange(mat.n_rows), np.diff(mat.row_ptr.numpy()))
    np.add.at(out, (rows, mat.col.numpy()), (mat.val if val is None else val).numpy())
    return out


def _dense_jax_aug_feat(jm):
    """JAX's augmented feature matrix, base layout plus delta, as the
    layer-0 view input of the identity table."""
    eye = {"embedding": jnp.eye(jm.feat_n_cols, dtype=jnp.float32)}
    return np.asarray(jm._view_x0(eye, jm.buffers, None, False))


def _assert_aug_feat_matches(tm, jm):
    dense = _dense_csr(tm.aug_feat)
    np.testing.assert_allclose(dense, _dense_jax_aug_feat(jm), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_dense_csr(tm.aug_feat.T), dense.T)


@pytest.mark.parametrize("feature_ratio, anneals", [(1.0, 0), (1.0, 3), (0.6, 0), (0.6, 2)])
def test_aug_feat_matches_jax(ds, feature_ratio, anneals):
    """After ``anneals`` anneals and one update from the same params: the
    highest-cosine selection, the augmented matrix and its transpose, its
    row sums (base plus the injected entries), the core selected from the
    first augmented graph (feature_ratio 0.6), the routes it counts under,
    and the dropout mask, the same edges forward and transposed."""
    jm, jp, tm, tp = _pair(ds, feature_ratio=feature_ratio)
    assert tm.aug_feat is None
    for _ in range(anneals):
        tm.feat_mat_anneal()
        jm.feat_mat_anneal()
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
    want_pairs = np.asarray(jm._last_aug_pairs_dev)
    assert {tuple(p) for p in tm._last_aug_pairs.tolist()} == {tuple(p) for p in want_pairs.tolist()}
    _assert_aug_feat_matches(tm, jm)
    if feature_ratio < 1.0:
        np.testing.assert_array_equal(tm.aug_user_map, jm.aug_user_map)
        np.testing.assert_array_equal(tm.aug_item_map, jm.aug_item_map)
        assert (tm.aug_user_map != tm.user_map).any()
    um, im = (tm.aug_user_map, tm.aug_item_map) if feature_ratio < 1.0 else (tm.user_map, tm.item_map)
    static = jm._aug_feat_static
    row_sum = feat_delta_host(
        jm.view_engine.train_keys, um, im, static["base_row_sum"], want_pairs, tm.alpha, budget=tm.aug_num,
        n_users=tm.n_users, n_items=tm.n_items, user_dim=tm.user_dim,
    )[0]
    np.testing.assert_array_equal(tm.aug_row_sum.numpy(), np.asarray(row_sum))
    assert tm.aug_feat.nnz > tm._aug_base["rows"].shape[0]  # some pairs were injected
    assert route_key(tm.aug_feat, (1, 0.3)) == "aug_feat" and route_key(tm.aug_feat.T) == "aug_feat_transpose"
    seed, p = 123, 0.4
    kept = _dense_csr(tm.aug_feat, dropout_values(tm.aug_feat.val, tm.aug_feat.eid, seed, p)) != 0
    kept_t = _dense_csr(tm.aug_feat.T, dropout_values(tm.aug_feat.T.val, tm.aug_feat.T.eid, seed, p)) != 0
    np.testing.assert_array_equal(kept, kept_t.T)
    assert 0 < kept.sum() < tm.aug_feat.nnz


def test_view_users_before_and_after_update_match_jax(ds):
    """``view_users`` at p = 0 against JAX's: before the first update from
    the main feature matrix (JAX's seeded all-in-train matrix), after it
    from the augmented one."""
    jm, jp, tm, tp = _pair(ds, dropout=0.0)
    users = np.random.default_rng(0).integers(0, ds.n_users, 64)
    for update in (False, True):
        if update:
            tm.update_aug_adj(tp)
            jm.update_aug_adj(jp)
        got = tm.view_users(tp, "aug_adj", torch.as_tensor(users), True, None)
        want = jm.view_users(jp, jm.buffers, "aug_adj", jnp.asarray(users), None, False)
        assert_close(got, want)


def _harness():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "golden_parity_flagships.py")
    spec = importlib.util.spec_from_file_location("golden_flagships", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dose_step(jm, lr, l2_reg, aux_reg, c_reg):
    """One optax Adam step of JAX's DOSE loss (trainer.py:560-587)."""
    optimizer = optax.adam(lr)

    def step(params, opt_state, buffers, users, pos, neg, au, ap, an):
        def loss_fn(p):
            u_r, p_r, n_r, l2, closs = jm.bpr_forward(p, users, pos, neg, training=False, buffers=buffers)
            aux = JL.aux_bpr_w(p["embedding"], p["w"], au, ap, an, jm.user_dim)
            return JL.bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean() + aux_reg * aux + c_reg * closs.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return optimizer, jax.jit(step)


@pytest.mark.parametrize("feature_ratio", [1.0, 0.6])
def test_dose_aug_trainer_epochs_match_jax(ds, monkeypatch, feature_ratio):
    """Two epochs of three DOSEaugTrainer steps: each epoch's mean loss, the
    anneal, the view and augmented matrix the epoch end builds, and the
    parameters after, against optax Adam on JAX's loss with the same
    batches."""
    jm, jp, tm, _ = _pair(ds, feature_ratio=feature_ratio)
    trainer = get_trainer({"name": "DOSEaugTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4,
                           "aux_reg": 0.01, "contrastive_reg": 0.05, "n_epochs": 2, "batch_size": 128,
                           "topks": [20]}, ds, tm)
    params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    trainer.steps_per_epoch = 3
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map)
    epochs = _harness().make_batches(np.random.default_rng(8), ds, jm, aux, 2, 3, 128)
    it = iter([b for e in epochs for users, pos, neg, au, ap, an in e for b in ((users, pos, neg), (au, ap, an))])

    def fake(state, generator, batch_size, neg_ratio=1):
        u, p, n = next(it)
        return torch.as_tensor(u).long(), torch.as_tensor(p).long(), torch.as_tensor(n).long()[:, None]

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)
    optimizer, jstep = _jax_dose_step(jm, 1e-3, 1e-4, 0.01, 0.05)
    opt_state = optimizer.init(jp)
    for batches in epochs:
        losses = []
        for b in batches:
            jp, opt_state, loss = jstep(jp, opt_state, jm.buffers, *map(jnp.asarray, b))
            losses.append(float(loss))
        jm.feat_mat_anneal()
        jm.update_aug_adj(jp)
        np.testing.assert_allclose(trainer.train_one_epoch(), np.mean(losses), rtol=RTOL)
        assert tm.alpha == jm.alpha
        _assert_aug_feat_matches(tm, jm)
    for k, v in tm.params().items():
        assert_close(v, jp[k], err_msg=k)


def _grown(base):
    grown = JaxBasicDataset({"name": "Grown"})
    grown.n_users, grown.n_items = base.n_users + 5, base.n_items + 4
    rng = np.random.default_rng(0)
    extra = [[u, int(i)] for u in range(base.n_users, grown.n_users) for i in rng.choice(grown.n_items, 3, replace=False)]
    extra += [[int(u), i] for i in range(base.n_items, grown.n_items) for u in rng.choice(base.n_users, 2, replace=False)]
    grown.train_array = np.concatenate([np.asarray(base.train_array), np.asarray(extra)])
    grown.train_data = [[] for _ in range(grown.n_users)]
    for u, i in grown.train_array:
        grown.train_data[u].append(int(i))
    grown.val_data = [[] for _ in range(grown.n_users)]
    grown.test_data = [[] for _ in range(grown.n_users)]
    return grown


def test_attach_dataset_extends_the_aug_maps():
    """5 new users and 4 new items join after an update at feature_ratio
    0.6: the augmented core maps grow with -1 for them, as JAX's, the main
    feat serves the view until the next update, and that update builds
    JAX's matrix over the grown set."""
    base = quick_synthetic_dataset(60, 50, 1200, seed=11)
    jm, jp, tm, tp = _pair(base, feature_ratio=0.6)
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
    maps = tm.aug_user_map.copy(), tm.aug_item_map.copy()
    grown = _grown(base)
    tm.attach_dataset(grown)
    jm.attach_dataset(grown)
    assert tm.aug_feat is None and len(tm.aug_user_map) == grown.n_users and len(tm.aug_item_map) == grown.n_items
    np.testing.assert_array_equal(tm.aug_user_map[: base.n_users], maps[0])
    assert (tm.aug_user_map[base.n_users :] == -1).all() and (tm.aug_item_map[base.n_items :] == -1).all()
    np.testing.assert_array_equal(tm.aug_user_map, jm.aug_user_map)
    np.testing.assert_array_equal(tm.aug_item_map, jm.aug_item_map)
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
    assert tm.aug_feat.shape == (grown.n_users + grown.n_items, tm.feat_n_cols)
    _assert_aug_feat_matches(tm, jm)


@pytest.mark.parametrize("feature_ratio", [1.0, 0.6])
def test_checkpoint_replays_the_aug_feat_bitwise(ds, tmp_path, monkeypatch, feature_ratio):
    """save -> load -> rebuild_views gives the saved run's view and
    augmented matrix bit for bit, with the augmented core the checkpoint
    kept (not one selected again from the restored params)."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(feature_ratio=feature_ratio, dropout=0.3)
    tcfg = {"name": "DOSEaugTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
            "contrastive_reg": 0.05, "n_epochs": 2, "batch_size": 128, "topks": [20], "seed": 3}
    a = get_trainer(tcfg, ds, get_model(cfg, ds, device="cpu"))
    a.steps_per_epoch = 2
    for _ in range(2):
        a.train_one_epoch()
    a._save_model(tmp_path / "best.pt")
    b = get_trainer(dict(tcfg, seed=11), ds, get_model(cfg, ds, device="cpu"))
    b._load_model(tmp_path / "best.pt")
    if feature_ratio < 1.0:
        np.testing.assert_array_equal(b.model.aug_user_map, a.model.aug_user_map)
    for mine, theirs in ((b.model.aug_feat, a.model.aug_feat), (b.model.aug_feat.T, a.model.aug_feat.T),
                         (b.model.views["aug_adj"], a.model.views["aug_adj"])):
        for field in ("row_ptr", "col", "val", "eid"):
            assert torch.equal(getattr(mine, field), getattr(theirs, field)), field
