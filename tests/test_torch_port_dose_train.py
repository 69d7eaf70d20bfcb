"""The port's DOSE models and trainers against the JAX package: every
variant's views and ``bpr_forward`` after an ``update_aug_adj``, the
selection restricted to degree tails, the checkpoint replay of the views, ``attach_dataset`` on a grown set, the three
DOSE trainers' steps against optax, and the golden DOSE_aug gate.

Both sides get the same weights (``params_from_jax``), the same batches
(``benchmarks/golden_parity_flagships.py::make_batches``) and dropout 0:
torch and JAX random streams never agree. For the same reason the random
variants' draws (the port's ``random_pairs_on_device`` /
``random_keep_mask_on_device``) are handed to the JAX model. TEST's host
mask comes from numpy's ``default_rng(aug_seed)`` on both sides.

Tolerances: view matrices rtol 1e-6 (the same float64 arithmetic);
representations, losses and parameters rtol 1e-5 / atol 1e-6 (fp32 sums in
other orders: the view CSR sums a row's edges in another order than JAX's
masked base plus delta); the golden gate's |ΔRecall@20|, |ΔNDCG@20| < 0.03
with a selection Jaccard > 0.7 at every epoch, the band of
``tests/test_golden_flagships.py:45-55`` (near-tie flips of the epoch-end
selection at this tiny scale); checkpoint replay bitwise."""

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
from inductive_recommendation_tpu.eval.evaluator import Evaluator as JaxEvaluator
from inductive_recommendation_tpu.models import MODELS as JAX_MODELS
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.models import DOSE_MODELS, params_from_jax
from inductive_recommendation_tpu_torch.train import TRAINERS
from inductive_recommendation_tpu_torch.train import trainer as trainer_module

TOL = dict(rtol=1e-5, atol=1e-6)
RANDOM_VARIANTS = {"DOSE_aug3", "DOSE_drop2", "TEST", "TEST2", "DOSE_aug_drop"}


def _harness():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "golden_parity_flagships.py")
    spec = importlib.util.spec_from_file_location("golden_flagships", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(60, 50, 1500, seed=7)


def _cfg(name, **kw):
    cfg = {"name": name, "embedding_size": 16, "n_layers": 2, "dropout": 0.0, "feature_ratio": 1.0,
           "aug_num": 40, "aug_rate": 0.5, "pai": 0.6}
    cfg.update(kw)
    return cfg


def _tcfg(name, **kw):
    cfg = {"name": name, "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
           "contrastive_reg": 0.05, "n_epochs": 4, "batch_size": 128, "test_batch_size": 256, "topks": [20]}
    cfg.update(kw)
    return cfg


def _pair(cfg, dataset):
    jm = jax_get_model(cfg, dataset)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(cfg, dataset, device="cpu")
    tp = params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def _hand_draws_to_jax(tm, jm):
    """The port model's random draws are recorded and replayed, in order, by
    the JAX model's draw methods."""
    queue = []
    for name in ("_random_pairs_device", "_random_keep_mask_device"):
        port_draw = getattr(tm, name)

        def record(arg, port_draw=port_draw):
            out = port_draw(arg)
            queue.append(out.numpy())
            return out

        setattr(tm, name, record)

    def replay(arg):
        a = queue.pop(0)
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    jm._random_pairs_device = jm._random_keep_mask_device = replay
    return queue


def _dense_csr(view):
    out = np.zeros(view.shape)
    rows = np.repeat(np.arange(view.n_rows), np.diff(view.row_ptr.numpy()))
    np.add.at(out, (rows, view.col.numpy()), view.val.numpy())
    return out


def _dense_jax_view(jm, key):
    eng, ev = jm.view_engine, jm.edge_views[key]
    out = np.zeros((eng.n_nodes, eng.n_nodes))
    np.add.at(out, (eng._base_rows, eng._base_cols), np.asarray(ev.base_scale))
    np.add.at(out, (np.asarray(ev.d_row), np.asarray(ev.d_col)), np.asarray(ev.d_val))
    return out


def _assert_views_match(tm, jm):
    assert tuple(tm.views) == tuple(jm.view_keys)
    for key in tm.views:
        np.testing.assert_allclose(_dense_csr(tm.views[key]), _dense_jax_view(jm, key), rtol=1e-6, atol=0, err_msg=key)


def _batch(ds, seed=0, n=64):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, ds.n_users, n)
    pos = rng.integers(0, ds.n_items, n)
    neg = rng.integers(0, ds.n_items, n)
    return users, pos, neg


@pytest.mark.parametrize("name", [cls.__name__ for cls in DOSE_MODELS])
def test_update_aug_adj_and_bpr_forward_match_jax(ds, name):
    """After one ``update_aug_adj`` from the same params, every view equals
    JAX's (cosine variants select the same pairs; random variants get the
    port's draws), and ``bpr_forward``'s five outputs agree."""
    jm, jp, tm, tp = _pair(_cfg(name), ds)
    if name in RANDOM_VARIANTS:
        queue = _hand_draws_to_jax(tm, jm)
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
    if name in RANDOM_VARIANTS:
        assert queue == []
    _assert_views_match(tm, jm)
    if name == "TEST":
        np.testing.assert_array_equal(tm._main_keep, jm._main_keep)
    if name == "DOSE_aug4":  # the threshold keeps some of the aug_num pairs, not all
        assert 0 < tm.views["aug_adj"].nnz - tm.norm_adj.nnz < 2 * tm.aug_num
    users, pos, neg = _batch(ds)
    with torch.no_grad():
        got = tm.bpr_forward(tp, *(torch.as_tensor(a) for a in (users, pos, neg)), training=True)
    want = jm.bpr_forward(jp, *(jnp.asarray(a) for a in (users, pos, neg)), training=False, buffers=jm.buffers)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("negate", [False, True])
def test_cos_pairs_with_restrict_match_jax(ds, negate):
    """The model-level selection over DOSE_aug_drop2's degree tails (the
    restrict remap back to global ids), as a set, against JAX's."""
    jm, jp, tm, tp = _pair(_cfg("DOSE_aug_drop2", aug_num=300), ds)
    np.testing.assert_array_equal(tm._tail_users, jm._tail_users)
    restrict = (tm._tail_users, tm._tail_items)
    got = tm._cos_pairs(tp, 300, negate, restrict=restrict)
    want = np.asarray(jm._cos_pairs(jp, 300, negate_items=negate, restrict=restrict))
    assert got.shape == (300, 2)
    assert np.isin(got[:, 0].numpy(), tm._tail_users).all() and np.isin(got[:, 1].numpy(), tm._tail_items).all()
    assert {tuple(p) for p in got.tolist()} == {tuple(p) for p in want.tolist()}
    # more than the candidates: every tail pair once
    every = tm._cos_pairs(tp, 10**6, negate, restrict=restrict)
    assert every.shape == (len(restrict[0]) * len(restrict[1]), 2)
    assert len({tuple(p) for p in every.tolist()}) == every.shape[0]


@pytest.mark.parametrize("name, epochs", [("DOSE_aug", 2), ("DOSE_aug3", 2), ("DOSE_aug_drop", 0), ("TEST", 1)])
def test_checkpoint_replays_the_views_bitwise(ds, tmp_path, monkeypatch, name, epochs):
    """save -> load -> rebuild_views gives the saved run's view CSRs bit for
    bit, for cosine and random recipes, before and after the first update;
    a resumed trainer's next step equals the uninterrupted run's."""
    monkeypatch.chdir(tmp_path)
    cfg, tcfg = _cfg(name, dropout=0.3), _tcfg("DOSEaugTrainer", seed=3)
    a = get_trainer(tcfg, ds, get_model(cfg, ds, device="cpu"))
    for _ in range(epochs):
        a.train_one_epoch()
    a._save_model(tmp_path / "best.pt")
    a.save_state(tmp_path / "state.pt")
    fresh = get_trainer(dict(tcfg, seed=11), ds, get_model(cfg, ds, device="cpu"))
    fresh._load_model(tmp_path / "best.pt")
    b = get_trainer(dict(tcfg, seed=11), ds, get_model(cfg, ds, device="cpu"))
    b.load_state(tmp_path / "state.pt")
    for other in (fresh, b):
        assert other.model._views_updated == (epochs > 0) and other.model._aug_counter == a.model._aug_counter
        for key, view in a.model.views.items():
            mine = other.model.views[key]
            for field in ("row_ptr", "col", "val", "eid"):
                assert torch.equal(getattr(mine, field), getattr(view, field)), (key, field)
    assert torch.equal(a.step(), b.step())
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


@pytest.mark.parametrize("name", ["DOSE_aug", "DOSE_aug_drop2", "TEST"])
def test_attach_dataset_matches_jax(name):
    """5 new users and 4 new items join after an update: the views are
    re-established over the grown set (DOSE_aug_drop2 re-ranks its degree
    tails; TEST draws its main mask anew) and the next update selects the
    same views as JAX's."""
    base = quick_synthetic_dataset(60, 50, 1200, seed=11)
    jm, jp, tm, tp = _pair(_cfg(name), base)
    if name == "TEST":
        _hand_draws_to_jax(tm, jm)
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
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
    tm.attach_dataset(grown)
    jm.attach_dataset(grown)
    assert tm.views["aug_adj"].shape == (grown.n_users + grown.n_items,) * 2
    _assert_views_match(tm, jm)
    if name == "DOSE_aug_drop2":
        np.testing.assert_array_equal(tm._tail_users, jm._tail_users)
        np.testing.assert_array_equal(tm._tail_items, jm._tail_items)
    if name == "TEST":
        np.testing.assert_array_equal(tm._main_keep, jm._main_keep)
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
    _assert_views_match(tm, jm)
    np.testing.assert_allclose(tm.make_scoring_state(tp).numpy(), np.asarray(jm.get_rep(jp)), **TOL)


# -- trainers against optax --------------------------------------------------------


def _feed(monkeypatch, batches):
    """The port trainer's sampler yields the given batches: per step the main
    (users, pos, neg), then the auxiliary ones."""
    it = iter([b for users, pos, neg, au, ap, an in batches for b in ((users, pos, neg), (au, ap, an))])

    def fake(state, generator, batch_size, neg_ratio=1):
        u, p, n = next(it)
        return (torch.as_tensor(u, dtype=torch.int64), torch.as_tensor(p, dtype=torch.int64),
                torch.as_tensor(n, dtype=torch.int64)[:, None])

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)


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


@pytest.mark.parametrize(
    "name, trainer_name", [("DOSE_aug", "DOSEaugTrainer"), ("DOSE_drop3", "DOSEdropTrainer"), ("DOSE_test", "DOSEtestTrainer")]
)
def test_dose_trainer_epochs_match_jax(ds, monkeypatch, name, trainer_name):
    """Two epochs of three steps: each epoch's mean loss, the anneal and the
    views the epoch end selects, and the parameters after, against optax
    Adam on JAX's loss with the same batches."""
    jm, jp, tm, _ = _pair(_cfg(name), ds)
    trainer = get_trainer(_tcfg(trainer_name), ds, tm)
    params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    trainer.steps_per_epoch = 3
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map)
    epochs = _harness().make_batches(np.random.default_rng(8), ds, jm, aux, 2, 3, 128)
    _feed(monkeypatch, [b for e in epochs for b in e])
    optimizer, jstep = _jax_dose_step(jm, 1e-3, 1e-4, 0.01, 0.05)
    opt_state = optimizer.init(jp)
    for batches in epochs:
        losses = []
        for b in batches:
            jp, opt_state, loss = jstep(jp, opt_state, jm.buffers, *map(jnp.asarray, b))
            losses.append(float(loss))
        jm.feat_mat_anneal()
        jm.update_aug_adj(jp)
        np.testing.assert_allclose(trainer.train_one_epoch(), np.mean(losses), rtol=1e-5)
        assert tm.alpha == jm.alpha
        _assert_views_match(tm, jm)
    for k, v in tm.params().items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(v.detach().numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_registry_builds_the_dose_family(ds):
    """get_model builds the 13 variants, the JAX package's, and IGCN at
    feature_ratio < 1, get_trainer the three DOSE trainers; DOSE_aug2 steps
    with DOSEaugTrainer; the reference's DOSE_drop2 + IGCNTrainer pairing
    trains without the contrastive term."""
    assert {"DOSEaugTrainer", "DOSEdropTrainer", "DOSEtestTrainer"} <= set(TRAINERS)
    assert len(DOSE_MODELS) == 13
    assert {cls.__name__ for cls in DOSE_MODELS} == {n for n in JAX_MODELS if n.startswith(("DOSE", "TEST"))}
    aug2 = get_trainer(_tcfg("DOSEaugTrainer"), ds, get_model(_cfg("DOSE_aug2", dropout=0.3), ds, device="cpu"))
    assert torch.isfinite(aug2.step())
    model = get_model(_cfg("DOSE_drop2", feature_ratio=0.8, dropout=0.3), ds, device="cpu")
    assert (model.user_map < 0).sum() > 0
    trainer = get_trainer(_tcfg("IGCNTrainer", n_epochs=1), ds, model)
    assert torch.isfinite(trainer.step())
    assert np.isfinite(trainer.train_one_epoch())


# -- the golden DOSE_aug gate ------------------------------------------------------


def test_golden_dose_aug_end_to_end_against_jax(tmp_path, monkeypatch):
    """The DOSE_aug gate of tests/test_golden_flagships.py:45-55 at its small
    scale, the port against JAX: six epochs of shared batches, each ending in
    the anneal, a selection of the aug_num lowest-cosine pairs and the view
    rebuild; val Recall@20 / NDCG@20 every two epochs."""
    monkeypatch.chdir(tmp_path)
    g = _harness()
    seed, d, n_layers, n_epochs, batch, eval_every, aug_num = 7, 16, 2, 6, 128, 2, 50
    ds = quick_synthetic_dataset(60, 50, 1500, seed=seed)
    cfg = _cfg("DOSE_aug", embedding_size=d, n_layers=n_layers, aug_num=aug_num)
    jm = jax_get_model(cfg, ds)
    tm = get_model(cfg, ds, device="cpu")
    trainer = get_trainer(_tcfg("DOSEaugTrainer", batch_size=batch), ds, tm)
    rng = np.random.default_rng(seed + 1)
    emb0 = (rng.standard_normal((jm.feat_n_cols, d)) * 0.1).astype(np.float32)
    params_from_jax(tm, {"embedding": emb0, "w": np.ones(d, np.float32)})
    jp = {"embedding": jnp.asarray(emb0), "w": jnp.ones((d,), jnp.float32)}
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map)
    epochs = g.make_batches(rng, ds, jm, aux, n_epochs, trainer.steps_per_epoch, batch)
    _feed(monkeypatch, [b for e in epochs for b in e])
    optimizer, jstep = _jax_dose_step(jm, 1e-3, 1e-4, 0.01, 0.05)
    opt_state = optimizer.init(jp)
    j_ev = JaxEvaluator(ds, [20], test_batch_size=256)
    traj = []
    for e, batches in enumerate(epochs):
        for b in batches:
            jp, opt_state, _ = jstep(jp, opt_state, jm.buffers, *map(jnp.asarray, b))
        jm.feat_mat_anneal()
        sel_j = {tuple(p) for p in np.asarray(jm._cos_pairs(jp, aug_num, negate_items=True)).tolist()}
        jm.update_aug_adj(jp)
        trainer.train_one_epoch()
        sel_t = {tuple(p) for p in tm._cos_pairs(trainer.params, aug_num, True).tolist()}
        row = {"epoch": e + 1, "selection_jaccard": len(sel_t & sel_j) / len(sel_t | sel_j)}
        if (e + 1) % eval_every == 0:
            _, ours = trainer.eval("val")
            _, ref = j_ev.evaluate(jm, jp, "val")
            row.update({m: (ours[m][20], ref[m][20]) for m in ("Recall", "NDCG")})
        traj.append(row)
    for row in traj:
        assert row["selection_jaccard"] > 0.7, traj
        for m in ("Recall", "NDCG"):
            if m in row:
                assert abs(row[m][0] - row[m][1]) < 0.03, traj
    assert traj[-1]["Recall"][0] > 0.2, traj
