"""The PyTorch port's training path against the JAX package: the losses, the
BPR sampler, the trainers' steps, an end-to-end IGCN run, checkpoints and
early stopping.

Both sides get the same inputs from numpy seeds and the same batches (the
port's sampler is replaced by the batches of
``benchmarks/golden_parity_flagships.py::make_batches``, so the trainer's
own step runs), at dropout 0: torch and JAX random streams never agree. The
sampler is tested on its properties and its distribution. Tolerances: loss
and parameters rtol 1e-5 (fp32 sums in different orders, Adam's update in
different roundings); metrics 0.005 absolute, the gate of
``tests/test_golden_flagships.py``."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.stats import chisquare

from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu.data.dataset import AuxiliaryDataset as JaxAuxiliaryDataset
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.eval.evaluator import Evaluator as JaxEvaluator
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.data import AuxiliaryDataset, build_sampler_state, sample_bpr_batch
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.train import aux_bpr_w, bpr_loss
from inductive_recommendation_tpu_torch.train import trainer as trainer_module

RTOL = 1e-5


def _harness():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "golden_parity_flagships.py")
    spec = importlib.util.spec_from_file_location("golden_flagships", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_cfg(name, d=16, n_layers=2):
    cfg = {"name": name, "embedding_size": d, "n_layers": n_layers}
    if name == "IGCN":
        cfg.update(dropout=0.0, feature_ratio=1.0)
    return cfg


def _trainer_cfg(name, **kw):
    cfg = {"name": name, "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
           "n_epochs": 4, "batch_size": 128, "test_batch_size": 256, "topks": [20]}
    cfg.update(kw)
    return cfg


# -- losses ---------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    u, p, n = (rng.standard_normal((64, 16)).astype(np.float32) for _ in range(3))
    emb = rng.standard_normal((30, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    au, ap, an = rng.integers(0, 12, 64), rng.integers(0, 18, 64), rng.integers(0, 18, 64)

    t_args = [torch.as_tensor(a).requires_grad_(True) for a in (u, p, n)]
    loss = bpr_loss(*t_args)
    loss.backward()
    j_loss, j_grads = jax.value_and_grad(lambda *a: JL.bpr_loss(*a), argnums=(0, 1, 2))(*map(jnp.asarray, (u, p, n)))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    for t, g in zip(t_args, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=1e-8)

    t_emb, t_w = torch.as_tensor(emb).requires_grad_(True), torch.as_tensor(w).requires_grad_(True)
    ids = [torch.as_tensor(a) for a in (au, ap, an)]
    loss = aux_bpr_w(t_emb, t_w, *ids, 12)
    loss.backward()
    j_loss, (g_emb, g_w) = jax.value_and_grad(
        lambda e, ww: JL.aux_bpr_w(e, ww, jnp.asarray(au), jnp.asarray(ap), jnp.asarray(an), 12), argnums=(0, 1)
    )(jnp.asarray(emb), jnp.asarray(w))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    np.testing.assert_allclose(t_emb.grad.numpy(), np.asarray(g_emb), rtol=RTOL, atol=1e-8)
    np.testing.assert_allclose(t_w.grad.numpy(), np.asarray(g_w), rtol=RTOL, atol=1e-8)


def test_auxiliary_dataset_matches_jax():
    ds = quick_synthetic_dataset(80, 60, 900, seed=3)
    user_map = np.full(ds.n_users, -1)
    item_map = np.full(ds.n_items, -1)
    rng = np.random.default_rng(1)
    user_map[rng.permutation(ds.n_users)[:50]] = np.arange(50)
    item_map[rng.permutation(ds.n_items)[:40]] = np.arange(40)
    port, ref = AuxiliaryDataset(ds, user_map, item_map), JaxAuxiliaryDataset(ds, user_map, item_map)
    assert (port.n_users, port.n_items, len(port)) == (ref.n_users, ref.n_items, len(ref))
    assert port.train_data == ref.train_data
    np.testing.assert_array_equal(port.train_array, np.asarray(ref.train_array).reshape(-1, 2))


# -- sampler --------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(
    st.integers(1, 30),
    st.lists(st.lists(st.integers(0, 29), max_size=12), min_size=1, max_size=25),
    st.booleans(),
    st.integers(0, 2**31 - 1),
)
def test_sampler_properties(n_items, lists, full_user, seed):
    """Users only among those with a train item, positives among the user's
    items, negatives never among them, every id in the catalog; a user who
    holds the whole catalog gets the clamped id n_items - 1."""
    train = [[i % n_items for i in items] for items in lists]  # duplicates included
    if full_user:
        train.append(list(range(n_items)))
    if not any(train):
        train[0] = [0]
    state = build_sampler_state(train, n_items)
    gen = torch.Generator().manual_seed(seed)
    users, pos, neg = sample_bpr_batch(state, gen, 256, neg_ratio=3)
    assert users.shape == pos.shape == (256,) and neg.shape == (256, 3)
    for u, p, ns in zip(users.tolist(), pos.tolist(), neg.tolist()):
        own = set(train[u])
        assert own and p in own
        for n in ns:
            assert 0 <= n < n_items
            assert n not in own if len(own) < n_items else n == n_items - 1


def test_sampler_distribution():
    """Chi-square of the negatives (and positives) of a small user against
    the uniform over its non-positive (positive) items; p-values at a fixed
    seed."""
    n_items = 40
    positives = [3, 7, 8, 20, 39]
    state = build_sampler_state([positives, [], [0, 1]], n_items)
    users, pos, neg = sample_bpr_batch(state, torch.Generator().manual_seed(0), 20000, neg_ratio=4)
    mine = users == 0
    assert set(users.tolist()) == {0, 2}
    negs = neg[mine].flatten().numpy()
    allowed = np.setdiff1d(np.arange(n_items), positives)
    assert np.isin(negs, allowed).all()
    assert chisquare(np.bincount(negs, minlength=n_items)[allowed]).pvalue > 1e-3
    assert chisquare(np.bincount(pos[mine].numpy(), minlength=n_items)[positives]).pvalue > 1e-3
    assert abs(mine.double().mean().item() - 0.5) < 0.02


def test_sampler_refuses_an_empty_set():
    with pytest.raises(ValueError, match="nothing to sample"):
        build_sampler_state([[], []], 5)


# -- trainer steps against JAX ---------------------------------------------------


def _feed(monkeypatch, batches, with_aux=True):
    """The port trainer's sampler yields the given batches: per step the main
    (users, pos, neg) then, with ``with_aux``, the auxiliary ones."""
    queue = []
    for users, pos, neg, au, ap, an in batches:
        queue.append((users, pos, neg))
        if with_aux:
            queue.append((au, ap, an))
    it = iter(queue)

    def fake(state, generator, batch_size, neg_ratio=1):
        u, p, n = next(it)
        return torch.as_tensor(u, dtype=torch.int64), torch.as_tensor(p, dtype=torch.int64), torch.as_tensor(n, dtype=torch.int64)[:, None]

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)
    return it


def _jax_step(jm, lr, l2_reg, aux_reg, igcn):
    """One optax Adam step of JAX's loss (golden_parity_flagships.py:311-331)."""
    optimizer = optax.adam(lr)

    def step(params, opt_state, buffers, users, pos, neg, au, ap, an):
        def loss_fn(p):
            u_r, p_r, n_r, l2 = jm.bpr_forward(p, users, pos, neg, training=False, buffers=buffers)
            loss = JL.bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean()
            if igcn:
                loss = loss + aux_reg * JL.aux_bpr_w(p["embedding"], p["w"], au, ap, an, jm.user_dim)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return optimizer, jax.jit(step)


def _setup(name, trainer_name, ds, monkeypatch, **tkw):
    jm = jax_get_model(_model_cfg(name), ds)
    tm = get_model(_model_cfg(name), ds, device="cpu")
    trainer = get_trainer(_trainer_cfg(trainer_name, **tkw), ds, tm)
    jp = jm.init_params(jax.random.key(0))
    params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, trainer


@pytest.mark.parametrize("name, trainer_name", [("IGCN", "IGCNTrainer"), ("LightGCN", "BPRTrainer")])
def test_trainer_steps_match_jax(name, trainer_name, monkeypatch):
    """Three steps of the port's trainer against optax Adam on JAX's loss:
    the loss of every step and the parameters after the last."""
    ds = quick_synthetic_dataset(60, 50, 1500, seed=7)
    jm, jp, tm, trainer = _setup(name, trainer_name, ds, monkeypatch)
    igcn = name == "IGCN"
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map) if igcn else JaxAuxiliaryDataset(
        ds, np.arange(ds.n_users), np.arange(ds.n_items)
    )
    batches = _harness().make_batches(np.random.default_rng(8), ds, jm if igcn else _DimsOf(ds), aux, 1, 3, 128)[0]
    _feed(monkeypatch, batches, with_aux=igcn)
    optimizer, jstep = _jax_step(jm, 1e-3, 1e-4, 0.01, igcn)
    opt_state = optimizer.init(jp)
    for b in batches:
        jp, opt_state, j_loss = jstep(jp, opt_state, jm.buffers, *map(jnp.asarray, b))
        loss = trainer.step()
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=RTOL)
    for k, v in tm.params().items():
        want = np.asarray(jp[k])
        np.testing.assert_allclose(v.detach().numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


class _DimsOf:
    """What make_batches reads of a model: the number of core items."""

    def __init__(self, ds):
        self.item_dim = ds.n_items


def test_golden_igcn_end_to_end_against_jax(tmp_path, monkeypatch):
    """The IGCN gate of tests/test_golden_flagships.py:33-42 at its small
    scale, the port against JAX: four epochs of shared batches with the
    anneal at every epoch end, val Recall@20 / NDCG@20 every two epochs."""
    monkeypatch.chdir(tmp_path)
    g = _harness()
    seed, d, n_layers, n_epochs, batch, eval_every = 7, 16, 2, 4, 128, 2
    ds = quick_synthetic_dataset(60, 50, 1500, seed=seed)
    cfg = _model_cfg("IGCN", d, n_layers)
    jm = jax_get_model(cfg, ds)
    tm = get_model(cfg, ds, device="cpu")
    trainer = get_trainer(_trainer_cfg("IGCNTrainer", batch_size=batch), ds, tm)
    rng = np.random.default_rng(seed + 1)
    emb0 = (rng.standard_normal((jm.feat_n_cols, d)) * 0.1).astype(np.float32)
    params_from_jax(tm, {"embedding": emb0, "w": np.ones(d, np.float32)})
    jp = {"embedding": jnp.asarray(emb0), "w": jnp.ones((d,), jnp.float32)}
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map)
    epochs = g.make_batches(rng, ds, jm, aux, n_epochs, trainer.steps_per_epoch, batch)
    _feed(monkeypatch, [b for e in epochs for b in e])
    optimizer, jstep = _jax_step(jm, 1e-3, 1e-4, 0.01, True)
    opt_state = optimizer.init(jp)
    j_ev = JaxEvaluator(ds, [20], test_batch_size=256)
    traj = []
    for e, batches in enumerate(epochs):
        for b in batches:
            jp, opt_state, _ = jstep(jp, opt_state, jm.buffers, *map(jnp.asarray, b))
        jm.feat_mat_anneal()
        trainer.train_one_epoch()
        assert tm.alpha == jm.alpha
        if (e + 1) % eval_every == 0:
            _, ours = trainer.eval("val")
            _, ref = j_ev.evaluate(jm, jp, "val")
            traj.append({m: (ours[m][20], ref[m][20]) for m in ("Recall", "NDCG")})
    for row in traj:
        for m, (ours, ref) in row.items():
            assert abs(ours - ref) < 0.005, traj
    assert traj[-1]["Recall"][0] > 0.2, traj


# -- checkpoints and early stopping ----------------------------------------------


def _small_trainer(**kw):
    ds = quick_synthetic_dataset(60, 50, 1500, seed=7)
    model = get_model(dict(_model_cfg("IGCN"), dropout=0.3), ds, device="cpu")
    return get_trainer(_trainer_cfg("IGCNTrainer", **kw), ds, model)


def test_save_state_load_state_round_trip(tmp_path, monkeypatch):
    """A resumed trainer holds the same weights, Adam moments, counters and
    random streams, so its next step equals the uninterrupted run's."""
    monkeypatch.chdir(tmp_path)
    a = _small_trainer(n_epochs=2, seed=3)
    a.train(verbose=False)
    assert a.epoch == 2 and os.path.exists(a.save_path) and a.save_path.startswith("checkpoints")
    a.save_state(tmp_path / "state.pt")
    b = _small_trainer(n_epochs=2, seed=11)
    b.load_state(tmp_path / "state.pt")
    assert (b.epoch, b.best_ndcg, b.save_path, b.patience, b.model.alpha) == (
        a.epoch, a.best_ndcg, a.save_path, a.patience, a.model.alpha
    )
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][key], sb[i][key]) for i in sa for key in sa[i])
    la, lb = a.step(), b.step()
    assert torch.equal(la, lb)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_early_stopping_reloads_the_best_checkpoint(tmp_path, monkeypatch):
    """Validation NDCG falls after the first epoch: with max_patience 1 the run
    stops after two epochs and ends on the first epoch's checkpoint, whose
    alpha carries that epoch's one anneal."""
    monkeypatch.chdir(tmp_path)
    t = _small_trainer(n_epochs=6, max_patience=1, topks=[1, 5, 10, 15, 20])
    ndcgs = iter([0.5, 0.4, 0.3])
    saved = {}
    real_save = t._save_model

    def fake_eval(stage, banned_items=None):
        v = next(ndcgs)
        return "", {"NDCG": {k: v for k in t.topks}}

    def save(path):
        saved[path] = {k: v.detach().clone() for k, v in t.params.items()}
        real_save(path)

    monkeypatch.setattr(t, "eval", fake_eval)
    monkeypatch.setattr(t, "_save_model", save)
    assert t.train(verbose=False) == 0.5
    assert t.epoch == 2 and t.model.alpha == 0.99
    assert os.listdir("checkpoints") == [os.path.basename(t.save_path)] and list(saved) == [t.save_path]
    for k, v in saved[t.save_path].items():
        assert torch.equal(t.params[k], v)
