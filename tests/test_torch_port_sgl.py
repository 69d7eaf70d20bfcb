"""SGL and HALF in the port against the JAX package: the drop views (the
port's keep masks handed to JAX's ``make_view_on_device``, compared as dense
matrices), ``bpr_forward``'s five outputs, two epochs of ``SGLTrainer`` /
``HALFTrainer`` against optax Adam on shared batches with the epoch end's
views, and the bitwise replay of the views through a checkpoint.

torch and JAX random streams never agree, so the port's draws
(``random_keep_mask_on_device``) are recorded and replayed, in order, to the
JAX model. Tolerances: view matrices rtol 1e-6 (the same float64
arithmetic); representations, losses and parameters rtol 1e-5, atol 1e-5
times the JAX side's largest magnitude (fp32 sums in other orders: the view
CSR sums a row's kept edges, JAX the masked base layout); replay bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import inductive_recommendation_tpu.models.sgl as jax_sgl
import inductive_recommendation_tpu_torch.models.sgl as port_sgl
from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.train import trainer as trainer_module

RTOL = 1e-5


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(60, 50, 1500, seed=7)


def _cfg(name, **kw):
    cfg = {"name": name, "embedding_size": 16, "n_layers": 2}
    cfg.update(kw)
    return cfg


def _tcfg(name, **kw):
    cfg = {"name": name, "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "contrastive_reg": 0.1,
           "n_epochs": 2, "batch_size": 128, "test_batch_size": 256, "topks": [20]}
    cfg.update(kw)
    return cfg


def _hand_masks_to_jax(monkeypatch):
    """The port's keep masks are recorded where they are drawn and replayed,
    in order, by the JAX model's draws."""
    queue = []
    port_draw = port_sgl.random_keep_mask_on_device

    def record(counter, **kw):
        keep = port_draw(counter, **kw)
        queue.append(keep.numpy())
        return keep

    def replay(counter, **kw):
        keep = queue.pop(0)
        assert keep.shape == (kw["n_pairs"],) and keep.sum() == kw["n_keep"]
        return jnp.asarray(keep)

    monkeypatch.setattr(port_sgl, "random_keep_mask_on_device", record)
    monkeypatch.setattr(jax_sgl, "random_keep_mask_on_device", replay)
    return queue


def _pair(name, dataset, monkeypatch, **kw):
    queue = _hand_masks_to_jax(monkeypatch)
    tm = get_model(_cfg(name, **kw), dataset, device="cpu")
    jm = jax_get_model(_cfg(name, **kw), dataset)
    assert queue == []
    jp = jm.init_params(jax.random.key(0))
    tp = params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp, queue


def _dense_csr(view):
    out = np.zeros(view.shape)
    rows = np.repeat(np.arange(view.n_rows), np.diff(view.row_ptr.numpy()))
    np.add.at(out, (rows, view.col.numpy()), view.val.numpy())
    return out


def _dense_jax_view(jm, key):
    eng, ev = jm.view_engine, jm.edge_views[key]
    out = np.zeros((eng.n_nodes, eng.n_nodes))
    np.add.at(out, (eng._base_rows, eng._base_cols), np.asarray(ev.base_scale))
    return out


def _assert_views_match(tm, jm):
    assert set(tm.views) == set(jm.edge_views)
    for key, view in tm.views.items():
        np.testing.assert_allclose(_dense_csr(view), _dense_jax_view(jm, key), rtol=1e-6, atol=0, err_msg=key)


@pytest.mark.parametrize("name, n_views", [("SGL", 2), ("HALF", 1)])
def test_views_and_bpr_forward_match_jax(ds, monkeypatch, name, n_views):
    """aug_rate defaults to 0.8; each view keeps exactly int(0.8 n_pairs)
    train pairs and is symmetric; the views equal JAX's from the same masks,
    at init and after an ``update_aug_adj``, which draws new ones; and
    ``bpr_forward``'s five outputs agree (HALF: InfoNCE against the main
    reps)."""
    jm, jp, tm, tp, queue = _pair(name, ds, monkeypatch)
    assert tm.aug_rate == 0.8 and tuple(tm.views) == tuple(f"aug_adj{i + 1}" for i in range(n_views))
    n_pairs = len(tm.view_engine.train_pairs)
    first = dict(tm.views)
    _assert_views_match(tm, jm)
    tm.update_aug_adj(tp)
    jm.update_aug_adj(jp)
    assert queue == [] and tm._view_counter == 2 * n_views
    _assert_views_match(tm, jm)
    for key, view in tm.views.items():
        assert view.symmetric and view.view and view.nnz == 2 * int(0.8 * n_pairs)
        assert not torch.equal(view.col, first[key].col)
        dense = _dense_csr(view)
        np.testing.assert_array_equal(dense, dense.T)
    rng = np.random.default_rng(0)
    users, pos, neg = (rng.integers(0, n, 64) for n in (ds.n_users, ds.n_items, ds.n_items))
    got = tm.bpr_forward(tp, *(torch.as_tensor(a) for a in (users, pos, neg)))
    want = jm.bpr_forward(jp, *(jnp.asarray(a) for a in (users, pos, neg)), training=True, buffers=jm.buffers)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_close(g, w)


def _jax_step(jm, lr, l2_reg, c_reg):
    """One optax Adam step of JAX's SGL loss (trainer.py:485-501)."""
    optimizer = optax.adam(lr)

    def step(params, opt_state, buffers, users, pos, neg):
        def loss_fn(p):
            u_r, p_r, n_r, l2, closs = jm.bpr_forward(p, users, pos, neg, training=True, buffers=buffers)
            return JL.bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean() + c_reg * closs.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return optimizer, jax.jit(step)


@pytest.mark.parametrize("name, trainer_name", [("SGL", "SGLTrainer"), ("HALF", "HALFTrainer")])
def test_trainer_epochs_match_jax(ds, monkeypatch, name, trainer_name):
    """Two epochs of three steps on shared batches: each epoch's mean loss,
    the views the epoch end draws, and the parameters after, against optax
    Adam on JAX's loss."""
    jm, jp, tm, _, queue = _pair(name, ds, monkeypatch)
    trainer = get_trainer(_tcfg(trainer_name), ds, tm)
    params_from_jax(tm, {k: np.asarray(v) for k, v in jp.items()})
    trainer.steps_per_epoch = 3
    rng = np.random.default_rng(8)
    epochs = [[(rng.integers(0, ds.n_users, 128), rng.integers(0, ds.n_items, 128), rng.integers(0, ds.n_items, 128))
               for _ in range(3)] for _ in range(2)]
    it = iter([b for e in epochs for b in e])

    def fake(state, generator, batch_size, neg_ratio=1):
        u, p, n = next(it)
        return torch.as_tensor(u), torch.as_tensor(p), torch.as_tensor(n)[:, None]

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)
    optimizer, jstep = _jax_step(jm, 1e-3, 1e-4, 0.1)
    opt_state = optimizer.init(jp)
    for batches in epochs:
        losses = []
        for b in batches:
            jp, opt_state, loss = jstep(jp, opt_state, jm.buffers, *map(jnp.asarray, b))
            losses.append(float(loss))
        np.testing.assert_allclose(trainer.train_one_epoch(), np.mean(losses), rtol=RTOL)
        jm.update_aug_adj(jp)
        assert queue == []
        _assert_views_match(tm, jm)
    for k, v in tm.params().items():
        assert_close(v, jp[k], err_msg=k)


@pytest.mark.parametrize("name, epochs", [("SGL", 2), ("HALF", 1), ("SGL", 0)])
def test_checkpoint_replays_the_views_bitwise(ds, tmp_path, monkeypatch, name, epochs):
    """save -> load -> rebuild_views gives the saved run's view CSRs bit for
    bit, before and after the first update; a resumed trainer's next step
    equals the uninterrupted run's."""
    monkeypatch.chdir(tmp_path)
    tcfg = _tcfg(f"{name}Trainer", seed=3)
    a = get_trainer(tcfg, ds, get_model(_cfg(name), ds, device="cpu"))
    a.steps_per_epoch = 2
    for _ in range(epochs):
        a.train_one_epoch()
    a._save_model(tmp_path / "best.pt")
    a.save_state(tmp_path / "state.pt")
    fresh = get_trainer(dict(tcfg, seed=11), ds, get_model(_cfg(name), ds, device="cpu"))
    for _ in range(3):  # views of its own first
        fresh.model.update_aug_adj()
    fresh._load_model(tmp_path / "best.pt")
    b = get_trainer(dict(tcfg, seed=11), ds, get_model(_cfg(name), ds, device="cpu"))
    b.load_state(tmp_path / "state.pt")
    for other in (fresh, b):
        assert other.model._views_updated == (epochs > 0) and other.model._view_counter == a.model._view_counter
        for key, view in a.model.views.items():
            mine = other.model.views[key]
            for field in ("row_ptr", "col", "val", "eid"):
                assert torch.equal(getattr(mine, field), getattr(view, field)), (key, field)
    assert torch.equal(a.step(), b.step())
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
