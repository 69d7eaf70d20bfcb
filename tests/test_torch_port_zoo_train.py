"""The port's grid-baseline trainers and the experiment grids against the JAX
package: ``BPRTrainer`` (MF, NGCF, IMCGAE), ``IDCFTrainer``, ``BCETrainer``
and ``MLTrainer`` steps against optax Adam on JAX's losses; ``MLTrainer``'s
batch order and ``BCETrainer``'s phase switches against JAX's trainers;
every row of the five grids built and stepped on the CPU; and NGCF / IMCGAE
trained for two epochs against JAX.

Both sides get the same weights (``params_from_jax``) and the same batches:
the port trainer's sampler is replaced by the shared batches, so its own
step runs. Dropout is 0, or JAX's draws are handed to the port (IDCF's
samples, MultiVAE's mask and noise). Tolerances: losses and parameters rtol
1e-4 / atol 1e-4 · max|param| (fp32 sums in other orders, Adam's update in
other roundings); the two-epoch gate |ΔRecall@20|, |ΔNDCG@20| < 0.005, the
golden IGCN gate's (``tests/test_torch_port_train.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu import get_trainer as jax_get_trainer
from inductive_recommendation_tpu.configs import grids as jax_grids
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.eval.evaluator import Evaluator as JaxEvaluator
from inductive_recommendation_tpu.models import MODELS as JAX_MODELS
from inductive_recommendation_tpu.train import TRAINERS as JAX_TRAINERS
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.configs import grids
from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset as port_quick_synthetic_dataset
from inductive_recommendation_tpu_torch.models import MODELS, flatten_params, params_from_jax
from inductive_recommendation_tpu_torch.train import TRAINERS, save_checkpoint
from inductive_recommendation_tpu_torch.train import trainer as trainer_module

D = 16
GRIDS = ("get_gowalla_config", "get_yelp_config", "get_amazon_config", "get_alibaba_config", "get_ml_config")


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(60, 50, 1500, seed=7)


def _tcfg(name, **kw):
    cfg = {"name": name, "optimizer": "Adam", "lr": 1e-2, "l2_reg": 1e-3, "contrastive_reg": 0.1, "kl_reg": 0.2,
           "mf_pretrain_epochs": 1, "mlp_pretrain_epochs": 1, "n_epochs": 4, "batch_size": 64,
           "test_batch_size": 64, "topks": [20]}
    cfg.update(kw)
    return cfg


def _mcfg(name, dataset=None):
    return {
        "MF": {"name": "MF", "embedding_size": D},
        "NGCF": {"name": "NGCF", "embedding_size": D, "layer_sizes": [D, D], "dropout": 0.0},
        "IMCGAE": {"name": "IMCGAE", "embedding_size": D, "n_layers": 2, "dropout": 0.0},
        "MultiVAE": {"name": "MultiVAE", "layer_sizes": [D, 8], "dropout": 0.5},
        "NeuMF": {"name": "NeuMF", "embedding_size": D, "layer_sizes": [D, D, 8]},
        "IDCF_LGCN": {"name": "IDCF_LGCN", "embedding_size": D, "n_layers": 2, "n_headers": 2, "n_samples": 10,
                      "pretrained_embedding": np.random.default_rng(3).normal(
                          0.0, 0.1, (dataset.n_users + dataset.n_items, D)).astype(np.float32)
                      if dataset is not None else None},
    }[name]


def _setup(name, trainer_name, dataset, **tkw):
    """(jax model, jax params, port model, port trainer) with equal weights."""
    cfg = _mcfg(name, dataset)
    jm = jax_get_model(cfg, dataset)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(cfg, dataset, device="cpu")
    trainer = get_trainer(_tcfg(trainer_name, **tkw), dataset, tm)
    params_from_jax(tm, jp)
    return jm, jp, tm, trainer


def _batches(dataset, n_steps, batch, neg_ratio=1, seed=8):
    """Shared (users, pos [B], neg [B, neg_ratio]) batches: users with a
    train item, one of their items, uniform negatives."""
    rng = np.random.default_rng(seed)
    have = np.flatnonzero([len(t) > 0 for t in dataset.train_data])
    out = []
    for _ in range(n_steps):
        users = have[rng.integers(0, len(have), batch)]
        pos = np.array([dataset.train_data[u][rng.integers(0, len(dataset.train_data[u]))] for u in users])
        out.append((users, pos, rng.integers(0, dataset.n_items, (batch, neg_ratio))))
    return out


def _feed(monkeypatch, batches):
    it = iter(batches)

    def fake(state, generator, batch_size, neg_ratio=1):
        users, pos, neg = next(it)
        assert neg.shape == (batch_size, neg_ratio)
        return tuple(torch.as_tensor(a, dtype=torch.int64) for a in (users, pos, neg))

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)


def _jax_idcf_samples(jm, rng):
    """JAX's per-head draws (``idcf.py:103-106``) as the port's int64
    [n_headers, 2, n_samples]."""
    heads = []
    for _ in range(jm.n_headers):
        rng, r_u, r_i = jax.random.split(rng, 3)
        su = jax.random.randint(r_u, (jm.n_samples,), 0, jm.n_old_users)
        si = jax.random.randint(r_i, (jm.n_samples,), 0, jm.n_old_items)
        heads.append(np.stack([np.asarray(su), np.asarray(si)]))
    return torch.as_tensor(np.stack(heads), dtype=torch.int64)


def _adam_steps(loss_fn, jp, batches, lr):
    """optax Adam steps of ``loss_fn(params, *batch)``; -> (losses, params)."""
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(jp)

    @jax.jit
    def step(params, opt_state, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for b in batches:
        jp, opt_state, loss = step(jp, opt_state, *map(jnp.asarray, b))
        losses.append(float(loss))
    return losses, jp


def _assert_params(tm, jp, skip=()):
    for name, leaf in flatten_params(jp).items():
        if name.endswith(skip):
            continue
        want = np.asarray(leaf)
        got = tm.params()[name].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-4), err_msg=name)


# -- trainer steps against optax -------------------------------------------------------


@pytest.mark.parametrize("name", ["MF", "NGCF", "IMCGAE"])
def test_bpr_trainer_steps_match_optax(ds, monkeypatch, name):
    jm, jp, tm, trainer = _setup(name, "BPRTrainer", ds)
    batches = _batches(ds, 3, 64)
    _feed(monkeypatch, batches)

    def loss_fn(p, users, pos, neg):
        u, pr, nr, l2 = jm.bpr_forward(p, users, pos, neg[:, 0], training=False)
        return JL.bpr_loss(u, pr, nr) + 1e-3 * l2.mean()

    losses, jp = _adam_steps(loss_fn, jp, batches, 1e-2)
    got = [trainer.step().item() for _ in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    _assert_params(tm, jp)


def test_idcf_trainer_steps_match_optax(ds, monkeypatch):
    """BPR + L2 + contrastive_reg · mean contrastive term; the port's model
    samples what JAX's does at ``rng=None`` (``jax.random.key(0)``)."""
    jm, jp, tm, trainer = _setup("IDCF_LGCN", "IDCFTrainer", ds)
    samples = _jax_idcf_samples(jm, jax.random.key(0))
    monkeypatch.setattr(tm, "draw_samples", lambda generator=None: samples)
    batches = _batches(ds, 3, 64)
    _feed(monkeypatch, batches)

    def loss_fn(p, users, pos, neg):
        u, pr, nr, l2, c = jm.bpr_forward(p, users, pos, neg[:, 0], training=False)
        return JL.bpr_loss(u, pr, nr) + 1e-3 * l2.mean() + 0.1 * c.mean()

    losses, jp = _adam_steps(loss_fn, jp, batches, 1e-2)
    got = [trainer.step().item() for _ in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    # a key bias shifts every logit of a softmax row alike: its gradient is
    # analytically 0 and computed as rounding noise, which Adam's
    # normalization turns into steps of +-lr on either side
    _assert_params(tm, jp, skip=(".wk.b",))


@pytest.mark.parametrize("arch", ["gmf", "mlp", "neumf"])
def test_bce_trainer_steps_match_optax(monkeypatch, arch):
    """One positive and neg_ratio = 3 negatives a user, the dataset's
    ``neg_ratio``; softplus BCE + L2 in each architecture."""
    ds = port_quick_synthetic_dataset(60, 50, 1500, seed=7, neg_ratio=3)
    jm, jp, tm, trainer = _setup("NeuMF", "BCETrainer", ds)
    assert trainer.neg_ratio == 3
    tm.arch = arch
    batches = _batches(ds, 3, 64, neg_ratio=3)
    _feed(monkeypatch, batches)

    def loss_fn(p, users, pos, neg):
        lp, l2p = jm.bce_forward(p, users, pos, arch=arch)
        ln, l2n = jm.bce_forward(p, jnp.repeat(users, 3), neg.reshape(-1), arch=arch)
        return JL.bce_losses(lp, ln).mean() + 1e-3 * jnp.concatenate([l2p, l2n]).mean()

    losses, jp = _adam_steps(loss_fn, jp, batches, 1e-2)
    got = [trainer.step().item() for _ in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    _assert_params(tm, jp)


def test_ml_trainer_steps_match_optax(ds, monkeypatch):
    """Multinomial likelihood + the annealed KL + L2 on padded batches, with
    JAX's dropout mask and noise handed to the port's ``ml_forward``."""
    jm, jp, tm, trainer = _setup("MultiVAE", "MLTrainer", ds, batch_size=32)
    trainer.epoch = 1  # KL weight min(0.2, 1 / 4)
    kl_w = trainer.kl_weight()
    assert kl_w == 0.2
    batches = trainer.batches(0)
    rngs = [jax.random.key(20 + i) for i in range(len(batches))]
    draws = []
    for (users, _, _), rng in zip(batches, rngs):
        sub_rng, sub = jax.random.split(rng)
        keep = np.array(jax.random.uniform(sub, (users.shape[0], ds.n_items)) >= jm.dropout)
        eps = np.array(jax.random.normal(sub_rng, (users.shape[0], jm.mid_size)))
        draws.append((torch.as_tensor(keep), torch.as_tensor(eps)))
    it = iter(draws)
    real = tm.ml_forward
    monkeypatch.setattr(tm, "ml_forward", lambda *a, **kw: real(*a, **dict(zip(("keep", "eps"), next(it))), **kw))

    def loss_fn(p, users, valid, rng):
        scores, kl, l2 = jm.ml_forward(p, users, rng=rng, training=True)
        prof = jm._profiles(jm.buffers, users, normalized=False)
        return (JL.multinomial_ll_loss(scores, prof, valid=valid) + kl_w * jnp.sum(kl * valid) / valid.sum()
                + 1e-3 * l2.mean())

    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(jp)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for (users, valid, n), rng in zip(batches, rngs):
        loss, grads = grad_fn(jp, jnp.asarray(users.numpy()), jnp.asarray(valid.numpy()), rng)
        updates, opt_state = optimizer.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(trainer.step(users, valid).item(), float(loss), rtol=1e-4)
    _assert_params(tm, jp)
    assert batches[-1][2] == ds.n_users - 32 and float(batches[-1][1].sum()) == batches[-1][2]


# -- trainer mechanics against the JAX trainers -------------------------------------------


def test_ml_trainer_batch_order_equals_jax(ds, monkeypatch, tmp_path):
    """The users and valid weights of every batch of epochs 0 and 1, as JAX's
    MLTrainer feeds them to its step."""
    monkeypatch.chdir(tmp_path)
    cfg = _tcfg("MLTrainer", batch_size=16, seed=5)
    jt = jax_get_trainer(cfg, ds, jax_get_model(_mcfg("MultiVAE"), ds))
    seen = []

    def record(params, opt_state, buffers, users, valid, kl, step_seed):
        seen.append((np.asarray(users), np.asarray(valid)))
        return params, opt_state, jnp.float32(0.0)

    jt._step = record
    tt = get_trainer(cfg, ds, get_model(_mcfg("MultiVAE"), ds, device="cpu"))
    for epoch in (0, 1):
        jt.epoch = epoch
        seen.clear()
        jt.train_one_epoch()
        ours = tt.batches(epoch)
        assert len(ours) == len(seen) == tt.steps_per_epoch
        for (u, v, n), (ju, jv) in zip(ours, seen):
            np.testing.assert_array_equal(u.numpy(), ju)
            np.testing.assert_array_equal(v.numpy(), jv)
            assert n == int(jv.sum())


def test_bce_trainer_phase_switches_match_jax(ds, monkeypatch, tmp_path):
    """With mf/mlp pretraining of 2 and 1 epochs, both trainers train gmf,
    gmf, mlp, neumf, reload the phase's best checkpoint at each switch
    (before switching: the checkpoint holds the arch it was saved in), and
    the port persists the arch through save_state / load_state."""
    monkeypatch.chdir(tmp_path)
    cfg = _tcfg("BCETrainer", mf_pretrain_epochs=2, mlp_pretrain_epochs=1, n_epochs=4, max_patience=10)
    ndcgs = [0.5, 0.4, 0.3, 0.2]

    # JAX: real phase logic, steps replaced by a recorder of the arch
    jt = jax_get_trainer(cfg, ds, jax_get_model(_mcfg("NeuMF"), ds))
    j_archs, j_loads = [], []

    def make_step(arch):
        def step(params, opt_state, sampler, step_seed):
            j_archs.append(arch)
            return params, opt_state, jnp.float32(0.0)

        return step

    monkeypatch.setattr(jt, "_make_step", make_step)
    scores = iter(ndcgs)
    monkeypatch.setattr(jt, "eval", lambda stage, banned_items=None: ("", {"NDCG": {20: next(scores)}}))
    real_jload = jt._load_model
    monkeypatch.setattr(jt, "_load_model", lambda path: (j_loads.append(jt.epoch), real_jload(path)))
    jt.steps_per_epoch = 1
    jt.train(verbose=False)

    # the port: real steps
    tt = get_trainer(cfg, ds, get_model(_mcfg("NeuMF"), ds, device="cpu"))
    tt.steps_per_epoch = 2
    t_archs, t_loads, saved = [], [], {}
    scores = iter(ndcgs)
    monkeypatch.setattr(tt, "eval", lambda stage, banned_items=None: ("", {"NDCG": {20: next(scores)}}))
    real_load, real_save, real_step = tt._load_model, tt._save_model, tt.step

    def load(path):
        t_loads.append(tt.epoch)
        real_load(path)
        for k, v in tt.params.items():  # the phase's best, as saved
            np.testing.assert_array_equal(v.detach().numpy(), saved[path][k])

    def save(path):
        saved[path] = {k: v.detach().numpy().copy() for k, v in tt.params.items()}
        real_save(path)

    def step():
        t_archs.append(tt.model.arch)
        return real_step()

    monkeypatch.setattr(tt, "_load_model", load)
    monkeypatch.setattr(tt, "_save_model", save)
    monkeypatch.setattr(tt, "step", step)
    tt.train(verbose=False)
    assert j_archs == ["gmf", "gmf", "mlp", "neumf"]
    assert t_archs[::2] == t_archs[1::2] == j_archs
    # the switches' reloads, then the final reload of the best
    assert t_loads == j_loads == [2, 3, 4]
    tt.save_state(tmp_path / "state.pt")
    fresh = get_trainer(cfg, ds, get_model(_mcfg("NeuMF"), ds, device="cpu"))
    assert fresh.model.arch == "gmf"
    fresh.load_state(tmp_path / "state.pt")
    assert fresh.model.arch == "neumf" and fresh.epoch == 4


# -- registry, grids, every grid row ------------------------------------------------------


@pytest.mark.parametrize(
    "name, trainer_name", [("AttIGCN", "IGCNTrainer"), ("SGL", "SGLTrainer"), ("HALF", "HALFTrainer"),
                           ("DOSE_aug2", "DOSEaugTrainer")]
)
def test_registry_covers_the_grids(name, trainer_name):
    """The port holds every JAX model and every JAX trainer; each of the
    four models ported last builds and steps once on the CPU with its
    trainer."""
    assert set(JAX_MODELS) == set(MODELS)
    assert set(JAX_TRAINERS) == set(TRAINERS)
    ds = port_quick_synthetic_dataset(40, 30, 600, seed=1)
    cfg = {"name": name, "embedding_size": 8, "n_layers": 2, "dropout": 0.1, "feature_ratio": 1.0, "n_heads": 2,
           "aug_num": 20}
    trainer = get_trainer({"name": trainer_name, "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
                           "contrastive_reg": 0.1, "n_epochs": 1, "batch_size": 64, "topks": [20]},
                          ds, get_model(cfg, ds, device="cpu"))
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    assert torch.isfinite(trainer.step())
    assert any(not torch.equal(before[k], v) for k, v in trainer.params.items())


@pytest.mark.parametrize("fn", GRIDS)
def test_grids_equal_jax(fn):
    for device in (None, "cuda"):
        assert getattr(grids, fn)(device) == getattr(jax_grids, fn)(device)


ROWS = [(fn, i) for fn in GRIDS for i in range(len(getattr(grids, fn)()))]


@pytest.mark.parametrize("fn, i", ROWS)
def test_every_grid_row_builds_and_steps(fn, i, tmp_path, monkeypatch):
    """The row's model and trainer at the grid's widths on a tiny set, built
    with ``device="cpu"``: one step (a finite loss that moves the
    parameters), or for an eval-only row ``train`` (one validation)."""
    monkeypatch.chdir(tmp_path)
    dataset_cfg, model_cfg, trainer_cfg = getattr(grids, fn)()[i]
    ds = port_quick_synthetic_dataset(40, 30, 600, seed=i, neg_ratio=dataset_cfg.get("neg_ratio", 1))
    model_cfg = dict(model_cfg)
    if model_cfg["name"] == "IDCF_LGCN":
        model_cfg.pop("lgcn_path")
        d = model_cfg["embedding_size"]
        model_cfg["pretrained_embedding"] = np.random.default_rng(i).normal(0, 0.1, (70, d)).astype(np.float32)
    trainer = get_trainer(dict(trainer_cfg, batch_size=min(trainer_cfg.get("batch_size", 64), 64)), ds,
                          get_model(model_cfg, ds, device="cpu"))
    if not trainer.model.trainable:
        ndcg = trainer.train(verbose=False)
        assert 0.0 <= ndcg <= 1.0
        return
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    # MLTrainer takes its batch: the epoch's first
    batch = trainer.batches(0)[0][:2] if hasattr(trainer, "batches") else ()
    assert torch.isfinite(trainer.step(*batch))
    assert any(not torch.equal(before[k], v) for k, v in trainer.params.items())


def test_non_trainable_train_validates_once(ds):
    model = get_model({"name": "Popularity"}, ds, device="cpu")
    trainer = get_trainer({"name": "BasicTrainer", "n_epochs": 0, "topks": [1, 5, 10, 15, 20, 25, 30]}, ds, model)
    _, metrics = trainer.eval("val")
    assert trainer.train(verbose=False) == metrics["NDCG"][25]


def test_idcf_reads_a_port_lightgcn_checkpoint(ds, tmp_path):
    """``lgcn_path`` names a LightGCN checkpoint written by the port's
    ``save_checkpoint``; its table becomes the frozen buffer. A table of
    another shape raises."""
    lgcn = get_model({"name": "LightGCN", "embedding_size": D, "n_layers": 2}, ds, device="cpu")
    save_checkpoint(tmp_path / "lgcn.pt", lgcn.params())
    cfg = dict(_mcfg("IDCF_LGCN", ds), lgcn_path=str(tmp_path / "lgcn.pt"))
    cfg.pop("pretrained_embedding")
    model = get_model(cfg, ds, device="cpu")
    assert torch.equal(model.frozen_embedding, lgcn.params()["embedding"].detach())
    with pytest.raises(ValueError, match="shape"):
        get_model(dict(cfg, embedding_size=8, lgcn_path=None, pretrained_embedding=np.zeros((3, 8))), ds, device="cpu")


# -- the slice as a whole ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["NGCF", "IMCGAE"])
def test_two_epochs_against_jax(tmp_path, monkeypatch, name):
    """Two epochs of shared batches at dropout 0, BPRTrainer against optax on
    JAX's loss: val Recall@20 and NDCG@20 agree within 0.005."""
    monkeypatch.chdir(tmp_path)
    ds = quick_synthetic_dataset(60, 50, 1500, seed=7)
    jm, jp, tm, trainer = _setup(name, "BPRTrainer", ds, lr=1e-2, l2_reg=1e-4)
    batches = _batches(ds, 2 * trainer.steps_per_epoch, 64, seed=11)
    _feed(monkeypatch, batches)

    def loss_fn(p, users, pos, neg):
        u, pr, nr, l2 = jm.bpr_forward(p, users, pos, neg[:, 0], training=False)
        return JL.bpr_loss(u, pr, nr) + 1e-4 * l2.mean()

    _, jp = _adam_steps(loss_fn, jp, batches, 1e-2)
    _, init = trainer.eval("val")
    for _ in range(2):
        trainer.train_one_epoch()
    _, ours = trainer.eval("val")
    _, ref = JaxEvaluator(ds, [20], test_batch_size=64).evaluate(jm, jp, "val")
    for m in ("Recall", "NDCG"):
        assert abs(ours[m][20] - ref[m][20]) < 0.005, (m, ours[m][20], ref[m][20])
    assert ours["NDCG"][20] > init["NDCG"][20]
