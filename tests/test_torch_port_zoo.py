"""The port's grid baselines against the JAX package: MF, NGCF, IMCGAE,
IDCF_LGCN, ItemKNN, Popularity, MultiVAE and NeuMF, their dropout draws,
``dense_profiles``, nested ``params_from_jax`` and the datasets'
``neg_ratio``.

Both sides get the same weights (``params_from_jax`` of the JAX pytree) and
the same inputs from numpy seeds. Random draws never agree between torch and
JAX, so training-mode paths run at dropout 0, or with JAX's draws handed to
the port (IDCF's samples, MultiVAE's mask and noise); NGCF's edge dropout is
checked by its properties. Tolerances: forward outputs rtol 1e-5 / atol
1e-5, gradients rtol 1e-4 / atol 1e-4 · max(max|grad|, 1e-4) (fp32 sums in
other orders; IDCF's key biases have an analytically zero gradient, which
both sides compute as rounding noise), ItemKNN's similarity values and
scores 1e-6 absolute."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inductive_recommendation_tpu import get_model as jax_get_model
from inductive_recommendation_tpu.data.dataset import BasicDataset as JaxBasicDataset
from inductive_recommendation_tpu.data.dataset import device_padded_from_lists as jax_device_padded_from_lists
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.ops import spmm_bucketed
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu.utils.profiles import dense_profiles as jax_dense_profiles
from inductive_recommendation_tpu_torch import get_model
from inductive_recommendation_tpu_torch.data import ProcessedDataset, device_padded_from_lists
from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset as port_quick_synthetic_dataset
from inductive_recommendation_tpu_torch.models import flatten_params, params_from_jax, placement as placement_module
from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_values
from inductive_recommendation_tpu_torch.ops.dropout import node_dropout_mask, sparse_dropout
from inductive_recommendation_tpu_torch.train import bce_losses, bpr_loss, multinomial_ll_loss
from inductive_recommendation_tpu_torch.utils.profiles import dense_profiles

TOL = dict(rtol=1e-5, atol=1e-5)
D = 16

CONFIGS = {
    "MF": {"name": "MF", "embedding_size": D},
    "NGCF": {"name": "NGCF", "embedding_size": D, "layer_sizes": [D, D], "dropout": 0.0},
    "IMCGAE": {"name": "IMCGAE", "embedding_size": D, "n_layers": 2, "dropout": 0.3},
    "Popularity": {"name": "Popularity"},
    "MultiVAE": {"name": "MultiVAE", "layer_sizes": [D, 8], "dropout": 0.5},
    "NeuMF": {"name": "NeuMF", "embedding_size": D, "layer_sizes": [D, D, 8]},
}


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(120, 90, 2500, seed=0)


def _pair(cfg, dataset, seed=0):
    jm = jax_get_model(cfg, dataset)
    jp = jm.init_params(jax.random.key(seed))
    tm = get_model(cfg, dataset, device="cpu")
    return jm, jp, tm, params_from_jax(tm, jp)


def _pretrained(dataset, seed=3):
    return np.random.default_rng(seed).normal(0.0, 0.1, (dataset.n_users + dataset.n_items, D)).astype(np.float32)


def _idcf_cfg(dataset, **kw):
    cfg = {"name": "IDCF_LGCN", "embedding_size": D, "n_layers": 2, "n_headers": 3, "n_samples": 12,
           "pretrained_embedding": _pretrained(dataset)}
    cfg.update(kw)
    return cfg


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


def _batch(dataset, n=48, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, dataset.n_users, n), rng.integers(0, dataset.n_items, n), rng.integers(0, dataset.n_items, n)


def _assert_grads(t_params, j_grads, names=None):
    flat = flatten_params(j_grads)
    for name in names or t_params:
        got, want = t_params[name].grad, np.asarray(flat[name])
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-4), err_msg=name)


# -- forward -----------------------------------------------------------------------


@pytest.mark.parametrize(
    "name, arch",
    [("MF", None), ("NGCF", None), ("IMCGAE", None), ("Popularity", None), ("MultiVAE", None),
     ("NeuMF", "gmf"), ("NeuMF", "mlp"), ("NeuMF", "neumf")],
)
def test_scores_match_jax(ds, name, arch):
    """``make_scoring_state`` + ``score`` (and ``get_rep`` where there is one)
    at evaluation, against JAX's on the same weights."""
    jm, jp, tm, tp = _pair(CONFIGS[name], ds)
    if arch is not None:
        jm.arch = tm.arch = arch
    users = np.arange(ds.n_users)
    with torch.no_grad():
        got = tm.score(tm.make_scoring_state(tp), torch.as_tensor(users)).numpy()
        if name in ("NGCF", "IMCGAE"):
            np.testing.assert_allclose(tm.get_rep(tp).numpy(), np.asarray(jm.get_rep(jp)), **TOL)
    want = np.asarray(jm.score(jm.make_scoring_state(jp), jnp.asarray(users)))
    assert got.shape == (ds.n_users, ds.n_items)
    np.testing.assert_allclose(got, want, **TOL)


def test_neumf_scores_over_several_item_blocks(ds):
    jm, jp, tm, tp = _pair(CONFIGS["NeuMF"], ds)
    users = jnp.arange(7)
    with torch.no_grad():
        got = tm.score(tp, torch.arange(7), item_block=32).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.score(jp, users, item_block=32)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jm.score(jp, users)), **TOL)


def test_idcf_representations_match_jax_with_its_samples(ds):
    """get_rep and the contrastive term with JAX's evaluation samples
    (``jax.random.key(0)``) handed in; the port's own evaluation draws repeat
    call after call."""
    jm, jp, tm, tp = _pair(_idcf_cfg(ds), ds)
    samples = _jax_idcf_samples(jm, jax.random.key(0))
    with torch.no_grad():
        got, closs = tm.get_rep(tp, samples=samples, contrastive=True)
    want, want_closs = jm.get_rep(jp, contrastive=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(closs.numpy(), np.asarray(want_closs), **TOL)
    assert torch.equal(tm.draw_samples(), tm.draw_samples())
    assert "frozen_embedding" not in tm.params() and "frozen_embedding" in dict(tm.named_buffers())


def test_imcgae_padded_operand_stays_zero(ds):
    """The operand's padding column (d + 3 = 19 -> 20) comes back exactly 0
    in evaluation and under node dropout, and slicing it off gives JAX's
    compact rows."""
    jm, jp, tm, tp = _pair(CONFIGS["IMCGAE"], ds)
    assert tm.operand_width == 20
    for training in (False, True):
        padded, _ = tm.compact_rep(tp, training=training, generator=torch.Generator().manual_seed(5), padded=True)
        assert padded.shape == (ds.n_users + ds.n_items, 20)
        assert torch.count_nonzero(padded[:, D + 3 :]) == 0
    compact, parts = tm.compact_rep(tp)
    want, want_parts = jm._rep_compact(jp, None, False, jm.buffers)
    np.testing.assert_allclose(compact.detach().numpy(), np.asarray(want), **TOL)
    for a, b in zip(parts, want_parts):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


# -- ItemKNN -----------------------------------------------------------------------


def _dense(mat):
    out = np.zeros(mat.shape)
    np.add.at(out, (mat.edge_rows().numpy(), mat.col.numpy()), mat.val.numpy())
    return out


def _jaccard(dataset):
    r = np.zeros((dataset.n_users, dataset.n_items))
    r[tuple(np.unique(np.asarray(dataset.train_array), axis=0).T)] = 1.0
    inter = r.T @ r
    deg = r.sum(0)
    denom = deg[:, None] + deg[None, :] - inter
    sims = np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)
    return np.where(deg[:, None] > 0, sims, 0.0)


@pytest.mark.parametrize("k, block", [(7, 32), (40, 512)])
def test_itemknn_similarity_matches_jax_up_to_ties(ds, k, block):
    """Each item's k neighbours: the values equal JAX's within 1e-6 and the
    exact Jaccard, and the sets agree except among items tied at the k-th
    value; the similarity is built in several blocks, each one product of
    R^T against the block's user columns."""
    cfg = {"name": "ItemKNN", "k": k, "sim_block": block}
    jm = jax_get_model(cfg, ds)
    tm = get_model(cfg, ds, device="cpu")
    s_port = _dense(tm.sim_t).T  # S: row i holds item i's neighbours
    s_jax = np.asarray(spmm_bucketed(jm.buffers["sim_t"], jnp.eye(ds.n_items))).T
    exact = _jaccard(ds)
    for i in range(ds.n_items):
        kth = np.sort(exact[i])[-k]
        want = np.sort(s_jax[i])[::-1][:k]
        got = np.sort(s_port[i])[::-1][:k]
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(s_port[i][s_port[i] != 0], exact[i][s_port[i] != 0], atol=1e-6)
        sure_j = set(np.flatnonzero(s_jax[i] > kth + 1e-6))
        sure_p = set(np.flatnonzero(s_port[i] > kth + 1e-6))
        assert sure_j == sure_p, i
    # every nonzero neighbour is one of the top k by the exact Jaccard
    assert ((s_port != 0).sum(1) <= k).all()


def test_itemknn_scores_match_jax(ds):
    """With k = n_items there is no boundary to tie at: the scores equal
    JAX's; scoring is the user profile times S."""
    cfg = {"name": "ItemKNN", "k": ds.n_items, "sim_block": 64}
    jm = jax_get_model(cfg, ds)
    tm = get_model(cfg, ds, device="cpu")
    users = np.arange(ds.n_users)
    with torch.no_grad():
        got = tm.score(tm.make_scoring_state({}), torch.as_tensor(users)).numpy()
    want = np.asarray(jm.score(jm.make_scoring_state({}), jnp.asarray(users)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    profiles = dense_profiles(tm.train_padded, torch.as_tensor(users), ds.n_items).numpy()
    np.testing.assert_allclose(got, profiles @ _dense(tm.sim_t).T, rtol=1e-5, atol=1e-6)


def test_itemknn_coalesces_repeated_pairs():
    """A train pair listed twice counts once in the Jaccard (the JAX
    package's fix)."""
    base = quick_synthetic_dataset(30, 20, 300, seed=2)
    twice = JaxBasicDataset({"name": "Twice"})
    twice.n_users, twice.n_items = base.n_users, base.n_items
    twice.train_array = np.concatenate([np.asarray(base.train_array), np.asarray(base.train_array)[:40]])
    twice.train_data = base.train_data
    cfg = {"name": "ItemKNN", "k": 20}
    a = _dense(get_model(cfg, base, device="cpu").sim_t)
    b = _dense(get_model(cfg, twice, device="cpu").sim_t)
    np.testing.assert_allclose(a, b, atol=1e-7)


# -- training-mode forwards and gradients -------------------------------------------


@pytest.mark.parametrize("name", ["MF", "NGCF", "IMCGAE"])
def test_bpr_forward_and_gradients_match_jax(ds, name):
    """``bpr_forward`` in training at dropout 0 and the gradient of BPR + L2
    against ``jax.grad``."""
    jm, jp, tm, tp = _pair(dict(CONFIGS[name], dropout=0.0) if name != "MF" else CONFIGS[name], ds)
    users, pos, neg = _batch(ds)

    def j_loss(p):
        u, pr, nr, l2 = jm.bpr_forward(p, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg), training=True)
        return JL.bpr_loss(u, pr, nr) + 1e-3 * l2.mean()

    out = tm.bpr_forward(tp, *(torch.as_tensor(a) for a in (users, pos, neg)), training=True,
                         generator=torch.Generator().manual_seed(0))
    loss = bpr_loss(*out[:3]) + 1e-3 * out[3].mean()
    loss.backward()
    want, grads = jax.jit(jax.value_and_grad(j_loss))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(tp, grads)


def test_idcf_bpr_forward_and_gradients_match_jax(ds):
    """IDCF's five outputs and the gradient of its loss (BPR + L2 + the
    contrastive term), JAX's training draws handed to the port."""
    jm, jp, tm, tp = _pair(_idcf_cfg(ds), ds)
    users, pos, neg = _batch(ds)
    rng = jax.random.key(9)
    samples = _jax_idcf_samples(jm, rng)

    def j_loss(p):
        u, pr, nr, l2, c = jm.bpr_forward(p, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg), rng=rng)
        return JL.bpr_loss(u, pr, nr) + 1e-4 * l2.mean() + 1e-3 * c.mean()

    out = tm.bpr_forward(tp, *(torch.as_tensor(a) for a in (users, pos, neg)), samples=samples)
    want_out = jm.bpr_forward(jp, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg), rng=rng)
    for g, w in zip(out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    loss = bpr_loss(*out[:3]) + 1e-4 * out[3].mean() + 1e-3 * out[4].mean()
    loss.backward()
    want, grads = jax.jit(jax.value_and_grad(j_loss))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(tp, grads)


def test_multivae_ml_forward_and_gradients_match_jax(ds):
    """``ml_forward`` in training with JAX's dropout mask and noise handed in,
    and the gradient of the multinomial likelihood + KL + L2 (MLTrainer's
    loss, trainer.py:728-736 of the JAX package)."""
    jm, jp, tm, tp = _pair(CONFIGS["MultiVAE"], ds)
    users = np.arange(0, ds.n_users, 2)
    valid = (np.arange(len(users)) < len(users) - 5).astype(np.float32)
    rng = jax.random.key(4)
    sub_rng, sub = jax.random.split(rng)
    keep = np.array(jax.random.uniform(sub, (len(users), ds.n_items)) >= jm.dropout)
    eps = np.array(jax.random.normal(sub_rng, (len(users), jm.mid_size)))

    def j_loss(p):
        scores, kl, l2 = jm.ml_forward(p, jnp.asarray(users), rng=rng, training=True)
        prof = jm._profiles(jm.buffers, jnp.asarray(users), normalized=False)
        v = jnp.asarray(valid)
        return JL.multinomial_ll_loss(scores, prof, valid=v) + 0.2 * jnp.sum(kl * v) / v.sum() + 1e-4 * l2.mean()

    t_users, t_valid = torch.as_tensor(users), torch.as_tensor(valid)
    scores, kl, l2 = tm.ml_forward(tp, t_users, training=True, keep=torch.as_tensor(keep), eps=torch.as_tensor(eps))
    j_scores, j_kl, j_l2 = jm.ml_forward(jp, jnp.asarray(users), rng=rng, training=True)
    for g, w in ((scores, j_scores), (kl, j_kl), (l2, j_l2)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    prof = tm.profiles(t_users, normalized=False)
    loss = multinomial_ll_loss(scores, prof, t_valid) + 0.2 * (kl * t_valid).sum() / t_valid.sum() + 1e-4 * l2.mean()
    loss.backward()
    want, grads = jax.jit(jax.value_and_grad(j_loss))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(tp, grads)


@pytest.mark.parametrize("arch", ["gmf", "mlp", "neumf"])
def test_neumf_bce_forward_and_gradients_match_jax(ds, arch):
    jm, jp, tm, tp = _pair(CONFIGS["NeuMF"], ds)
    users, pos, neg = _batch(ds)

    def j_loss(p):
        lp, l2p = jm.bce_forward(p, jnp.asarray(users), jnp.asarray(pos), arch=arch)
        ln, l2n = jm.bce_forward(p, jnp.asarray(users), jnp.asarray(neg), arch=arch)
        return JL.bce_losses(lp, ln).mean() + 1e-3 * jnp.concatenate([l2p, l2n]).mean()

    lp, l2p = tm.bce_forward(tp, torch.as_tensor(users), torch.as_tensor(pos), arch=arch)
    ln, l2n = tm.bce_forward(tp, torch.as_tensor(users), torch.as_tensor(neg), arch=arch)
    loss = bce_losses(lp, ln).mean() + 1e-3 * torch.cat([l2p, l2n]).mean()
    loss.backward()
    want, grads = jax.jit(jax.value_and_grad(j_loss))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads(tp, grads)
    with pytest.raises(ValueError):
        tm.bce_forward(tp, torch.as_tensor(users), torch.as_tensor(pos), arch="mf")


def test_neumf_init_mlp_layers_resets_the_fusion_and_keeps_the_tables(ds):
    tm = get_model(CONFIGS["NeuMF"], ds, device="cpu")
    p = tm.params()
    before = {k: v.detach().clone() for k, v in p.items()}
    with torch.no_grad():
        p["output_w"].mul_(3.0)
    tm.init_mlp_layers(torch.Generator().manual_seed(1))
    assert torch.equal(p["output_w"], torch.ones_like(p["output_w"]))
    assert torch.equal(p["mf_user_embedding"], before["mf_user_embedding"])
    assert not torch.equal(p["mlp_layers.0.w"], before["mlp_layers.0.w"])
    assert torch.count_nonzero(p["mlp_layers.0.b"]) == 0
    tm.restore_aux(tm.checkpoint_aux())
    assert tm.checkpoint_aux() == {"arch": "gmf"}


# -- NGCF's dropout ------------------------------------------------------------------


def test_ngcf_one_edge_mask_for_every_layer(ds, monkeypatch):
    """In training every layer's product runs under one seed, drawn anew each
    step; the representation equals a dense recomputation with that seed's
    kept-edge mask, and so does the embedding gradient, which the kernel's
    transpose product under the same seed computes."""
    cfg = dict(CONFIGS["NGCF"], dropout=0.4, layer_sizes=[D, D, D])
    tm = get_model(cfg, ds, device="cpu")
    tp = tm.params()
    seeds = []
    real = placement_module.spmm_csr_dropout

    def recording(mat, x, seed, p):
        seeds.append((seed, p))
        return real(mat, x, seed, p)

    monkeypatch.setattr(placement_module, "spmm_csr_dropout", recording)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    rep = tm.get_rep(tp, training=True, generator=gen)
    assert len(seeds) == 3 and len(set(seeds)) == 1 and seeds[0][1] == 0.4
    tm.get_rep(tp, training=True, generator=gen)
    assert len(set(seeds)) == 2

    # the same forward with the mask folded densely into the matrix
    adj = tm.norm_adj
    masked = torch.zeros(adj.shape, dtype=torch.float64)
    masked.index_put_((adj.edge_rows().long(), adj.col.long()),
                      dropout_values(adj.val, adj.eid, *seeds[0]).double(), accumulate=True)
    gen.set_state(state)
    monkeypatch.setattr(placement_module, "spmm_csr_dropout", lambda mat, x, seed, p: (masked @ x.double()).float())
    dense_rep = tm.get_rep(tp, training=True, generator=gen)
    np.testing.assert_allclose(rep.detach().numpy(), dense_rep.detach().numpy(), rtol=1e-5, atol=1e-6)
    w = torch.as_tensor(np.random.default_rng(0).standard_normal(rep.shape), dtype=torch.float32)
    g_kernel = torch.autograd.grad((rep * w).sum(), tp["embedding"])[0]
    g_dense = torch.autograd.grad((dense_rep * w).sum(), tp["embedding"])[0]
    np.testing.assert_allclose(g_kernel.numpy(), g_dense.numpy(), rtol=1e-4, atol=1e-5)


def test_ngcf_isolated_node_dropped_selfloop_grads_finite():
    """The port of ``tests/test_model_zoo.py:205-240``: items 3 and 4 have no
    interaction, so their row of A + I is the self-loop alone; at p 0.95 the
    mask drops it, the row of h is exactly 0, and the clamp inside the square
    root keeps the gradient finite."""
    ds = JaxBasicDataset({"name": "Isolated"})
    ds.n_users, ds.n_items = 3, 5
    ds.train_array = np.array([[0, 0], [0, 1], [1, 0], [1, 2], [2, 1], [2, 2]])
    tm = get_model({"name": "NGCF", "embedding_size": 8, "layer_sizes": [8, 8], "dropout": 0.95}, ds, device="cpu")
    tp = tm.params()
    zero_rows = 0
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        out = tm.bpr_forward(tp, torch.tensor([0, 1]), torch.tensor([0, 1]), torch.tensor([2, 0]), generator=gen)
        loss = bpr_loss(*out[:3]) + 1e-3 * out[3].mean()
        grads = torch.autograd.grad(loss, list(tp.values()))
        assert np.isfinite(loss.item()), seed
        assert all(torch.isfinite(g).all() for g in grads), seed
        gen = torch.Generator().manual_seed(seed)
        rep = tm.get_rep(tp, training=True, generator=gen)
        zero_rows += int((rep[ds.n_users + 3, 8:] == 0).all())
    assert zero_rows > 0  # the case arose


def test_ngcf_message_dropout_rate():
    ds = quick_synthetic_dataset(300, 200, 6000, seed=1)
    tm = get_model(dict(CONFIGS["NGCF"], dropout=0.3, layer_sizes=[64]), ds, device="cpu")
    with torch.no_grad():
        rep = tm.get_rep(tm.params(), training=True, generator=torch.Generator().manual_seed(0))
    zeros = (rep[:, D:] == 0).double().mean().item()
    assert abs(zeros - 0.3) < 0.02


# -- dropout draws, profiles, datasets, parameter trees ------------------------------


def test_dropout_draws():
    gen = torch.Generator().manual_seed(0)
    mask = node_dropout_mask(gen, 20000, 0.25, True, "cpu")
    assert set(torch.unique(mask).tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((mask == 0).double().mean().item() - 0.25) < 0.02
    assert torch.equal(node_dropout_mask(gen, 5, 0.25, False, "cpu"), torch.ones(5))
    assert torch.equal(node_dropout_mask(gen, 5, 0.0, True, "cpu"), torch.ones(5))
    val = torch.rand(20000, generator=gen) + 0.5
    out = sparse_dropout(val, gen, 0.4, True)
    kept = out != 0
    assert abs(kept.double().mean().item() - 0.6) < 0.02
    torch.testing.assert_close(out[kept], val[kept] / 0.6)
    assert sparse_dropout(val, gen, 0.4, False) is val
    a = node_dropout_mask(torch.Generator().manual_seed(7), 100, 0.5, True, "cpu")
    b = node_dropout_mask(torch.Generator().manual_seed(7), 100, 0.5, True, "cpu")
    assert torch.equal(a, b)


def test_dense_profiles_match_jax(ds):
    lists = ds.train_data
    users = np.array([0, 5, 5, 17, ds.n_users - 1])
    jp = jax_dense_profiles(jax_device_padded_from_lists(lists, ds.n_items), jnp.asarray(users), ds.n_items)
    tp = dense_profiles(device_padded_from_lists(lists, ds.n_items, device="cpu"), torch.as_tensor(users), ds.n_items)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp.dtype == torch.float32


def test_datasets_carry_neg_ratio(tmp_path):
    """BasicDataset reads the config's neg_ratio (default 1), as JAX's does
    (``data/dataset.py:116``); ProcessedDataset and quick_synthetic_dataset
    carry it."""
    for name in ("train", "val", "test"):
        (tmp_path / f"{name}.txt").write_text("0 1 2\n1 0\n2 3 1\n")
    for cfg in ({"name": "ProcessedDataset", "path": str(tmp_path)},
                {"name": "ProcessedDataset", "path": str(tmp_path), "neg_ratio": 4}):
        assert ProcessedDataset(cfg).negative_sample_ratio == JaxBasicDataset(cfg).negative_sample_ratio
    assert ProcessedDataset({"name": "ProcessedDataset", "path": str(tmp_path), "neg_ratio": 4}).negative_sample_ratio == 4
    assert port_quick_synthetic_dataset(20, 10, 100).negative_sample_ratio == 1
    assert port_quick_synthetic_dataset(20, 10, 100, neg_ratio=4).negative_sample_ratio == 4


@pytest.mark.parametrize("which", ["NGCF", "IDCF"])
def test_params_from_jax_round_trips_nested_trees(ds, which):
    """Every leaf of the JAX tree lands under its dotted name; a missing or an
    extra name raises."""
    cfg = CONFIGS["NGCF"] if which == "NGCF" else _idcf_cfg(ds)
    jm, jp, tm, tp = _pair(cfg, ds, seed=5)
    flat = flatten_params(jp)
    expected = {"gc_layers.1.w", "bi_layers.0.b"} if which == "NGCF" else {"gat_units.2.wk.b", "w_out.w"}
    assert expected <= set(flat) and set(flat) == set(tp)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(tp[name].detach().numpy(), np.asarray(leaf))
    some = sorted(flat)[0]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tm, {k: v for k, v in flat.items() if k != some})
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(tm, dict(flat, extra=np.zeros(1)))
