"""AttIGCN's route through the port against the JAX package: the product with
learned edge values (``spmm_csr_values``) and its two gradients, the per-row
softmax over edges, the attention aggregation (fused-key and plain, with and
without JAX's gather-only ``dv_slots`` backward), and the AttIGCN model and
its ``IGCNTrainer`` steps.

On CPU tensors the products run their plain PyTorch versions; the kernel is
held against them on the card by ``chip_smoke.py`` (phase 10). Inputs come
from numpy seeds; sets are small (2 layers, d 16, 2 heads). Tolerances:
rtol 1e-5 and atol 1e-5 times the JAX side's largest magnitude (fp32 sums
in other orders: the CSR sums a row's edges in its order, JAX a bucket's
slots in theirs)."""

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
from inductive_recommendation_tpu.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu.graph import build_feat_matrix
from inductive_recommendation_tpu.ops import build_bucketed_spmm
from inductive_recommendation_tpu.ops import attention_spmm as jax_att
from inductive_recommendation_tpu.ops.spmm import segment_softmax as jax_segment_softmax
from inductive_recommendation_tpu.train import losses as JL
from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.ops import (
    attention_spmm,
    attention_spmm_fused_kv,
    build_csr_spmm,
    segment_softmax,
    spmm_csr_values,
    values_layout,
    with_annealed_values,
)
from inductive_recommendation_tpu_torch.ops.csr_spmm import ROUTES, route_key
from inductive_recommendation_tpu_torch.train import aux_bpr_w, bpr_loss
from inductive_recommendation_tpu_torch.train import trainer as trainer_module

RTOL = 1e-5
H, D = 2, 16


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


@pytest.fixture(scope="module")
def feat():
    """The IGCN feature matrix of a small synthetic set: the port's values
    layout and JAX's bucketed layout of the same COO."""
    ds = quick_synthetic_dataset(90, 70, 1800, seed=3)
    row, col, counts, row_sum = build_feat_matrix(
        ds.train_array, ds.n_users, ds.n_items, np.arange(ds.n_users), np.arange(ds.n_items)
    )
    shape = (ds.n_users + ds.n_items, ds.n_users + ds.n_items + 2)
    port = values_layout(build_csr_spmm(row, col, counts, shape))
    jmat = build_bucketed_spmm(row, col, counts, shape, symmetric=False)
    return port, jmat, shape


def _dense_jax(mat, values, x):
    """JAX's dense product with ``values`` at the port layout's (row, col)."""
    rows, cols = jnp.asarray(mat.edge_rows().numpy()), jnp.asarray(mat.col.numpy())
    return jnp.zeros(mat.shape, jnp.float32).at[rows, cols].add(values) @ x


def test_values_layout_contract(feat):
    """Values 1 on both sides, routes of their own, and ``t_pos`` mapping
    each transpose edge to the forward position of the same edge id."""
    mat, _, _ = feat
    assert mat.route == "attention" and mat.T.route == "attention" and mat.T.transposed
    assert route_key(mat) == "attention" and route_key(mat.T) == "attention_transpose"
    assert route_key(mat.T, (0, 0.3)) == "attention_transpose" and set(ROUTES) >= {"aug_feat", "aug_feat_transpose"}
    assert torch.equal(mat.val, torch.ones(mat.nnz)) and torch.equal(mat.T.val, torch.ones(mat.nnz))
    assert torch.equal(mat.eid[mat.t_pos], mat.T.eid)
    with pytest.raises(ValueError, match="symmetric"):
        values_layout(build_csr_spmm([0, 1], [1, 0], [1.0, 1.0], (2, 2), symmetric=True))
    bare = build_csr_spmm([0, 1], [1, 0], [1.0, 1.0], (2, 2))
    with pytest.raises(ValueError, match="values layout"):
        spmm_csr_values(bare, torch.ones(2, 3, requires_grad=True), torch.ones(2))
    with pytest.raises(ValueError, match="nnz"):
        spmm_csr_values(mat, torch.ones(mat.n_cols, 3), torch.ones(mat.nnz + 1))


@pytest.mark.parametrize("d", [8, 37])
def test_spmm_csr_values_and_gradients_match_jax(feat, d):
    """Forward, d(x) (the transpose product with the values gathered through
    ``t_pos``) and d(values) (gather plus row dot) against ``jax.vjp`` of
    the dense product."""
    mat, _, _ = feat
    rng = np.random.default_rng(d)
    x = rng.standard_normal((mat.n_cols, d)).astype(np.float32)
    values = rng.random(mat.nnz).astype(np.float32)
    g = rng.standard_normal((mat.n_rows, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda xx, vv: _dense_jax(mat, vv, xx), jnp.asarray(x), jnp.asarray(values))
    want_dx, want_dv = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_(True)
    vt = torch.as_tensor(values).requires_grad_(True)
    out = spmm_csr_values(mat, xt, vt)
    (out * torch.as_tensor(g)).sum().backward()
    assert_close(out, want)
    assert_close(xt.grad, want_dx)
    assert_close(vt.grad, want_dv)
    # a gradient in the values alone
    vt2 = torch.as_tensor(values).requires_grad_(True)
    (spmm_csr_values(mat, torch.as_tensor(x), vt2) * torch.as_tensor(g)).sum().backward()
    assert_close(vt2.grad, want_dv)


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax_matches_jax(heads):
    """Per-row softmax over [nnz] and [nnz, h] scores, with empty rows, and
    its VJP, against JAX's ``segment_softmax``; at a temperature, against
    JAX's at scores / T."""
    rng = np.random.default_rng(1)
    degrees = np.array([3, 0, 1, 7, 0, 0, 12, 2, 0])
    row_ptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    rows = np.repeat(np.arange(len(degrees)), degrees).astype(np.int32)
    shape = (rows.shape[0],) if heads is None else (rows.shape[0], heads)
    scores = (rng.standard_normal(shape) * 4).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    for t in (1.0, 2.5):
        want, vjp = jax.vjp(lambda s: jax_segment_softmax(s / t, jnp.asarray(rows), len(degrees)), jnp.asarray(scores))
        st = torch.as_tensor(scores).requires_grad_(True)
        got = segment_softmax(st, torch.as_tensor(row_ptr), temperature=t)
        (got * torch.as_tensor(g)).sum().backward()
        assert_close(got, want)
        assert_close(st.grad, vjp(jnp.asarray(g))[0])
    sums = torch.zeros(len(degrees), *shape[1:]).index_add_(0, torch.as_tensor(rows).long(), got.detach())
    np.testing.assert_allclose(sums.numpy()[degrees > 0], 1.0, rtol=1e-6)


def _att_inputs(shape, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((shape[0], H, D)).astype(np.float32)
    w_k = (rng.standard_normal((D, H * D)) * 0.3).astype(np.float32)
    b_k = rng.standard_normal(H * D).astype(np.float32)
    v = rng.standard_normal((shape[1], D)).astype(np.float32)
    g = rng.standard_normal((shape[0], D)).astype(np.float32)
    return q, w_k, b_k, v, g


def _port_vjp(fn, inputs, g):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in inputs]
    out = fn(*ts)
    (out * torch.as_tensor(g)).sum().backward()
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("dv_slots", [False, True])
def test_attention_spmm_fused_kv_matches_jax(feat, dv_slots):
    """The fused-key attention and its VJP in q, Wk, bk and v, against JAX's
    autodiff path and its gather-only ``dv_slots`` backward, at the
    AttIGCN temperature."""
    mat, jmat, shape = feat
    q, w_k, b_k, v, g = _att_inputs(shape)
    t = float(np.sqrt(D) * 10.0)
    slots = jax_att.build_dv_slot_tables(jmat) if dv_slots else None
    want, vjp = jax.vjp(
        lambda *a: jax_att.attention_spmm_fused_kv(jmat, *a, t, dv_slots=slots), *map(jnp.asarray, (q, w_k, b_k, v))
    )
    out, grads = _port_vjp(lambda *a: attention_spmm_fused_kv(mat, *a, t), (q, w_k, b_k, v), g)
    assert_close(out, want)
    for name, got, w in zip(("q", "w_k", "b_k", "v"), grads, vjp(jnp.asarray(g))):
        if name == "b_k":
            # a per-row shift of the scores: its gradient is 0 in exact
            # arithmetic, rounding noise on both sides
            assert np.abs(got.numpy()).max() < 1e-5 * np.abs(grads[1].numpy()).max()
            assert np.abs(np.asarray(w)).max() < 1e-5 * np.abs(grads[1].numpy()).max()
            continue
        assert_close(got, w, err_msg=name)


def test_attention_spmm_matches_jax(feat):
    """The plain attention (an explicit key table, all three inputs
    differentiable) against JAX's ``attention_spmm``, forward and VJP."""
    mat, jmat, shape = feat
    q, w_k, _, v, g = _att_inputs(shape, seed=5)
    k = (v @ w_k).astype(np.float32)
    t = 3.0
    want, vjp = jax.vjp(lambda *a: jax_att.attention_spmm(jmat, *a, t), *map(jnp.asarray, (q, k, v)))
    out, grads = _port_vjp(lambda *a: attention_spmm(mat, *a, t), (q, k, v), g)
    assert_close(out, want)
    for name, got, w in zip(("q", "k", "v"), grads, vjp(jnp.asarray(g))):
        assert_close(got, w, err_msg=name)


# -- the model ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ds():
    return quick_synthetic_dataset(60, 50, 1500, seed=7)


def _cfg(**kw):
    cfg = {"name": "AttIGCN", "embedding_size": D, "n_layers": 2, "dropout": 0.3, "feature_ratio": 0.5, "n_heads": H}
    cfg.update(kw)
    return cfg


def _harness():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "golden_parity_flagships.py")
    spec = importlib.util.spec_from_file_location("golden_flagships", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(ds, cfg=None):
    cfg = cfg or _cfg()
    jm = jax_get_model(cfg, ds)
    jp = jm.init_params(jax.random.key(0))
    tm = get_model(cfg, ds, device="cpu")
    tp = params_from_jax(tm, jp)
    return jm, jp, tm, tp


def _batch(ds, seed=0, n=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, ds.n_users, n), rng.integers(0, ds.n_items, n), rng.integers(0, ds.n_items, n)


def test_att_igcn_params_and_alpha_zero(ds):
    """feature_ratio forced to 1, the JAX parameter tree carried across by
    name (``weight_q.w`` ...), alpha 0 baked into feat's values and kept
    there through an anneal, like JAX's (tests/test_igcn.py:181-200)."""
    jm, jp, tm, tp = _pair(ds)
    assert tm.feature_ratio == 1.0 and tm.alpha == jm.alpha == 0.0 and tm.temperature == jm.temperature
    assert set(tp) == {"embedding", "w", "weight_q.w", "weight_q.b", "weight_k.w", "weight_k.b"}
    assert tp["weight_q.w"].shape == (D, D * H)
    expected = with_annealed_values(tm._feat_base, tm._feat_row_sum, 0.0)
    assert torch.equal(tm.feat.val, expected.val) and torch.equal(tm.feat.T.val, expected.T.val)
    tm.feat_mat_anneal()
    jm.feat_mat_anneal()
    assert tm.alpha == jm.alpha == 0.0
    assert torch.equal(tm.feat.val, expected.val)
    assert_close(tm.get_rep(tp).detach(), jm.get_rep(jp))


def test_att_igcn_forward_and_gradients_match_jax(ds):
    """``get_rep``, ``bpr_forward``'s four outputs, and the gradient of
    every parameter of the IGCNTrainer loss (BPR + L2 + the auxiliary BPR)
    against ``jax.grad``. ``weight_k.b`` shifts a row's scores alike: its
    gradient is 0 in exact arithmetic and rounding noise on both sides."""
    jm, jp, tm, tp = _pair(ds)
    assert_close(tm.get_rep(tp).detach(), jm.get_rep(jp))
    users, pos, neg = _batch(ds)
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map)
    rng = np.random.default_rng(2)
    a_users = rng.integers(0, ds.n_users, 64)
    a_pos = np.array([rng.choice(aux.train_data[u]) if aux.train_data[u] else 0 for u in a_users])
    a_neg = rng.integers(0, jm.item_dim, 64)
    l2_reg, aux_reg = 1e-4, 0.01

    def j_loss(p):
        u_r, p_r, n_r, l2 = jm.bpr_forward(p, *map(jnp.asarray, (users, pos, neg)), training=True)
        aux_l = JL.aux_bpr_w(p["embedding"], p["w"], *map(jnp.asarray, (a_users, a_pos, a_neg)), jm.user_dim)
        return JL.bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean() + aux_reg * aux_l, (u_r, p_r, n_r, l2)

    (want_loss, want_out), want_grads = jax.value_and_grad(j_loss, has_aux=True)(jp)
    t = [torch.as_tensor(a) for a in (users, pos, neg, a_users, a_pos, a_neg)]
    out = tm.bpr_forward(tp, *t[:3], training=True)
    loss = bpr_loss(*out[:3]) + l2_reg * out[3].mean() + aux_reg * aux_bpr_w(tp["embedding"], tp["w"], *t[3:], tm.user_dim)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert_close(loss.detach(), want_loss)
    for g, w in zip(out, want_out):
        assert_close(g.detach(), w)
    want = {"embedding": want_grads["embedding"], "w": want_grads["w"]}
    for layer in ("weight_q", "weight_k"):
        want.update({f"{layer}.w": want_grads[layer]["w"], f"{layer}.b": want_grads[layer]["b"]})
    for name, g in zip(tp, grads):
        if name == "weight_k.b":
            scale = np.abs(np.asarray(want["weight_k.w"])).max()
            assert np.abs(g.numpy()).max() < 1e-5 * scale and np.abs(np.asarray(want[name])).max() < 1e-5 * scale
            continue
        assert_close(g, want[name], err_msg=name)


def test_att_igcn_trainer_steps_match_jax(ds, monkeypatch):
    """Three IGCNTrainer steps against optax Adam on JAX's loss with the same
    batches: every loss, and every parameter after (``weight_k.b`` left out:
    Adam turns its zero gradient's rounding noise into steps of lr)."""
    harness = _harness()
    jm, jp, tm, _ = _pair(ds)
    trainer = get_trainer({"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
                           "n_epochs": 1, "batch_size": 128, "topks": [20]}, ds, tm)
    params_from_jax(tm, jp)
    aux = JaxAuxiliaryDataset(ds, jm.user_map, jm.item_map)
    batches = harness.make_batches(np.random.default_rng(8), ds, jm, aux, 1, 3, 128)[0]
    it = iter([b for users, pos, neg, au, ap, an in batches for b in ((users, pos, neg), (au, ap, an))])

    def fake(state, generator, batch_size, neg_ratio=1):
        u, p, n = next(it)
        return tuple(torch.as_tensor(a, dtype=torch.int64) for a in (u, p)) + (torch.as_tensor(n, dtype=torch.int64)[:, None],)

    monkeypatch.setattr(trainer_module, "sample_bpr_batch", fake)
    optimizer = optax.adam(1e-3)

    @jax.jit
    def jstep(params, opt_state, users, pos, neg, au, ap, an):
        def loss_fn(p):
            u_r, p_r, n_r, l2 = jm.bpr_forward(p, users, pos, neg, training=False)
            aux_l = JL.aux_bpr_w(p["embedding"], p["w"], au, ap, an, jm.user_dim)
            return JL.bpr_loss(u_r, p_r, n_r) + 1e-4 * l2.mean() + 0.01 * aux_l

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state = optimizer.init(jp)
    for b in batches:
        jp, opt_state, j_loss = jstep(jp, opt_state, *map(jnp.asarray, b))
        np.testing.assert_allclose(trainer.step().item(), float(j_loss), rtol=RTOL)
    flat = {"embedding": jp["embedding"], "w": jp["w"], "weight_q.w": jp["weight_q"]["w"],
            "weight_q.b": jp["weight_q"]["b"], "weight_k.w": jp["weight_k"]["w"]}
    for name, want in flat.items():
        assert_close(tm.params()[name].detach(), want, err_msg=name)
