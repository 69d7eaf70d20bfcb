"""The port's AttIGCN against the benchmark's plain float64 reference
(``port_bench/models/attigcn.py``, which imports nothing of the port) on the
CPU: on seeded random weights, Wq and Wk drawn wide so that the attention
lies far from uniform, the head-mean attention on every edge, one
``IGCNTrainer`` batch's loss, and its first gradients of every parameter."""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch import get_model, get_trainer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.core import data as bench_data  # noqa: E402
from port_bench.core import judge as J  # noqa: E402
from port_bench.core import manifest as M  # noqa: E402
from port_bench.core import port  # noqa: E402
from port_bench.core import reference as ref  # noqa: E402

MODEL = {"name": "AttIGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1, "n_heads": 2}
TRAINER = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-3, "aux_reg": 0.01, "n_epochs": 1,
           "batch_size": 64, "test_batch_size": 32, "topks": [5, 20], "seed": 11}
# fp32 against float64: sums of a few hundred terms in other orders
RTOL = 1e-5


@pytest.fixture(scope="module")
def case():
    bench = M.model(ROOT, "AttIGCN")
    data = bench_data.synthetic(60, 80, 1500, bench_data.seed_words(7, 1))
    ds = port.dataset(data)
    model = get_model(dict(MODEL), ds, device="cpu")
    trainer = get_trainer(dict(TRAINER), ds, model)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in trainer.params.items():
            std = {"embedding": 0.1, "w": 0.5, "weight_q.w": 8.0, "weight_k.w": 8.0}.get(name, 0.2)
            p.copy_(torch.randn(p.shape, generator=g) * std + (1.0 if name == "w" else 0.0))
    run = types.SimpleNamespace(data=data, config={"model": MODEL, "trainer": TRAINER}, device=torch.device("cpu"))
    spec = bench.train_spec(run)
    params64 = {k: v.detach().to(torch.float64) for k, v in trainer.params.items()}
    return bench, model, trainer, spec, params64


def test_the_attention_matches_the_reference_far_from_uniform(case):
    bench, model, trainer, spec, params64 = case
    with torch.no_grad():
        attn = model.attention(trainer.params)
        attn_ref = bench.attention(spec, params64)
    rows = spec.feat.coo.rows.numpy()
    deg = np.bincount(rows, minlength=spec.feat.coo.n_rows)
    spread = np.abs(attn_ref.numpy() - 1.0 / deg[rows]).max()
    assert spread > 0.05  # the test sees the attention, not its uniform part
    keys, _ = J.entries(model.att_feat, model.feat_n_cols)
    gap = bench.attn_gap((keys, attn.numpy()), spec.feat, attn_ref)
    assert gap < 1e-5, gap


def test_loss_and_first_gradients_match_the_reference(case):
    bench, model, trainer, spec, params64 = case
    batch = trainer.sample()
    params = trainer.params
    loss = trainer.batch_loss(params, *batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
    p64 = {k: v.clone().requires_grad_(True) for k, v in params64.items()}
    loss_ref = bench.loss(spec, p64, tuple(t.long() for t in batch), ref.dropout_seeds(0))
    grads_ref = dict(zip(p64, torch.autograd.grad(loss_ref, list(p64.values()))))
    assert float(loss.detach()) == pytest.approx(float(loss_ref), rel=RTOL)
    norms = {k: float(g.norm()) for k, g in grads_ref.items()}
    median = float(np.median(list(norms.values())))
    for k, g_ref in grads_ref.items():
        g = grads[k] if grads[k] is not None else torch.zeros_like(params[k])
        # weight_k.b's gradient is 0 in exact arithmetic (a row's constant
        # cancels in its softmax): it is held to the median leaf's scale
        scale = norms[k] if k != "weight_k.b" else median
        assert float((g.double() - g_ref).norm()) <= RTOL * scale, k
    assert norms["weight_q.w"] > 1e-3 * median and norms["weight_k.w"] > 1e-3 * median
