"""AttIGCN's spans and its query's route on the CPU: a traced step shows
every ``irt.attention.*`` span, the backward ones inside the step's
backward; with no profiler recording the spans change no bit of a step and
open no range; the query's feature product counts under its own route,
``attention_query``, and the adjacency's count is IGCN's."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu_torch.ops import csr_spmm
from inductive_recommendation_tpu_torch.utils import profiling
from inductive_recommendation_tpu_torch.utils.profiling import trace

ROOT = Path(__file__).resolve().parents[1]
MODEL = {"name": "AttIGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0,
         "n_heads": 2}
TRAINER = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
           "n_epochs": 1, "batch_size": 64, "test_batch_size": 32, "topks": [5, 20], "seed": 3}
FORWARD = ("irt.attention.query", "irt.attention.fold", "irt.attention.scores", "irt.attention.softmax",
           "irt.attention.aggregate")
BACKWARD = ("irt.attention.aggregate_backward", "irt.attention.softmax_backward",
            "irt.attention.scores_backward")
EPS = 2e-3  # the trace's microseconds are rounded to 3 decimals


@pytest.fixture(scope="module")
def dataset():
    return quick_synthetic_dataset(70, 90, 1500, seed=5)


def _trainer(dataset, **model):
    return get_trainer(dict(TRAINER), dataset, get_model(dict(MODEL, **model), dataset, device="cpu"))


def _spans(logdir) -> list:
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("name", "").startswith("irt.")]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, outer, prefix) -> list:
    _, a, b = outer
    return [s for s in spans if s is not outer and s[1] >= a - EPS and s[2] <= b + EPS and s[0].startswith(prefix)]


def test_a_traced_step_shows_every_attention_span(tmp_path, dataset):
    trainer = _trainer(dataset)
    trainer.step()  # warm
    with trace(str(tmp_path / "t")):
        for _ in range(2):
            trainer.step()
    spans = _spans(tmp_path / "t")
    assert {s[0] for s in spans if s[0].startswith("irt.attention.")} == set(FORWARD + BACKWARD)
    steps = [s for s in spans if s[0] == "irt.train.step"]
    assert len(steps) == 2
    for step in steps:
        (forward,) = _inside(spans, step, "irt.train.forward")
        (backward,) = _inside(spans, step, "irt.train.backward")
        # the forward's parts once each, in the order the model runs them
        assert [s[0] for s in _inside(spans, forward, "irt.attention.")] == list(FORWARD)
        # the backward runs them in reverse: the aggregation, the softmax, the scores
        assert [s[0] for s in _inside(spans, backward, "irt.attention.")] == list(BACKWARD)
        (query,) = _inside(spans, forward, "irt.attention.query")
        assert len(_inside(spans, query, "irt.ops.spmm")) == 1
        (agg_back,) = _inside(spans, backward, "irt.attention.aggregate_backward")
        assert len(_inside(spans, agg_back, "irt.ops.spmm")) == 1  # d(table) on the transpose


def test_spans_off_change_no_bit_and_open_no_range(tmp_path, dataset, monkeypatch):
    traced, plain = _trainer(dataset), _trainer(dataset)
    with trace(str(tmp_path / "t")):
        traced_losses = [traced.step() for _ in range(3)]
    assert len([s for s in _spans(tmp_path / "t") if s[0] == "irt.attention.softmax_backward"]) == 3
    opened = []
    real = profiling._Recording

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_Recording", counting)
    plain_losses = [plain.step() for _ in range(3)]
    assert opened == []
    for a, b in zip(traced_losses, plain_losses):
        assert torch.equal(a, b)
    for k in traced.params:
        assert torch.equal(traced.params[k], plain.params[k]), k


def _products_by_route(monkeypatch, trainer) -> dict:
    """One step's SpMM products by route (``route_key``), counted where
    every product passes, ``ops.csr_spmm._product``."""
    counts = {}
    real = csr_spmm._product

    def counted(mat, x, edge_scale=None, drop=None):
        key = csr_spmm.route_key(mat, drop)
        counts[key] = counts.get(key, 0) + 1
        return real(mat, x, edge_scale, drop)

    monkeypatch.setattr(csr_spmm, "_product", counted)
    trainer.step()
    monkeypatch.setattr(csr_spmm, "_product", real)
    return counts


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_routes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_query_counts_under_its_own_route(dataset, monkeypatch):
    att = _trainer(dataset)
    igcn = _trainer(dataset, name="IGCN")
    assert "attention_query" in csr_spmm.ROUTES
    model = att.model
    assert csr_spmm.route_key(dataclasses.replace(model.feat, route="attention_query")) == "attention_query"
    assert model.feat.route is None  # the IGCN layouts keep theirs
    got = _products_by_route(monkeypatch, att)
    base = _products_by_route(monkeypatch, igcn)
    layers = 2 * MODEL["n_layers"]  # the adjacency, forward and backward (symmetric: one route)
    assert got == {"attention_query": 1, "forward": layers, "attention": 1, "attention_transpose": 1}
    assert base == {"forward_dropout": 1, "forward": layers, "transpose_dropout": 1}
    assert got["forward"] == base["forward"]
    # chip_smoke.py's launches a step on the card (its model has 3 layers):
    # two a product, by the same routes
    smoke = _chip_smoke()
    want = dict(got, forward=2 * smoke.ATT_CONFIG["n_layers"])
    expected = smoke.STEP_LAUNCHES["AttIGCN"]
    assert {k: v for k, v in expected.items() if "/" not in k} == {k: 2 * v for k, v in want.items()}
