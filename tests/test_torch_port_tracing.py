"""The port's spans (``utils.profiling.span``) on the CPU: where a trainer
step, an evaluation pass and an inductive round put them in the Chrome trace
that ``utils.profiling.trace`` writes, how often the cached builds show, and
that with no profiler recording a span is a shared null context that
changes nothing a step computes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.data.dataset import quick_synthetic_dataset
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.utils import profiling
from inductive_recommendation_tpu_torch.utils.profiling import NullSpan, span, trace

MODEL = {"name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.3, "feature_ratio": 1.0}
TRAINER = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4, "aux_reg": 0.01,
           "n_epochs": 1, "batch_size": 64, "test_batch_size": 32, "topks": [5, 20], "seed": 3}
PHASES = ("irt.train.sample", "irt.train.forward", "irt.train.backward", "irt.train.optimizer")
EPS = 2e-3  # the trace's microseconds are rounded to 3 decimals


@pytest.fixture(scope="module")
def dataset():
    return quick_synthetic_dataset(70, 90, 1500, seed=5)


def _trainer(dataset):
    model = get_model(dict(MODEL), dataset, device="cpu")
    return get_trainer(dict(TRAINER), dataset, model)


def _spans(logdir) -> list:
    """(name, start, end) of the trace's ``irt.`` ranges, in start order."""
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("name", "").startswith("irt.")]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, outer, name=None) -> list:
    _, a, b = outer
    return [s for s in spans if s is not outer and s[1] >= a - EPS and s[2] <= b + EPS
            and (name is None or s[0] == name)]


def _named(spans, name) -> list:
    return [s for s in spans if s[0] == name]


def test_a_steps_spans_nest_in_order(tmp_path, dataset):
    trainer = _trainer(dataset)
    trainer.step()  # warm
    with trace(str(tmp_path / "t")):
        for _ in range(2):
            trainer.step()
    spans = _spans(tmp_path / "t")
    steps = _named(spans, "irt.train.step")
    assert len(steps) == 2
    for step in steps:
        phases = [s for s in _inside(spans, step) if s[0] in PHASES]
        assert [s[0] for s in phases] == list(PHASES)
        for before, after in zip(phases, phases[1:]):
            assert before[2] <= after[1] + EPS
        forward, backward = phases[1], phases[2]
        # IGCN: 1 + n_layers products forward, as many transposes backward
        assert len(_inside(spans, forward, "irt.ops.spmm")) == 3
        assert len(_inside(spans, backward, "irt.ops.spmm")) == 3
        assert len(_inside(spans, forward, "irt.model.get_rep")) == 1
        assert not _inside(spans, phases[0], "irt.ops.spmm")


def test_a_graph_steps_spans_show_the_capture_and_the_replays(tmp_path, dataset, monkeypatch):
    """A step replayed as a CUDA graph (CPU stand-in of
    ``test_torch_port_step_graph.py``): the warm-up step opens the four
    phases as an eager one; the captured step opens the forward and the
    backward inside ``irt.train.capture``, then ``irt.train.replay`` and
    the optimizer; a replayed step opens ``irt.train.sample``,
    ``irt.train.replay`` and ``irt.train.optimizer`` (the stand-in's
    replay runs the step's Python again: its spans inside the replay, which
    a CUDA graph does not open, are left out)."""
    import test_torch_port_step_graph as graph_test

    trainer = graph_test.make_trainer(dataset)
    graph_test.stand_in(monkeypatch)
    with trace(str(tmp_path / "t")):
        for _ in range(4):
            trainer.step()
    spans = _spans(tmp_path / "t")
    steps = _named(spans, "irt.train.step")
    assert len(steps) == 4
    replays = _named(spans, "irt.train.replay")
    inner = [[s[0] for s in _inside(spans, step) if s[0].startswith("irt.train.")
              and not any(s in _inside(spans, r) for r in replays)] for step in steps]
    assert inner[0] == list(PHASES)
    assert inner[1] == ["irt.train.sample", "irt.train.capture", *PHASES[1:3], "irt.train.replay", PHASES[3]]
    assert inner[2] == inner[3] == ["irt.train.sample", "irt.train.replay", PHASES[3]]
    (capture,) = _named(spans, "irt.train.capture")
    assert len(_inside(spans, capture, "irt.ops.spmm")) == 6


def test_an_epochs_end_is_one_span(tmp_path, dataset):
    trainer = _trainer(dataset)
    trainer.steps_per_epoch = 2
    alpha = trainer.model.alpha
    with trace(str(tmp_path / "t")):
        loss = trainer.train_one_epoch()
    assert np.isfinite(loss) and trainer.model.alpha == alpha * MODEL.get("delta", 0.99)
    spans = _spans(tmp_path / "t")
    (end,) = _named(spans, "irt.train.epoch_end")
    assert len(_inside(spans, end, "irt.epoch_end.anneal")) == 1
    assert all(s[2] <= end[1] + EPS for s in _named(spans, "irt.train.step"))


def _batches(evaluator, stage) -> int:
    B = evaluator.test_batch_size
    return sum(-(-perm.shape[0] // B) for perm, _, _ in evaluator._excl_buckets(stage))


def test_evaluate_spans_a_batch_and_builds_once(tmp_path, dataset):
    model = get_model(dict(MODEL), dataset, device="cpu")
    params = model.params()
    with trace(str(tmp_path / "t")):
        evaluator = Evaluator(dataset, [5, 20], 32, device="cpu")
        first = evaluator.evaluate(model, params, "val")[1]
        second = evaluator.evaluate(model, params, "val")[1]
    assert first == second
    spans = _spans(tmp_path / "t")
    assert len(_named(spans, "irt.eval.evaluator_build")) == 1
    passes = _named(spans, "irt.eval.pass")
    assert len(passes) == 2
    n = _batches(evaluator, "val")
    for i, p in enumerate(passes):
        inside = _inside(spans, p)
        for name in ("irt.eval.score", "irt.eval.topk", "irt.eval.metric_sums"):
            assert len([s for s in inside if s[0] == name]) == n, name
        assert len([s for s in inside if s[0] == "irt.eval.refresh"]) == 1
        assert len([s for s in inside if s[0] == "irt.model.get_rep"]) == 1
        for name in ("irt.eval.buckets", "irt.eval.ground_truth"):
            assert len([s for s in inside if s[0] == name]) == (1 if i == 0 else 0), name
    # a batch: score, then top-k, then the sums
    batch = [s[0] for s in _inside(spans, passes[1]) if s[0] in ("irt.eval.score", "irt.eval.topk",
                                                                  "irt.eval.metric_sums")]
    assert batch == ["irt.eval.score", "irt.eval.topk", "irt.eval.metric_sums"] * n


def test_an_inductive_round_shows_the_build_and_ground_truth(tmp_path, dataset):
    model = get_model(dict(MODEL), dataset, device="cpu")
    params = model.params()
    with trace(str(tmp_path / "t")):
        model.attach_dataset(dataset)
        evaluator = Evaluator(dataset, [5, 20], 32, device="cpu")
        slices = evaluator.inductive_eval(model, params, 60, 80, verbose=False)
    assert len(slices) == 6
    spans = _spans(tmp_path / "t")
    (attach,) = _named(spans, "irt.graph.attach")
    for name, count in (("irt.graph.feat_matrix", 1), ("irt.graph.norm_adj", 1), ("irt.graph.csr", 2)):
        assert len(_inside(spans, attach, name)) == count, name
    (norm_adj,) = _named(spans, "irt.graph.norm_adj")
    assert len(_inside(spans, norm_adj, "irt.graph.csr")) == 1
    assert len(_named(spans, "irt.eval.evaluator_build")) == 1
    passes = _named(spans, "irt.eval.pass")
    assert len(passes) == 6
    # the slices' lists once, then each slice's rows on the device (fresh
    # lists: no cache answers); the test stage's buckets once
    truth = _named(spans, "irt.eval.ground_truth")
    assert len(truth) == 7
    assert not any(truth[0] in _inside(spans, p) for p in passes)
    assert all(len(_inside(spans, p, "irt.eval.ground_truth")) == 1 for p in passes)
    assert len(_named(spans, "irt.eval.buckets")) == 1


def test_a_span_off_is_a_shared_null_context(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    a = span("irt.test.off")
    assert a is span("irt.test.off") and isinstance(a, NullSpan)
    assert span("irt.test.other") is not a

    def refused(*args, **kwargs):
        raise AssertionError("a span with no profiler recording made a profiler op or a device call")

    monkeypatch.setattr(profiling, "_Recording", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    with span("irt.test.off") as inside:
        assert inside is None

    @span("irt.test.decorated")
    def twice(x):
        return 2 * x

    assert twice(4) == 8 and twice.__name__ == "twice"


def test_a_function_decorated_under_the_profiler_checks_at_each_call(tmp_path):
    with trace(str(tmp_path / "a")):
        @span("irt.test.late")
        def late(x):
            return x + 1

        assert isinstance(span("irt.test.late"), torch.profiler.record_function)
    assert late(1) == 2  # no profiler now: no range opened
    with trace(str(tmp_path / "b")):
        late(2)
    assert [s[0] for s in _spans(tmp_path / "b")] == ["irt.test.late"]


def test_a_step_is_bit_identical_with_and_without_the_profiler(tmp_path, dataset, monkeypatch):
    """Spans off change nothing: the losses and parameters of steps run
    with no profiler equal, bit for bit, those of the same steps traced; and
    the untraced steps open no profiler range."""
    traced, plain = _trainer(dataset), _trainer(dataset)
    with trace(str(tmp_path / "t")):
        traced_losses = [traced.step() for _ in range(3)]
    assert len(_named(_spans(tmp_path / "t"), "irt.train.step")) == 3
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
