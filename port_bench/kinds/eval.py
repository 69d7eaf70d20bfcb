"""Traffic kind ``eval``: full-catalog evaluation passes back to back
(``Evaluator.evaluate(model, params, stage)``, as the trainer validates
after every epoch): each pass refreshes the representation, scores every
user against every item in batches, excludes the user's known items, takes
the top k_max and sums the metrics at every cutoff.

Set-up builds the model and the evaluator, puts the benchmark's weights in,
and runs one pass (it builds the evaluator's buckets and ground truth,
which a training run builds once too). The window runs passes until the
time is up; the wrapper of the refresh stops it at a pass boundary.

The check: the last pass's ranked ids against the reference's scores in
float64 (the rank gap), and its metrics against the reference's metrics of
the same ids (the metric gap). The reference's representation comes from
the model's module (``run.bench``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.core import data as bench_data
from port_bench.core import judge as J
from port_bench.core import port
from port_bench.core import reference as ref
from port_bench.core import roofline
from port_bench.core.timing import Trace, profiled


def setup(run):
    cfg = run.config
    run.data = bench_data.synthetic(*cfg["data"]["sizes"], bench_data.seed_words(run.seed, 1))
    ds = port.dataset(run.data)
    model = port.build_model(cfg, ds, run.device)
    run.model, run.evaluator = model, port.build_evaluator(cfg, ds, run.device, run.cutoffs())
    run.params = model.params()
    run.weights0 = run.make_weights({k: tuple(v.shape) for k, v in run.params.items()})
    port.load_weights(run.params, run.weights0)
    run.probe.wrap_model_for_eval(model)
    run.probe.keep_passes = 1
    evaluate_pass(run)


def evaluate_pass(run):
    run.last_metrics = run.evaluator.evaluate(run.model, run.params, run.traffic["stage"])[1]


def window(run, seconds):
    probe = run.probe
    passes0 = probe.pass_count
    probe.get_rep_events, probe.get_rep_host_ms = [], []
    run.sync()
    t0 = time.perf_counter()
    probe.open_window(seconds)
    try:
        while True:
            evaluate_pass(run)
    except port.WindowClosed:
        pass
    run.sync()
    run.window_s = time.perf_counter() - t0
    probe.close_window()
    run.units = probe.pass_count - passes0
    return {"eval_users_per_s": run.data.n_users * run.units / run.window_s}


def profile(run) -> Trace:
    n = run.traffic["trace_passes"]
    before = port.route_launches()

    def passes():
        for _ in range(n):
            evaluate_pass(run)

    _, dev, host, wall = profiled(passes, run.device)
    return Trace(dev, host, wall, n, port.launches_since(before))


def pass_work(run) -> roofline.Work:
    return run.bench.pass_work(run.model, run.cutoffs())


def capture(run) -> dict:
    return {"passes": run.probe.finished_passes()[-1:], "metrics": [run.last_metrics]}


def _stage_lists(data, stage):
    if stage == "val":
        return data.lists("train"), data.lists("val")
    train, val = data.lists("train"), data.lists("val")
    return [t + v for t, v in zip(train, val)], data.lists("test")


def reference_rep(run, dtype=torch.float64):
    d = run.data
    return run.bench.rep(run.bench.graph(d, d.n_users, d.n_items, run.device), run.weights0, run.config["model"],
                         dtype=dtype)


def control_outputs(run, cap: dict) -> dict:
    """The control: the reference's ranking with float32 reps and TF32
    score products (``reference.tf32``: the step below the float32 products
    with TF32 off that the configuration states), in the program's place on
    the same users; its metrics are its own ids' (``reference.metric_means``)."""
    rep = reference_rep(run, torch.float32)
    excl, gt = _stage_lists(run.data, run.traffic["stage"])
    passes = []
    for p in cap["passes"]:
        users = p["users"]
        rec = []
        for s in range(0, len(users), 512):
            u = users[s : s + 512]
            ex = J.excluded_rows(u, excl, run.data.n_items, None, run.device)
            rec.append(ref.ranked(rep, run.data.n_users, torch.as_tensor(u, device=run.device), ex,
                                  p["rec"].shape[1], tf32_operands=True).cpu().numpy())
        passes.append(dict(p, rec=np.concatenate(rec)))
    cuts = run.cutoffs()
    metrics = [ref.metric_means(p["rec"][p["valid"]], [gt[u] for u in p["users"][p["valid"]]], cuts)
               for p in passes]
    return {"passes": passes, "metrics": metrics}


def judge(run, out: dict) -> dict:
    rep = reference_rep(run)
    excl, gt = _stage_lists(run.data, run.traffic["stage"])
    cuts = run.cutoffs()
    rank, metric = 0.0, 0.0
    for p, m in zip(out["passes"], out["metrics"]):
        r, g = J.pass_gaps(rep, run.data.n_users, run.data.n_items, p, excl, None, gt, cuts, m)
        rank, metric = max(rank, r), max(metric, g)
    return {"rank_gap": rank, "metric_gap": metric}
