"""Traffic kind ``inductive``: the cold-start refresh. The model is built on
the graph without the newest users and items; each round of the window
attaches a full graph (``model.attach_dataset``: the feature matrix and the
adjacency rebuilt with the new nodes, the core and the table kept), then
runs the six-slice evaluation (``Evaluator.inductive_eval``: all, old and
new users against all items; all users against old and against new items,
and old users against old items, with the other items banned).

Two arrival sets of the same shape (``core.data.arrival_sets``) alternate
round by round, so no round attaches what the last one did. A round builds
the evaluator of its full graph too (the exclusion lists of every user, as
a new dataset needs), after the last round's is dropped. Set-up runs one
round of each set. The window ends after the round in which its time ran
out: a round is judged whole.

The check: the rebuilt layouts and the representation of the last round
against the reference's (the model's module, ``run.bench``, builds them and
compares the layouts), and each slice's ranked ids and metrics as in the
``eval`` kind, with the slice's ground truth and banned items."""

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
    cfg, tr = run.config, run.traffic
    u0, i0 = tr["n_old_users"], tr["n_old_items"]
    full = bench_data.synthetic(*cfg["data"]["sizes"], bench_data.seed_words(run.seed, 1))
    run.old = bench_data.old_part(full, u0, i0)
    run.sets = bench_data.arrival_sets(full, u0, i0, tr["arrival_sets"], run.seed)
    model = port.build_model(cfg, port.dataset(run.old), run.device)
    run.params = model.params()
    run.weights0 = run.make_weights({k: tuple(v.shape) for k, v in run.params.items()})
    port.load_weights(run.params, run.weights0)
    run.model = model
    run.set_ds = [port.dataset(s) for s in run.sets]
    run.probe.wrap_model_for_eval(model)
    run.probe.wrap_attach(model)
    run.probe.pass_deadline = False
    run.probe.keep_passes = 6
    run.rounds = 0
    for _ in run.sets:
        one_round(run)


def one_round(run):
    k, tr = run.rounds % len(run.sets), run.traffic
    run.evaluator = None
    run.model.attach_dataset(run.set_ds[k])
    run.evaluator = port.build_evaluator(run.config, run.set_ds[k], run.device, run.cutoffs())
    run.last_slices = run.evaluator.inductive_eval(run.model, run.params, tr["n_old_users"], tr["n_old_items"],
                                                   verbose=False)
    run.last_set = k
    run.rounds += 1


def window(run, seconds):
    probe = run.probe
    rounds0 = run.rounds
    probe.attach_ms, probe.get_rep_events, probe.get_rep_host_ms = [], [], []
    run.sync()
    t0 = time.perf_counter()
    probe.open_window(seconds)
    try:
        while True:
            one_round(run)
    except port.WindowClosed:
        pass
    run.sync()
    run.window_s = time.perf_counter() - t0
    probe.close_window()
    run.units = 6 * (run.rounds - rounds0)
    return {"eval_users_per_s": run.sets[0].n_users * run.units / run.window_s}


def profile(run) -> Trace:
    before = port.route_launches()
    _, dev, host, wall = profiled(lambda: one_round(run), run.device)
    return Trace(dev, host, wall, 6, port.launches_since(before))


def pass_work(run) -> roofline.Work:
    return run.bench.pass_work(run.model, run.cutoffs())


SLICES = (
    "All users and all items", "Old users and all items", "New users and all items",
    "All users and old items", "All users and new items", "Old users and old items",
)


def capture(run) -> dict:
    return {
        "set": run.last_set,
        "passes": run.probe.finished_passes()[-6:],
        "metrics": [run.last_slices[s] for s in SLICES],
        "graph": run.bench.graph_entries(run.model),
        "rep": run.probe.last_rep.detach().cpu(),
    }


def slices(data, n_old_users, n_old_items):
    """(ground truth lists, banned items or None) of each slice, in order."""
    test = data.lists("test")
    old_u = np.arange(data.n_users) < n_old_users
    ban_new, ban_old = np.arange(n_old_items, data.n_items), np.arange(n_old_items)
    return [
        (test, None),
        ([t if o else [] for t, o in zip(test, old_u)], None),
        ([[] if o else t for t, o in zip(test, old_u)], None),
        ([[i for i in t if i < n_old_items] for t in test], ban_new),
        ([[i for i in t if i >= n_old_items] for t in test], ban_old),
        ([[i for i in t if i < n_old_items] if o else [] for t, o in zip(test, old_u)], ban_new),
    ]


def reference_graph(run, k):
    tr = run.traffic
    return run.bench.graph(run.sets[k], tr["n_old_users"], tr["n_old_items"], run.device)


def reference_rep(run, graph, dtype=torch.float64):
    return run.bench.rep(graph, run.weights0, run.config["model"], dtype=dtype)


def _excluded(data):
    return [t + v for t, v in zip(data.lists("train"), data.lists("val"))]


def control_outputs(run, cap: dict) -> dict:
    """The control in the program's place, each part one step below the
    float32 the configuration states: the rebuilt layouts and the
    representation in bfloat16, the rankings with TF32 score products of
    float32 representations, the metrics of its own ids."""
    k, tr = cap["set"], run.traffic
    d = run.sets[k]
    graph = reference_graph(run, k)
    rep = reference_rep(run, graph, torch.float32)
    excl, cuts = _excluded(d), run.cutoffs()
    passes, metrics = [], []
    for p, (gt, banned) in zip(cap["passes"], slices(d, tr["n_old_users"], tr["n_old_items"])):
        rec = []
        for s in range(0, len(p["users"]), 512):
            u = p["users"][s : s + 512]
            ex = J.excluded_rows(u, excl, d.n_items, banned, run.device)
            rec.append(ref.ranked(rep, d.n_users, torch.as_tensor(u, device=run.device), ex, p["rec"].shape[1],
                                  tf32_operands=True).cpu().numpy())
        q = dict(p, rec=np.concatenate(rec))
        passes.append(q)
        metrics.append(ref.metric_means(q["rec"][q["valid"]], [gt[u] for u in q["users"][q["valid"]]], cuts))
    low = torch.bfloat16
    return dict(cap, passes=passes, metrics=metrics, rep=reference_rep(run, graph, low).float().cpu(),
                graph=run.bench.graph_control(graph, low))


def judge(run, out: dict) -> dict:
    k, tr = out["set"], run.traffic
    d = run.sets[k]
    graph = reference_graph(run, k)
    rep = reference_rep(run, graph)
    got = out["rep"].to(run.device, torch.float64)
    if got.shape == rep.shape:
        rep_gap = float((got - rep).abs().max() / rep.abs().max())
    else:  # a layout that was never rebuilt: the missing rows read as zeros
        fill = torch.zeros_like(rep)
        n = min(got.shape[0], rep.shape[0])
        fill[:n] = got[:n]
        rep_gap = float((fill - rep).abs().max() / rep.abs().max())
    excl, cuts = _excluded(d), run.cutoffs()
    rank, metric = 0.0, 0.0
    for p, m, (gt, banned) in zip(out["passes"], out["metrics"], slices(d, tr["n_old_users"], tr["n_old_items"])):
        r, g = J.pass_gaps(rep, d.n_users, d.n_items, p, excl, banned, gt, cuts, m)
        rank, metric = max(rank, r), max(metric, g)
    if len(out["passes"]) < len(SLICES):
        rank = metric = 2.0
    return {
        "layout_gap": run.bench.graph_gap(out["graph"], graph),
        "rep_gap": rep_gap,
        "rank_gap": rank,
        "metric_gap": metric,
    }
