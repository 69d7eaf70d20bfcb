"""IGCN (Wu et al.; the reference code's model.py:4107-4220 and
trainer.py:518-561) as the benchmark knows it. The harness loads the module
of a configuration's model by the model's name, lowercased
(``models/<name>.py``, ``core/manifest.py::model``): a traffic kind drives
the program's entry points and asks the model's module for all that is
particular to the model, so another model comes as a module of its own.

Program side, read from the program's objects (this module imports nothing
of the program): ``EPOCH_END``, the epoch-end calls the probe times and
counts; ``shapes``, ``layouts_by_route``, ``step_work`` and ``pass_work``,
the work counts of ``core/roofline.py`` at the model's sizes;
``graph_entries``, the layouts as the program built them;
``first_epoch_end`` and ``capture_train``, what a training check keeps.

Reference side, plain torch and numpy over ``core/reference.py``, float64
(a lower dtype for the control), taking nothing the program made: the
feature matrix and the adjacency from the interactions (``graph``), the
representation (``rep``), the step's objective (``train_spec``, ``loss``),
the sampler's contract (``bad_triples``), and the anneal at the epoch end
(``epoch_end_numbers``, ``epoch_end_control``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn.functional import softplus

from port_bench.core import judge as J
from port_bench.core import reference as ref
from port_bench.core import roofline

EPOCH_END = ("feat_mat_anneal",)


# -- program side ----------------------------------------------------------------------


def shapes(model) -> dict:
    return {
        "n_nodes": model.n_users + model.n_items, "feat_cols": model.feat_n_cols, "feat_nnz": model.feat.nnz,
        "adj_nnz": model.norm_adj.nnz, "d": model.embedding_size, "n_layers": model.n_layers,
    }


def layouts_by_route(model) -> dict:
    """The layout each SpMM route of a step runs on: (rows, cols, nnz, d,
    dropout)."""
    n, d = model.n_users + model.n_items, model.embedding_size
    return {
        "forward_dropout": (n, model.feat_n_cols, model.feat.nnz, d, True),
        "transpose_dropout": (model.feat_n_cols, n, model.feat.nnz, d, True),
        "forward": (n, n, model.norm_adj.nnz, d, False),
    }


def _step_shapes(run) -> dict:
    return dict(shapes(run.model), batch=run.config["trainer"]["batch_size"],
                table_rows=int(run.model.embedding.shape[0]))


def step_work(run) -> roofline.Work:
    return roofline.igcn_step(_step_shapes(run), None)


def pass_work(model, cutoffs) -> roofline.Work:
    return roofline.eval_pass(shapes(model), model.n_users, model.n_items, min(max(cutoffs), model.n_items),
                              len(cutoffs))


def graph_entries(model) -> dict:
    """The feature matrix and the adjacency as built: (keys, values) each."""
    n = model.n_users + model.n_items
    return {"feat": J.entries(model.feat, model.feat_n_cols), "adj": J.entries(model.norm_adj, n)}


def first_epoch_end(run) -> dict:
    """What the check keeps of the first epoch end (set-up's): nothing for
    IGCN, whose anneal is judged from the window's count."""
    return {}


def capture_train(run) -> dict:
    """The feature values after every anneal of the run, both layouts, and
    the count of anneals."""
    m = run.model
    return {"feat": J.entries(m.feat, m.feat_n_cols), "feat_t": J.entries(m.feat.T, m.n_users + m.n_items),
            "anneals": run.probe.calls["feat_mat_anneal"]}


# -- reference side --------------------------------------------------------------------


@dataclasses.dataclass
class Features:
    """IGCN's feature (template) matrix: unweighted counts and row sums."""

    coo: ref.Coo
    row_sum: torch.Tensor  # float64 [n_rows]
    user_dim: int
    n_cols: int


def features(train_array, n_users, n_items, user_map, item_map, device) -> Features:
    """Row u (a user) has a 1 at column user_dim + item_map[i] for each of its
    train items i in the core; row n_users + i (an item) a 1 at user_map[u]
    for each of its train users u in the core; every user row a 1 in column
    user_dim + item_dim, every item row in the column after it."""
    user_map, item_map = np.asarray(user_map, np.int64), np.asarray(item_map, np.int64)
    user_dim, item_dim = int((user_map >= 0).sum()), int((item_map >= 0).sum())
    n_cols = user_dim + item_dim + 2
    u, i = np.asarray(train_array, np.int64).T
    ku, ki = item_map[i] >= 0, user_map[u] >= 0
    rows = np.concatenate([u[ku], n_users + i[ki], np.arange(n_users), n_users + np.arange(n_items)])
    cols = np.concatenate([user_dim + item_map[i[ku]], user_map[u[ki]],
                           np.full(n_users, user_dim + item_dim), np.full(n_items, user_dim + item_dim + 1)])
    rows, cols, counts = ref.unique_pairs(rows, cols, n_cols)
    row_sum = np.bincount(rows, weights=counts, minlength=n_users + n_items)
    coo = ref.coo(rows, cols, counts, n_users + n_items, n_cols, device)
    return Features(coo, torch.as_tensor(row_sum, dtype=ref.F64, device=device), user_dim, n_cols)


def annealed(feat: Features, alpha: float) -> torch.Tensor:
    """The feature values at ``alpha``: count * row_sum[row]^((alpha-1)/2 - 0.5)."""
    rs = torch.clamp(feat.row_sum, min=1e-12)
    return feat.coo.vals * rs[feat.coo.rows] ** ((alpha - 1.0) / 2.0 - 0.5)


def alpha_after(n_anneals: int, delta: float = 0.99) -> float:
    """alpha after ``n_anneals`` epoch ends, multiplied as the model does."""
    alpha = 1.0
    for _ in range(n_anneals):
        alpha *= delta
    return alpha


@dataclasses.dataclass
class Graph:
    feat: Features
    adj: ref.Coo


def graph(data, n_old_users: int, n_old_items: int, device) -> Graph:
    """The layouts over ``data``'s train pairs, with the users and items
    under ``n_old_users`` / ``n_old_items`` as the feature matrix's core."""
    um = np.where(np.arange(data.n_users) < n_old_users, np.arange(data.n_users), -1)
    im = np.where(np.arange(data.n_items) < n_old_items, np.arange(data.n_items), -1)
    train = data.train_array
    return Graph(features(train, data.n_users, data.n_items, um, im, device),
                 ref.adjacency(train, data.n_users, data.n_items, device))


def rep(g: Graph, weights: dict, model_config: dict, alpha: float = 1.0, dtype=ref.F64) -> torch.Tensor:
    """[n_users + n_items, d]: the feature product over the table's rows, then
    the layer mean of the propagation."""
    emb = weights["embedding"].to(g.adj.rows.device, dtype)
    with torch.no_grad():
        x0 = ref.spmm(g.feat.coo, annealed(g.feat, alpha).to(dtype), emb[: g.feat.n_cols])
        return ref.propagate(g.adj, g.adj.vals.to(dtype), x0, model_config["n_layers"])


def graph_gap(entries: dict, g: Graph) -> float:
    """The layouts' values against the reference's (``judge.values_gap``)."""
    return max(J.values_gap(*entries["feat"], g.feat.coo, annealed(g.feat, 1.0)),
               J.values_gap(*entries["adj"], g.adj, g.adj.vals))


def graph_control(g: Graph, dtype) -> dict:
    """The reference's layouts with their values in ``dtype``, as entries."""
    keys = lambda c: (c.rows * c.n_cols + c.cols).cpu().numpy()  # noqa: E731
    return {"feat": (keys(g.feat.coo), annealed(g.feat, 1.0).to(dtype).float().cpu().numpy()),
            "adj": (keys(g.adj), g.adj.vals.to(dtype).float().cpu().numpy())}


@dataclasses.dataclass
class TrainSpec:
    """What the objective needs: the layouts, the model's and trainer's
    numbers."""

    feat: Features
    adj: ref.Coo
    n_users: int
    n_layers: int
    dropout: float
    alpha: float
    l2_reg: float
    aux_reg: float


def train_spec(run) -> TrainSpec:
    data, mc, tc = run.data, run.config["model"], run.config["trainer"]
    g = graph(data, data.n_users, data.n_items, run.device)
    return TrainSpec(g.feat, g.adj, data.n_users, mc["n_layers"], mc["dropout"], 1.0, tc["l2_reg"], tc["aux_reg"])


def cast_spec(spec: TrainSpec, dtype) -> TrainSpec:
    """The layouts' values in ``dtype`` (for the control)."""
    feat = dataclasses.replace(spec.feat, coo=ref.cast_coo(spec.feat.coo, dtype), row_sum=spec.feat.row_sum.to(dtype))
    return dataclasses.replace(spec, feat=feat, adj=ref.cast_coo(spec.adj, dtype))


def objective(spec: TrainSpec, params, batch, seeds):
    """(the objective, the feature product's maker, the batch's propagated
    user rows) of one batch (users, pos, neg, a_users, a_pos, a_neg): BPR +
    L2 on the propagated rows + aux_reg * the auxiliary BPR on the raw core
    rows weighted by w. Each call of the maker draws a dropout mask."""
    emb, w = params["embedding"], params["w"]
    users, pos, neg, a_users, a_pos, a_neg = batch
    n_edges = spec.feat.coo.rows.shape[0]
    base = annealed(spec.feat, spec.alpha)

    def x0():
        vals = base * ref.keep_scale(n_edges, next(seeds), spec.dropout, emb.device) if spec.dropout > 0 else base
        return ref.spmm(spec.feat.coo, vals, emb[: spec.feat.n_cols])

    r = ref.propagate(spec.adj, spec.adj.vals, x0(), spec.n_layers)
    u_r, p_r, n_r = r[users], r[spec.n_users + pos], r[spec.n_users + neg]
    out = ref.bpr(u_r, p_r, n_r)
    if spec.l2_reg:
        out = out + spec.l2_reg * ((u_r * u_r).sum(1) + (p_r * p_r).sum(1) + (n_r * n_r).sum(1)).mean()
    ud = spec.feat.user_dim
    au, ap, an = emb[a_users], emb[ud + a_pos], emb[ud + a_neg]
    aux = softplus((au * an * w).sum(1) - (au * ap * w).sum(1)).mean()
    return out + spec.aux_reg * aux, x0, u_r


def loss(spec: TrainSpec, params, batch, seeds):
    return objective(spec, params, batch, seeds)[0]


def bad_triples(data, batches) -> int:
    """Drawn (user, positive, negative) triples that break the sampler's
    contract: the positive among the user's train items, the negative not
    (the auxiliary batch over the core ids, which here are the ids)."""
    keys = np.unique(data.train_array[:, 0] * data.n_items + data.train_array[:, 1])
    bad = 0
    for b in batches:
        for users, pos, neg in ((b[0], b[1], b[2]), (b[3], b[4], b[5])):
            u, p, n = (t.numpy().astype(np.int64) for t in (users, pos, neg))
            bad += int((~np.isin(u * data.n_items + p, keys)).sum() + np.isin(u * data.n_items + n, keys).sum())
    return bad


def _transpose_keys(feat: Features):
    return (feat.coo.cols * feat.coo.n_rows + feat.coo.rows).cpu().numpy()


def epoch_end_numbers(run, out: dict, spec: TrainSpec, params_end: dict) -> dict:
    """``anneal_gap``: the feature values after the run's anneals, both
    layouts, against the reference's at the same count."""
    vals = annealed(spec.feat, alpha_after(out["anneals"], run.config["model"].get("delta", 0.99)))
    order_t = torch.as_tensor(np.argsort(_transpose_keys(spec.feat), kind="stable"), device=run.device)
    feat_t = ref.Coo(spec.feat.coo.cols[order_t], spec.feat.coo.rows[order_t], None, spec.feat.n_cols,
                     spec.feat.coo.n_rows)
    return {"anneal_gap": max(J.values_gap(*out["feat"], spec.feat.coo, vals),
                              J.values_gap(*out["feat_t"], feat_t, vals[order_t]))}


def epoch_end_control(run, cap: dict, spec: TrainSpec, params_end: dict, dtype) -> dict:
    """The control's feature values (``spec`` already in ``dtype``), in the
    shapes ``capture_train`` gives the program's."""
    alpha = alpha_after(cap["anneals"], run.config["model"].get("delta", 0.99))
    vals = annealed(spec.feat, alpha).float().cpu().numpy()
    keys = (spec.feat.coo.rows * spec.feat.n_cols + spec.feat.coo.cols).cpu().numpy()
    return {"feat": (keys, vals), "feat_t": (_transpose_keys(spec.feat), vals)}
