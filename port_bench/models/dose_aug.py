"""DOSE_aug (the fork's model; IGCN's objective plus an InfoNCE of the users
against themselves propagated over a view, the view rebuilt at every epoch
end from the train pairs and the ``aug_num`` user-item pairs of lowest
cosine) as the benchmark knows it: IGCN's module (``models/igcn.py``, whose
docstring says what a model's module holds) with the view added.

The epoch end is judged at the first one, set-up's, after the steps that
the reference follows: its selection against the reference's lowest cosines
from the reference's own parameters after those steps, and the view's
values against the reference's view over the same added pairs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.core import judge as J
from port_bench.core import manifest as M
from port_bench.core import reference as ref
from port_bench.core import roofline

igcn = M.beside(__file__, "igcn")

EPOCH_END = ("feat_mat_anneal", "update_aug_adj")
shapes, pass_work, graph_entries, capture_train = igcn.shapes, igcn.pass_work, igcn.graph_entries, igcn.capture_train
graph, rep, graph_gap, graph_control = igcn.graph, igcn.rep, igcn.graph_gap, igcn.graph_control
bad_triples = igcn.bad_triples


# -- program side ----------------------------------------------------------------------


def _view_layout(model):
    return next(iter(model.views.values()))


def layouts_by_route(model) -> dict:
    out = igcn.layouts_by_route(model)
    n = model.n_users + model.n_items
    out["view"] = (n, n, _view_layout(model).nnz, model.embedding_size, False)
    return out


def step_work(run) -> roofline.Work:
    return roofline.igcn_step(igcn._step_shapes(run), _view_layout(run.model).nnz)


def first_epoch_end(run) -> dict:
    """The view the first epoch end built, and the anneal count its
    selection ran at (the anneal comes first)."""
    m = run.model
    return {"view": J.entries(_view_layout(m), m.n_users + m.n_items),
            "selection_anneals": run.probe.calls["feat_mat_anneal"]}


# -- reference side --------------------------------------------------------------------


@dataclasses.dataclass
class TrainSpec(igcn.TrainSpec):
    view: ref.Coo = None  # the view at the steps followed: the train graph's
    contrastive_reg: float = 0.0


def train_spec(run) -> TrainSpec:
    base = igcn.train_spec(run)
    d = run.data
    return TrainSpec(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
                     view=view(d.train_array, [], d.n_users, d.n_items, run.device),
                     contrastive_reg=run.config["trainer"]["contrastive_reg"])


def cast_spec(spec: TrainSpec, dtype) -> TrainSpec:
    return dataclasses.replace(igcn.cast_spec(spec, dtype), view=ref.cast_coo(spec.view, dtype))


def loss(spec: TrainSpec, params, batch, seeds):
    """IGCN's objective + contrastive_reg * the InfoNCE of the batch's user
    rows against the same users propagated over the view, the feature
    product's dropout drawn anew."""
    out, x0, u_r = igcn.objective(spec, params, batch, seeds)
    v = ref.propagate(spec.view, spec.view.vals, x0(), spec.n_layers)[batch[0]]
    return out + spec.contrastive_reg * ref.info_nce(u_r, v, v).mean()


def view(train_array, add_keys, n_users, n_items, device) -> ref.Coo:
    """The symmetric view over the train pairs and the added pairs (keys u *
    n_items + i), each pair once, normalized by the view's own degrees
    (clamped at 1)."""
    train = np.asarray(train_array, np.int64)
    keys = np.union1d(np.unique(train[:, 0] * n_items + train[:, 1]), np.asarray(add_keys, np.int64))
    u, i = keys // n_items, keys % n_items
    n = n_users + n_items
    rows, cols, _ = ref.unique_pairs(np.concatenate([u, n_users + i]), np.concatenate([n_users + i, u]), n)
    degree = np.maximum(np.bincount(rows, minlength=n).astype(np.float64), 1.0)
    return ref.coo(rows, cols, 1.0 / np.sqrt(degree[rows] * degree[cols]), n, n, device)


def lowest_cosine(users_r, items_r, k: int, block_rows: int = 512):
    """The k lowest cos(user, item) over the whole grid: (keys u * n_items + i
    int64 [k], their cosines, the k-th lowest cosine)."""
    un = users_r / torch.clamp(users_r.norm(dim=1, keepdim=True), min=1e-12)
    itn = items_r / torch.clamp(items_r.norm(dim=1, keepdim=True), min=1e-12)
    n_items = itn.shape[0]
    best_v = torch.empty(0, dtype=un.dtype, device=un.device)
    best_k = torch.empty(0, dtype=torch.int64, device=un.device)
    for start in range(0, un.shape[0], block_rows):
        sims = (un[start : start + block_rows] @ itn.T).reshape(-1)
        vals, flat = torch.topk(-sims, min(k, sims.numel()))
        best_v, pos = torch.topk(torch.cat([best_v, vals]), min(k, best_v.numel() + vals.numel()))
        best_k = torch.cat([best_k, start * n_items + flat])[pos]
    return best_k, -best_v, float(-best_v[-1])


def pair_cosines(users_r, items_r, keys):
    n_items = items_r.shape[0]
    u, i = users_r[keys // n_items], items_r[keys % n_items]
    return (u * i).sum(1) / torch.clamp(u.norm(dim=1) * i.norm(dim=1), min=1e-12)


def _selection_rep(run, spec: TrainSpec, params: dict, anneals: int, dtype):
    alpha = igcn.alpha_after(anneals, run.config["model"].get("delta", 0.99))
    return igcn.rep(igcn.Graph(spec.feat, spec.adj), params, run.config["model"], alpha, dtype)


def _delta_keys(data, keys):
    return np.setdiff1d(keys, np.unique(data.train_array[:, 0] * data.n_items + data.train_array[:, 1]))


def epoch_end_numbers(run, out: dict, spec: TrainSpec, params_end: dict) -> dict:
    """IGCN's anneal, and the first epoch end's selection and view:
    ``sel_gap``, the widest distance from the reference's aug_num-th lowest
    cosine of a pair that only one side added (0 when the added sets
    agree), the reference's cosines taken from its own parameters after the
    steps it followed; ``view_gap``, the view's values against the
    reference's view over the program's added pairs."""
    numbers = igcn.epoch_end_numbers(run, out, spec, params_end)
    d = run.data
    n = d.n_users + d.n_items
    r = _selection_rep(run, spec, params_end, out["selection_anneals"], ref.F64)
    users_r, items_r = r[: d.n_users], r[d.n_users :]
    keys_ref, _, c_k = lowest_cosine(users_r, items_r, run.config["model"]["aug_num"])
    vkeys, _ = out["view"]
    rows, cols = vkeys // n, vkeys % n
    side = (rows < d.n_users) & (cols >= d.n_users)
    prog_delta = _delta_keys(d, rows[side] * d.n_items + cols[side] - d.n_users)
    diff = np.setxor1d(prog_delta, _delta_keys(d, keys_ref.cpu().numpy()))
    cos = pair_cosines(users_r, items_r, torch.as_tensor(diff, device=run.device))
    v = view(d.train_array, prog_delta, d.n_users, d.n_items, run.device)
    numbers["sel_gap"] = float((cos - c_k).abs().max()) if len(diff) else 0.0
    numbers["view_gap"] = J.values_gap(*out["view"], v, v.vals)
    return numbers


def epoch_end_control(run, cap: dict, spec: TrainSpec, params_end: dict, dtype) -> dict:
    """IGCN's anneal in ``dtype``, and the view over the pairs that the
    control's own parameters after the followed steps select, its values in
    ``dtype``."""
    out = igcn.epoch_end_control(run, cap, spec, params_end, dtype)
    d = run.data
    r = _selection_rep(run, spec, params_end, cap["selection_anneals"], dtype).float()
    keys_c, _, _ = lowest_cosine(r[: d.n_users], r[d.n_users :], run.config["model"]["aug_num"])
    v = view(d.train_array, _delta_keys(d, keys_c.cpu().numpy()), d.n_users, d.n_items, run.device)
    out["view"] = ((v.rows * v.n_cols + v.cols).cpu().numpy(), v.vals.to(dtype).float().cpu().numpy())
    return out
