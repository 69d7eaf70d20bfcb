"""AttIGCN (IGCN with multi-head edge attention on the feature matrix; the
reference code's model.py:4224-4287, which ships the class commented out) as
the benchmark knows it: IGCN's module (``models/igcn.py``, whose docstring
says what a model's module holds) with the attention written out.

The attention, in plain torch and float64 over the reference's own COO
layouts: the query q = Wq(feat @ sg(emb)) with the feature values at alpha 0
(count / row_sum; feature_ratio 1 and alpha 0 are forced by the model,
model.py:4231-4232, so the anneal leaves them), the keys k = Wk(sg(emb)) as
a table (the program folds Wk into the query instead), a score q[r] . k[c]
for each edge and head by per-edge gathers, each row's softmax at T =
sqrt(d) * 10 through a per-row max (``scatter_reduce``) and sum, the head
mean, and the aggregation of the table that is not detached with the
attention as edge values. No dropout: the spec's rep layer takes none. The
L2 term adds ||Wq||^2 + ||Wk||^2 to the rows' (model.py:4283-4286).

At T = 80 the attention lies within about 1e-3 (relative) of the uniform
1/deg, so the IGCN checks cannot see it. Two numbers measure it on its own
scale (``epoch_end_numbers``):

- ``attn_gap``: the program's head-mean attention on every edge (its own
  ``AttIGCN.attention``) at the first checked step's parameters, against
  the reference's: max |attn - attn_ref| over max |attn_ref - 1/deg(row)|,
  so that a uniform attention reads about 1;
- ``att_grad_gap``: the first gradient of ``weight_q.w`` and of
  ``weight_k.w`` (as Adam's first moment holds it), each against its own
  reference: the norm of the difference over the reference's norm, the
  larger of the two.

It holds what the ``train`` kind asks of a model; an ``eval`` or
``inductive`` cell of this model would bring the attention's ``rep``,
``pass_work`` and layouts' checks."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.nn.functional import softplus

from port_bench.core import attention_work
from port_bench.core import judge as J
from port_bench.core import manifest as M
from port_bench.core import reference as ref
from port_bench.core import roofline

igcn = M.beside(__file__, "igcn")

EPOCH_END = igcn.EPOCH_END
first_epoch_end, bad_triples = igcn.first_epoch_end, igcn.bad_triples
ALPHA = 0.0  # the feature values' alpha, pinned by the model
ATT_LEAVES = ("weight_q.w", "weight_k.w")


# -- program side ----------------------------------------------------------------------


def shapes(model) -> dict:
    return dict(igcn.shapes(model), heads=model.n_heads)


def attention_shapes(model) -> dict:
    """The shapes of ``core/attention_work.py``: the feature matrix's rows,
    columns and edges, the adjacency's edges, d, the heads, the layers."""
    s = shapes(model)
    return {"n_rows": s["n_nodes"], "n_cols": s["feat_cols"], "nnz": s["feat_nnz"], "adj_nnz": s["adj_nnz"],
            "d": s["d"], "heads": s["heads"], "n_layers": s["n_layers"]}


def layouts_by_route(model) -> dict:
    """The layout each SpMM route of a step runs on: (rows, cols, nnz, d,
    dropout). The query product and the aggregation run on the feature
    matrix's structure, the layers on the adjacency."""
    n, c, e, d = model.n_users + model.n_items, model.feat_n_cols, model.feat.nnz, model.embedding_size
    return {
        "forward": igcn.layouts_by_route(model)["forward"],
        "attention_query": (n, c, e, d, False),
        "attention": (n, c, e, d, False),
        "attention_transpose": (c, n, e, d, False),
    }


def step_work(run) -> roofline.Work:
    return attention_work.step(dict(attention_shapes(run.model), batch=run.config["trainer"]["batch_size"],
                                    table_rows=int(run.model.embedding.shape[0])))


def capture_train(run) -> dict:
    """IGCN's (the feature values after every anneal, the count of
    anneals) and the program's attention at the first checked step's
    parameters, the benchmark's weights: (keys row * n_cols + col, values)
    on ``att_feat``'s edges."""
    m = run.model
    with torch.no_grad():
        attn = m.attention({k: v.to(run.device) for k, v in run.weights0.items()})
    keys, _ = J.entries(m.att_feat, m.feat_n_cols)
    return dict(igcn.capture_train(run), attn=(keys, attn.float().cpu().numpy()))


# -- reference side --------------------------------------------------------------------


@dataclasses.dataclass
class TrainSpec(igcn.TrainSpec):
    n_heads: int = 4
    temperature: float = 80.0


def train_spec(run) -> TrainSpec:
    base = igcn.train_spec(run)
    mc = run.config["model"]
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields.update(alpha=ALPHA, dropout=0.0)
    return TrainSpec(**fields, n_heads=mc["n_heads"], temperature=math.sqrt(mc["embedding_size"]) * 10.0)


cast_spec = igcn.cast_spec


def attention(spec: TrainSpec, params: dict) -> torch.Tensor:
    """[nnz]: the head-mean attention on the feature COO's edges, in its
    order, in the parameters' dtype; differentiable in Wq and Wk (the
    table enters detached)."""
    coo, h = spec.feat.coo, spec.n_heads
    e = params["embedding"][: spec.feat.n_cols].detach()
    n, d = coo.n_rows, e.shape[1]
    x_q = ref.spmm(coo, igcn.annealed(spec.feat, ALPHA), e)
    q = (x_q @ params["weight_q.w"] + params["weight_q.b"]).reshape(n, h, d)
    k = (e @ params["weight_k.w"] + params["weight_k.b"]).reshape(-1, h, d)
    s = (q.index_select(0, coo.rows) * k.index_select(0, coo.cols)).sum(-1) / spec.temperature  # [nnz, h]
    m = s.new_full((n, h), -math.inf).scatter_reduce(0, coo.rows[:, None].expand(-1, h), s.detach(), "amax")
    ex = torch.exp(s - m.index_select(0, coo.rows))
    total = s.new_zeros(n, h).index_add(0, coo.rows, ex)
    return (ex / total.index_select(0, coo.rows)).mean(1)


def loss(spec: TrainSpec, params, batch, seeds):
    """BPR on the propagated rows of the attention's aggregation + l2_reg *
    (the rows' L2 + ||Wq||^2 + ||Wk||^2) + aux_reg * IGCN's auxiliary BPR on
    the raw core rows weighted by w. No dropout: no seed is drawn."""
    emb, w = params["embedding"], params["w"]
    users, pos, neg, a_users, a_pos, a_neg = batch
    x0 = ref.spmm(spec.feat.coo, attention(spec, params), emb[: spec.feat.n_cols])
    r = ref.propagate(spec.adj, spec.adj.vals, x0, spec.n_layers)
    u_r, p_r, n_r = r[users], r[spec.n_users + pos], r[spec.n_users + neg]
    out = ref.bpr(u_r, p_r, n_r)
    if spec.l2_reg:
        rows = ((u_r * u_r).sum(1) + (p_r * p_r).sum(1) + (n_r * n_r).sum(1)).mean()
        out = out + spec.l2_reg * (rows + (params["weight_q.w"] ** 2).sum() + (params["weight_k.w"] ** 2).sum())
    ud = spec.feat.user_dim
    au, ap, an = emb[a_users], emb[ud + a_pos], emb[ud + a_neg]
    aux = softplus((au * an * w).sum(1) - (au * ap * w).sum(1)).mean()
    return out + spec.aux_reg * aux


def _feat_t(feat: igcn.Features, vals: torch.Tensor):
    """The transpose's layout and values in its (column, row) order."""
    order_t = torch.as_tensor(np.argsort(igcn._transpose_keys(feat), kind="stable"), device=vals.device)
    coo = ref.Coo(feat.coo.cols[order_t], feat.coo.rows[order_t], None, feat.n_cols, feat.coo.n_rows)
    return coo, vals[order_t]


def attn_gap(prog: tuple, feat: igcn.Features, attn_ref: torch.Tensor) -> float:
    """max |attn - attn_ref| over max |attn_ref - 1/deg(row)| on the same
    edges; 1 when the edges themselves differ."""
    coo = feat.coo
    keys_prog, vals_prog = prog
    keys_ref = (coo.rows * coo.n_cols + coo.cols).cpu().numpy()
    order = np.argsort(keys_prog, kind="stable")
    if len(keys_prog) != len(keys_ref) or not np.array_equal(keys_prog[order], keys_ref):
        return 1.0
    a_ref = attn_ref.to(ref.F64).cpu().numpy()
    deg = np.bincount(coo.rows.cpu().numpy(), minlength=coo.n_rows).astype(np.float64)
    spread = np.max(np.abs(a_ref - 1.0 / deg[coo.rows.cpu().numpy()]), initial=0.0)
    return float(np.max(np.abs(vals_prog[order].astype(np.float64) - a_ref), initial=0.0) / max(spread, 1e-300))


def _first_grads(run, spec: TrainSpec) -> dict:
    """The reference's gradients of the first checked step."""
    batch = tuple(t.to(run.device) for t in run.batches[0])
    _, grads, _, _ = ref.follow_steps(lambda p, b, s: loss(spec, p, b, s), run.weights0, [batch],
                                      run.trainer_seed, run.config["trainer"]["lr"])
    return grads


def epoch_end_numbers(run, out: dict, spec: TrainSpec, params_end: dict) -> dict:
    """``anneal_gap`` (the feature values after the run's anneals, both
    layouts, against the reference's at alpha 0), ``attn_gap`` and
    ``att_grad_gap`` (the module's docstring)."""
    vals = igcn.annealed(spec.feat, ALPHA)
    feat_t, vals_t = _feat_t(spec.feat, vals)
    numbers = {"anneal_gap": max(J.values_gap(*out["feat"], spec.feat.coo, vals),
                                 J.values_gap(*out["feat_t"], feat_t, vals_t))}
    w0 = {k: v.to(run.device, ref.F64) for k, v in run.weights0.items()}
    with torch.no_grad():
        numbers["attn_gap"] = attn_gap(out["attn"], spec.feat, attention(spec, w0))
    grads = _first_grads(run, spec)
    gaps = []
    for k in ATT_LEAVES:
        g = out["m1"][k].to(run.device, ref.F64) / (1.0 - 0.9)
        gaps.append(float(torch.linalg.vector_norm(g - grads[k]) / torch.linalg.vector_norm(grads[k])))
    numbers["att_grad_gap"] = max(gaps)
    return numbers


def epoch_end_control(run, cap: dict, spec: TrainSpec, params_end: dict, dtype) -> dict:
    """The control's feature values and attention (``spec`` already in
    ``dtype``), in the shapes ``capture_train`` gives the program's."""
    vals = igcn.annealed(spec.feat, ALPHA)
    keys = (spec.feat.coo.rows * spec.feat.n_cols + spec.feat.coo.cols).cpu().numpy()
    w0 = {k: v.to(run.device, dtype) for k, v in run.weights0.items()}
    with torch.no_grad():
        attn = attention(spec, w0)
    host = lambda t: t.float().cpu().numpy()  # noqa: E731
    return {"feat": (keys, host(vals)), "feat_t": (igcn._transpose_keys(spec.feat), host(vals)),
            "attn": (keys, host(attn))}
