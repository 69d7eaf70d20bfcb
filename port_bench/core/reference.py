"""The plain reference's shared parts, in plain PyTorch and NumPy, float64
(a lower dtype for the control): sparse layouts built from the interaction
arrays, the normalized adjacency, products by ``index_add``, the port's
edge-dropout rule, the BPR and InfoNCE terms, Adam stepped by hand, a loop
that follows the program's first steps, and the evaluation's metrics and
rankings. Each model's own reference (its layouts, representation and
objective) is in ``models/<model>.py`` and builds on these.

It imports nothing of the program and takes nothing the program made. The
benchmark hands it the same inputs it hands the program (the interactions,
the weights, the batches drawn, the dropout seeds' generator seed), and it
reads the program's outputs only to judge them (``core/judge.py``).

Edge dropout follows the program's documented rule (``ops/csr_spmm.py``): an
edge is kept when the top 24 bits of Philox4x32-10's first word, keyed by
the step's 64-bit seed at the counter (edge id, 0, 0, 0), times 2^-24, are
at least p (in float32); the edge id is the edge's rank in (row, column)
order; the seeds are drawn from a CPU ``torch.Generator`` seeded with the
trainer's seed, one for each dropped-out product in the order the forward
runs them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.nn.functional import log_softmax, softplus

F64 = torch.float64

# -- layouts ---------------------------------------------------------------------


@dataclasses.dataclass
class Coo:
    """A sparse matrix as (row, col) sorted by row then column, values."""

    rows: torch.Tensor  # int64
    cols: torch.Tensor  # int64
    vals: torch.Tensor
    n_rows: int
    n_cols: int


def unique_pairs(rows, cols, n_cols):
    keys, counts = np.unique(np.asarray(rows, np.int64) * n_cols + np.asarray(cols, np.int64), return_counts=True)
    return keys // n_cols, keys % n_cols, counts.astype(np.float64)


def adjacency(train_array, n_users, n_items, device) -> Coo:
    """D^-1/2 [[0, R], [R^T, 0]] D^-1/2 with degrees clamped at 1; a repeated
    pair counts its multiplicity."""
    u, i = np.asarray(train_array, np.int64).T
    n = n_users + n_items
    rows, cols, counts = unique_pairs(np.concatenate([u, n_users + i]), np.concatenate([n_users + i, u]), n)
    degree = np.maximum(np.bincount(rows, weights=counts, minlength=n), 1.0)
    vals = counts / np.sqrt(degree[rows]) / np.sqrt(degree[cols])
    return coo(rows, cols, vals, n, n, device)


def coo(rows, cols, vals, n_rows, n_cols, device) -> Coo:
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    return Coo(put(rows, torch.int64), put(cols, torch.int64), put(vals, F64), n_rows, n_cols)


# -- dropout ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    lo, hi = a * (b & 0xFFFF), a * (b >> 16)
    t = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (t >> 32), t & _M32


def philox_word0(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Salmon et al., SC'11), first output word, key = the
    64-bit seed (low word first), counter = (counter, 0, 0, 0)."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    c0 = counter.to(torch.int64)
    c1 = c2 = c3 = torch.zeros_like(c0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def keep_scale(n_edges: int, seed: int, p: float, device) -> torch.Tensor:
    """float64 [n_edges]: 1/(1-p) for a kept edge, 0 for a dropped one."""
    u = (philox_word0(seed, torch.arange(n_edges, device=device)) >> 8).to(F64) * 2.0**-24
    return torch.where(u >= float(np.float32(p)), 1.0 / (1.0 - p), 0.0).to(F64)


def dropout_seeds(trainer_seed: int):
    """The stream of dropout seeds: 62-bit draws of a CPU generator."""
    g = torch.Generator().manual_seed(int(trainer_seed))
    while True:
        yield int(torch.randint(0, 2**62, (), generator=g))


# -- products ------------------------------------------------------------------------


def spmm(coo: Coo, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = x.new_zeros(coo.n_rows, x.shape[1])
    return out.index_add(0, coo.rows, x.index_select(0, coo.cols) * vals.to(x.dtype)[:, None])


def propagate(adj: Coo, adj_vals, x0, n_layers):
    x, acc = x0, x0
    for _ in range(n_layers):
        x = spmm(adj, adj_vals, x)
        acc = acc + x
    return acc / float(n_layers + 1)


# -- training ------------------------------------------------------------------------


def bpr(u, p, n):
    return softplus((u * n).sum(1) - (u * p).sum(1)).mean()


def info_nce(q, p, neg, temperature=0.1):
    def l2n(x):
        return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))

    q, p, neg = l2n(q), l2n(p), l2n(neg)
    logits = torch.cat([(q * p).sum(-1, keepdim=True), q @ neg.T], dim=1) / temperature
    return -log_softmax(logits, dim=1)[:, 0]


class Adam:
    """Adam (Kingma and Ba) at betas 0.9 / 0.999, eps 1e-8, no weight decay."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * self.m[k] / (torch.sqrt(self.v[k] / c2) + self.eps))


def follow_steps(loss, params0, batches, trainer_seed, lr, dtype=F64, keep_after=1):
    """Follows the program's steps from the same weights, batches and dropout
    seeds; ``loss(params, batch, seeds)`` is the model's objective. Returns
    (the loss of every step, the first step's gradients, the parameters
    after step ``keep_after``, the parameters after the last step)."""
    params = {k: v.detach().to(dtype).clone() for k, v in params0.items()}
    opt = Adam(params, lr)
    seeds = dropout_seeds(trainer_seed)
    losses, first_grads, kept = [], None, None
    for batch in batches:
        for p in params.values():
            p.requires_grad_(True)
        value = loss(params, batch, seeds)
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        for p in params.values():
            p.requires_grad_(False)
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(value.detach()))
        if len(losses) == keep_after:
            kept = {k: v.clone() for k, v in params.items()}
    return losses, first_grads, kept, params


def cast_coo(coo: Coo | None, dtype) -> Coo | None:
    """The layout with its values in ``dtype`` (for the control)."""
    return None if coo is None else dataclasses.replace(coo, vals=coo.vals.to(dtype))


# -- evaluation ------------------------------------------------------------------------


def ideal_dcg(k_max: int) -> np.ndarray:
    """IDCG(m) for m = 0..k_max."""
    return np.concatenate([[0.0], np.cumsum(1.0 / np.log2(np.arange(2, k_max + 2)))])


def metric_means(rec: np.ndarray, gt_lists, topks) -> dict:
    """Precision, Recall and NDCG at each cutoff of ranked ids [n, K] against
    ground-truth lists, averaged over the rows whose list is not empty."""
    idcg = ideal_dcg(rec.shape[1])
    disc = 1.0 / np.log2(np.arange(2, rec.shape[1] + 2))
    total = {m: {k: 0.0 for k in topks} for m in ("Precision", "Recall", "NDCG")}
    n = 0
    for row, gt in zip(rec, gt_lists):
        if not len(gt):
            continue
        n += 1
        hits = np.isin(row, np.asarray(gt)).astype(np.float64)
        cum, dcg = np.cumsum(hits), np.cumsum(hits * disc)
        for k in topks:
            kk = min(k, len(row))
            total["Precision"][k] += cum[kk - 1] / k
            total["Recall"][k] += cum[kk - 1] / len(gt)
            total["NDCG"][k] += dcg[kk - 1] / idcg[min(len(gt), k)]
    n = max(n, 1)
    return {m: {k: v / n for k, v in d.items()} for m, d in total.items()}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits, to nearest,
    ties away from zero), as the tensor cores round a TF32 product's
    operands; the product of such operands, summed in float32, is a TF32
    matrix product on any device."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _scores(rep_all, n_users, users, excluded, tf32_operands):
    u_r, i_r = rep_all[users], rep_all[n_users:]
    if tf32_operands:
        u_r, i_r = tf32(u_r), tf32(i_r)
    return (u_r @ i_r.T).masked_fill(excluded, -math.inf), u_r, i_r


def rank_gaps(rep_all, n_users, users, rec, excluded, k: int):
    """For each row: the widest gap by which the j-th returned item's score
    lies below the j-th best eligible score, over the user's |u| * max |i|
    (the scale of a score's rounding); 2 (the largest a gap can be) for a
    row that returns an excluded or repeated item. ``excluded`` [B, n_items]
    bool."""
    scores, u_r, i_r = _scores(rep_all, n_users, users, excluded, False)
    best = torch.topk(scores, k, dim=1).values
    got = torch.gather(scores, 1, rec)
    # a row with fewer than k eligible items is judged on those it has
    eligible = torch.isfinite(best)
    scale = u_r.norm(dim=1) * i_r.norm(dim=1).max()
    diff = torch.where(eligible, best - torch.where(eligible, got, best), 0.0)
    gap = (diff.amax(dim=1) / torch.clamp(scale, min=1e-30)).to(F64)
    srt = torch.sort(rec, dim=1).values
    bad = (eligible & torch.isinf(got)).any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
    return torch.where(bad, torch.full_like(gap, 2.0), gap)


def ranked(rep_all, n_users, users, excluded, k: int, tf32_operands=False):
    """Top-k item ids of each row by score (the control's answers)."""
    return torch.topk(_scores(rep_all, n_users, users, excluded, tf32_operands)[0], k, dim=1).indices
