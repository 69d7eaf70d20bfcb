"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the plain reference (``core/reference.py``) works
out, measured so that rounding in float32 reads small and a lower precision
or a planted fault reads large. Each has its limit in
``limits/<cell>.json``; how the limits were set is in PERF.md.

Everything here takes numpy arrays or tensors the benchmark copied out of
the program; nothing imports the program."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.core import reference as ref

# a leaf whose reference gradient is under this share of the median leaf's
# is left out of the parameters' change: Adam moves it by round-off alone
NEGLIGIBLE_LEAF = 1e-3


def leaf_gap(prog: dict, refs: dict, skip=()) -> float:
    """Worst leaf of |norm(prog) - norm(ref)| over the larger of the leaf's
    reference norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in refs.items()}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k, r in norms.items():
        if k in skip:
            continue
        p = float(torch.linalg.vector_norm(prog[k].to(torch.float64)))
        worst = max(worst, abs(p - r) / max(r, median, 1e-300))
    return worst


def negligible_leaves(grads: dict) -> set:
    norms = {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in grads.items()}
    median = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n < NEGLIGIBLE_LEAF * median}


def entries(mat, n_cols) -> tuple:
    """(keys row * n_cols + col, values) of a CSR layout (``row_ptr``,
    ``col``, ``val``, ``n_rows``), copied to the host."""
    rows = np.repeat(np.arange(mat.n_rows, dtype=np.int64), np.diff(mat.row_ptr.cpu().numpy().astype(np.int64)))
    return rows * n_cols + mat.col.cpu().numpy().astype(np.int64), mat.val.cpu().numpy()


def values_gap(keys_prog: np.ndarray, vals_prog: np.ndarray, coo: ref.Coo, vals_ref: torch.Tensor) -> float:
    """Largest relative gap of a layout's values against the reference's on
    the same (row, col) entries; 1 when the entries themselves differ."""
    keys_ref = (coo.rows * coo.n_cols + coo.cols).cpu().numpy()
    order = np.argsort(keys_prog, kind="stable")
    if len(keys_prog) != len(keys_ref) or not np.array_equal(keys_prog[order], keys_ref):
        return 1.0
    v_ref = vals_ref.cpu().numpy().astype(np.float64)
    v_prog = vals_prog[order].astype(np.float64)
    return float(np.max(np.abs(v_prog - v_ref) / np.maximum(np.abs(v_ref), 1e-300), initial=0.0))


def excluded_rows(users: np.ndarray, excl_lists, n_items: int, banned, device) -> torch.Tensor:
    """bool [len(users), n_items]: each row's excluded items and the banned
    columns."""
    lens = np.fromiter((len(excl_lists[u]) for u in users), dtype=np.int64, count=len(users))
    mask = torch.zeros(len(users), n_items, dtype=torch.bool, device=device)
    if lens.sum():
        flat = np.concatenate([np.asarray(excl_lists[u], np.int64) for u in users])
        rows = np.repeat(np.arange(len(users)), lens)
        mask[torch.as_tensor(rows, device=device), torch.as_tensor(flat, device=device)] = True
    if banned is not None:
        mask[:, torch.as_tensor(np.asarray(banned, np.int64), device=device)] = True
    return mask


def pass_gaps(rep_all, n_users, n_items, p: dict, excl_lists, banned, gt_lists, topks, metrics_prog,
              block=512):
    """(rank gap, metric gap) of one evaluate pass: the widest rank gap over
    its real rows (``reference.rank_gaps``), and the largest absolute gap
    between the program's metrics and those the reference computes from
    the program's own ranked ids and its own ground truth."""
    users, rec = p["users"][p["valid"]], p["rec"][p["valid"]]
    k = rec.shape[1]
    worst = 0.0
    dev = rep_all.device
    for s in range(0, len(users), block):
        u = users[s : s + block]
        ex = excluded_rows(u, excl_lists, n_items, banned, dev)
        gaps = ref.rank_gaps(rep_all, n_users, torch.as_tensor(u, device=dev),
                             torch.as_tensor(rec[s : s + block], device=dev), ex, k)
        worst = max(worst, float(gaps.max()))
    means = ref.metric_means(rec, [gt_lists[u] for u in users], topks)
    mgap = max(abs(means[m][kk] - metrics_prog[m][kk]) for m in means for kk in topks)
    return worst, float(mgap)


def within(numbers: dict, limits: dict) -> dict:
    """{name: (value, limit, ok)} for every number; a number with no limit
    fails."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and np.isfinite(value) and value <= limit
        out[name] = (float(value), None if limit is None else float(limit), bool(ok))
    return out
