"""Item-sharded exact retrieval (counterpart of
``inductive_recommendation_tpu/parallel/eval.py``).

Rank s of the 'model' group scores the user batch against its contiguous
block of item rows, takes a local masked top-k, and only the k candidates of
each rank cross the interconnect (``ops.topk.sharded_topk``). Every rank
holds the whole representation matrix (the evaluator's scoring state) and
reads its item block from it.
"""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.ops.topk import mask_scores, sharded_topk
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size


def pad_items_to_mesh(n_items: int, mesh) -> int:
    S = axis_size(mesh, "model")
    return -(-n_items // S) * S


def make_sharded_recommender(mesh, n_items: int, k: int):
    """-> fn(users_rep [B, d], items_local [n_local, d], exclude [B, L] global
    item ids, banned_local [n_local] bool) -> [B, k] global item ids, the
    same on every rank of the 'model' group.

    ``items_local`` / ``banned_local`` are this rank's block of the item
    rows padded to :func:`pad_items_to_mesh` (pad rows banned). An
    ``exclude`` id outside this rank's block (the ``n_items`` sentinel
    included) is a no-op here."""
    n_local = pad_items_to_mesh(n_items, mesh) // axis_size(mesh, "model")
    shard, group = mesh.get_local_rank("model"), mesh.get_group("model")

    def run(users_rep, items_local, exclude, banned_local):
        scores = users_rep @ items_local.T  # [B, n_local]
        local_e = exclude.long() - shard * n_local
        safe_e = torch.where((local_e >= 0) & (local_e < n_local), local_e, n_local)
        return sharded_topk(mask_scores(scores, safe_e, banned_local), k, group)[1]

    return run


@torch.no_grad()
def sharded_recommend_all_users(mesh, rep, n_users: int, n_items: int, k: int, exclude_rows=None,
                                banned_items=None, batch_size: int = 512) -> np.ndarray:
    """Full-catalog top-k for every user, item-sharded over 'model' ->
    [n_users, min(k, n_items)] int32 numpy, the same on every rank.

    ``rep``: the [(n_users + n_items), d] representation on every rank;
    ``exclude_rows``: padded per-user exclusion ids [n_users, L] (sentinel
    ``n_items``) on the rep's device, or None; ``banned_items``: ids never
    returned."""
    n_pad = pad_items_to_mesh(n_items, mesh)
    n_local = n_pad // axis_size(mesh, "model")
    lo = mesh.get_local_rank("model") * n_local
    items_local = rep.new_zeros(n_local, rep.shape[1])
    hi = min(lo + n_local, n_items)
    if hi > lo:
        items_local[: hi - lo] = rep[n_users + lo : n_users + hi]
    banned = np.zeros(n_pad, dtype=bool)
    banned[n_items:] = True  # pad rows are never retrieved
    if banned_items is not None:
        banned[np.asarray(banned_items, dtype=np.int64)] = True
    banned_local = torch.as_tensor(banned[lo : lo + n_local], device=rep.device)
    recommender = make_sharded_recommender(mesh, n_items, min(k, n_items))
    out = []
    for start in range(0, n_users, batch_size):
        users = torch.arange(start, min(start + batch_size, n_users), device=rep.device)
        exclude = (
            exclude_rows[users]
            if exclude_rows is not None
            else torch.full((users.shape[0], 1), n_pad, dtype=torch.int64, device=rep.device)
        )
        out.append(recommender(rep[users], items_local, exclude, banned_local))
    return torch.cat(out).to(torch.int32).cpu().numpy()
