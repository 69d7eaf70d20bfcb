"""Top-k retrieval over a score matrix, with per-row exclusions and banned
columns, and its exact form over an item axis sharded across ranks
(counterpart of ``inductive_recommendation_tpu/ops/topk.py``).

Replaces ``torch.topk`` at reference trainer.py:169 and its -inf masking at
trainer.py:155-167."""

from __future__ import annotations

import torch


def topk_scores(scores: torch.Tensor, k: int):
    """Exact top-k along the last axis; returns (values, indices)."""
    return torch.topk(scores, k, dim=-1)


def mask_scores(scores, exclude_idx=None, banned_mask=None):
    """-inf at the excluded per-row ids and at the banned columns.

    ``exclude_idx`` is [n_rows, m] padded with the sentinel ``n_items``. The
    JAX package drops that out-of-range id (``mode="drop"``); ``scatter_``
    would raise on it, so the scatter goes into one extra column that is
    sliced off again."""
    if banned_mask is not None:
        scores = scores.masked_fill(banned_mask[None, :], float("-inf"))
    if exclude_idx is not None:
        n_rows, n_items = scores.shape
        wide = torch.cat([scores, scores.new_empty(n_rows, 1)], dim=1)
        wide.scatter_(1, exclude_idx.long(), float("-inf"))
        scores = wide[:, :n_items]
    return scores


def masked_topk(scores, k, exclude_idx=None, banned_mask=None):
    """Top-k after masking excluded per-row items and banned items."""
    return topk_scores(mask_scores(scores, exclude_idx, banned_mask), k)


def sharded_topk(local_scores: torch.Tensor, k: int, group):
    """Exact top-k over an item axis split into contiguous blocks over
    ``group`` (JAX ``ops/topk.py:52-76``): ``local_scores`` [rows, n_local]
    are this rank's block. A local top-k, an all-gather of the k candidates
    and their global ids, then the merge: O(ranks * k) per row crosses the
    interconnect, not O(n_items). Returns (values, global indices) [rows, k],
    the same on every rank."""
    import torch.distributed as dist

    from inductive_recommendation_tpu_torch.parallel.collectives import all_gather

    rows, n_local = local_scores.shape
    kk = min(k, n_local)
    local_vals, local_idx = torch.topk(local_scores, kk, dim=-1)
    global_idx = local_idx + dist.get_rank(group) * n_local
    n_dev = dist.get_world_size(group)
    # [n_dev * rows, kk] in rank order -> [rows, n_dev * kk] candidates
    cand_vals = all_gather(local_vals, group).view(n_dev, rows, kk).permute(1, 0, 2).reshape(rows, n_dev * kk)
    cand_idx = all_gather(global_idx, group).view(n_dev, rows, kk).permute(1, 0, 2).reshape(rows, n_dev * kk)
    merged_vals, merged_pos = torch.topk(cand_vals, k, dim=-1)
    return merged_vals, torch.gather(cand_idx, -1, merged_pos)
