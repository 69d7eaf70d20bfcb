"""Top-k retrieval over a score matrix, with per-row exclusions and banned
columns (counterpart of ``inductive_recommendation_tpu/ops/topk.py``).

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
