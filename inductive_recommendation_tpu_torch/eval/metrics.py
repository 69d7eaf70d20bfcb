"""Vectorized top-k ranking metrics (host-side numpy): a copy of
``inductive_recommendation_tpu/eval/metrics.py``, the host oracle.

Exact-parity re-derivation of the reference's per-user python loops
(trainer.py:115-144):

- hit_matrix[u, j] = 1 if rec_items[u, j] in eval_data[u]
- Precision@k = hits/k, Recall@k = hits/|gt|
- NDCG@k = DCG/IDCG with DCG denominators log2(j+2) and ideal DCG over
  min(|gt|, k) leading slots
- every mean is over users with |gt| > 0 only (trainer.py:140-143; the
  reference's mask is min(|gt|, k) > 0 which equals |gt| > 0 for k >= 1)

Membership is one flat binary search: gt pairs are encoded as sorted
``u * S + i`` keys, so the hit matrix for [n_users, K] recommendations costs
O(nK log E) with no python loops. Runs on the host because it is a
once-per-eval O(nK) pass over data that already lives there.
"""

from __future__ import annotations

import numpy as np


def _hit_matrix(rec_items: np.ndarray, eval_data) -> np.ndarray:
    n_users, K = rec_items.shape
    S = np.int64(rec_items.max(initial=0)) + 2
    lengths = np.fromiter((len(l) for l in eval_data), dtype=np.int64, count=n_users)
    if lengths.sum() == 0:
        return np.zeros((n_users, K), dtype=np.float32)
    users_flat = np.repeat(np.arange(n_users, dtype=np.int64), lengths)
    items_flat = np.concatenate(
        [np.asarray(l, dtype=np.int64) for l in eval_data if len(l)]
    )
    # clip gt items beyond the rec id range into the sentinel space so keys
    # stay unique per user but cannot collide with rec keys
    items_flat = np.minimum(items_flat, S - 1)
    gt_keys = np.sort(users_flat * S + items_flat)
    rec_keys = (
        np.arange(n_users, dtype=np.int64)[:, None] * S + rec_items.astype(np.int64)
    ).reshape(-1)
    pos = np.searchsorted(gt_keys, rec_keys)
    pos = np.clip(pos, 0, len(gt_keys) - 1)
    hits = (gt_keys[pos] == rec_keys).astype(np.float32)
    return hits.reshape(n_users, K)


def calculate_metrics(eval_data, rec_items, topks):
    """eval_data: list of per-user ground-truth item lists;
    rec_items: [n_users, K>=max(topks)] recommended item ids.
    Returns {'Precision': {k: float}, 'Recall': {...}, 'NDCG': {...}}.
    """
    rec_items = np.asarray(rec_items, dtype=np.int64)
    n_users, K = rec_items.shape
    gt_len = np.fromiter(
        (len(l) for l in eval_data), dtype=np.float64, count=n_users
    )

    hits = _hit_matrix(rec_items, eval_data)  # [n_users, K]
    denom = 1.0 / np.log2(np.arange(2, K + 2, dtype=np.float64))
    dcg_cum = np.cumsum(hits * denom[None, :], axis=1)
    hit_cum = np.cumsum(hits, axis=1)
    ideal_cum = np.cumsum(denom)

    mask = gt_len > 0
    n_valid = max(int(mask.sum()), 1)

    results = {"Precision": {}, "Recall": {}, "NDCG": {}}
    for k in topks:
        # catalogs smaller than k: the recommendation list ends at K items;
        # cumulative stats saturate there (precision still divides by k)
        kk = min(k, K)
        hit_num = hit_cum[:, kk - 1]
        precision = hit_num / k
        recall = np.divide(hit_num, gt_len, out=np.zeros_like(hit_num), where=mask)
        max_hit = np.minimum(gt_len, k).astype(np.int64)
        idcg = ideal_cum[np.clip(max_hit - 1, 0, K - 1)]
        ndcg = np.divide(
            dcg_cum[:, kk - 1], idcg, out=np.zeros_like(hit_num), where=idcg > 0
        )
        results["Precision"][k] = float(precision[mask].sum() / n_valid)
        results["Recall"][k] = float(recall[mask].sum() / n_valid)
        results["NDCG"][k] = float(ndcg[mask].sum() / n_valid)
    return results
