"""Ranking-metric partial sums on the device (counterpart of
``inductive_recommendation_tpu/eval/device_metrics.py``).

Each user batch is reduced to per-metric sums where it was scored, so only a
[n_topks, 3] vector and a valid-user count per batch reach the host. The
semantics are those of ``eval/metrics.py::calculate_metrics``:

- hits[u, j]   = rec[u, j] in gt[u]
- Precision@k  = hits_1..k / k
- Recall@k     = hits_1..k / |gt|               (0 when |gt| = 0)
- NDCG@k       = DCG@k / IDCG(min(|gt|, k))     (0 when IDCG = 0)
- sums run over users with |gt| > 0; the caller divides by that count

Membership is a broadcast compare against the ground-truth rows padded with
the sentinel ``n_items`` (never a recommended id). For wide rows
(``sorted_gt=True``, rows sorted ascending) it is a binary search instead.
"""

from __future__ import annotations

import numpy as np
import torch


def _hits_bsearch(rec, gt_sorted):
    """hits[b, j] = rec[b, j] in gt_sorted[b]: the leftmost position whose
    value is >= rec, then an equality test."""
    m = gt_sorted.shape[1]
    lo = torch.searchsorted(gt_sorted, rec.to(gt_sorted.dtype))
    found = torch.gather(gt_sorted, 1, lo.clamp(max=m - 1))
    return (lo < m) & (found == rec)


def batch_metric_sums(rec, gt_rows, gt_len, valid, topks, sorted_gt=False):
    """Per-batch metric partial sums, on the batch's device.

    rec:     [B, K] recommended item ids in rank order
    gt_rows: [B, m] ground-truth ids padded with the sentinel n_items
    gt_len:  [B] ground-truth sizes
    valid:   [B] bool, False for the padding users of a short last batch
    returns ([n_topks, 3] fp32 sums of (precision, recall, ndcg), fp32 n_valid)
    """
    _, K = rec.shape
    device = rec.device
    if sorted_gt:
        hits = _hits_bsearch(rec, gt_rows)
    else:
        hits = (rec[:, :, None] == gt_rows[:, None, :]).any(dim=-1)
    hits = hits.to(torch.float32)

    denom = 1.0 / np.log2(np.arange(2, K + 2, dtype=np.float64))
    denom_j = torch.as_tensor(denom, dtype=torch.float32, device=device)
    ideal_cum = torch.as_tensor(np.cumsum(denom), dtype=torch.float32, device=device)

    hit_cum = torch.cumsum(hits, dim=1)
    dcg_cum = torch.cumsum(hits * denom_j[None, :], dim=1)

    gt_len_f = gt_len.to(torch.float32)
    mask = (gt_len > 0) & valid
    mask_f = mask.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    rows = []
    for k in topks:
        kk = min(k, K)
        hit_num = hit_cum[:, kk - 1]
        precision = hit_num / float(k)
        recall = torch.where(mask, hit_num / torch.clamp(gt_len_f, min=1.0), zero)
        max_hit = torch.clamp(gt_len, max=k)
        idcg = ideal_cum[torch.clamp(max_hit - 1, 0, K - 1).long()]
        ndcg = torch.where(idcg > 0, dcg_cum[:, kk - 1] / idcg, zero)
        rows.append(
            torch.stack(
                [
                    torch.sum(precision * mask_f),
                    torch.sum(recall * mask_f),
                    torch.sum(ndcg * mask_f),
                ]
            )
        )
    return torch.stack(rows), torch.sum(mask_f)


def combine_metric_sums(batch_sums, batch_valids, topks):
    """Host-side: per-batch [n_topks, 3] sums -> the metrics dict (the
    structure of ``eval/metrics.py::calculate_metrics``)."""
    total = np.sum([np.asarray(s, dtype=np.float64) for s in batch_sums], axis=0)
    n_valid = max(float(np.sum([float(v) for v in batch_valids])), 1.0)
    results = {"Precision": {}, "Recall": {}, "NDCG": {}}
    for i, k in enumerate(topks):
        results["Precision"][k] = float(total[i, 0] / n_valid)
        results["Recall"][k] = float(total[i, 1] / n_valid)
        results["NDCG"][k] = float(total[i, 2] / n_valid)
    return results
