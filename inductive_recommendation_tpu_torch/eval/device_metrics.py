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

CUDA tensors run the hand-written kernel of ``ops/csrc/metric_sums.cu`` (two
launches a batch, no host copy, no synchronisation; ``batch_metric_sums_cuda``
counts its launches in ``batch_metric_sums_cuda.launches``); CPU tensors run
the plain PyTorch version, ``batch_metric_sums_reference``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from inductive_recommendation_tpu_torch.ops import _build

MAX_CUTOFFS = 64  # kMaxCutoffs in ops/csrc/metric_sums.cu


def _hits_bsearch(rec, gt_sorted):
    """hits[b, j] = rec[b, j] in gt_sorted[b]: the leftmost position whose
    value is >= rec, then an equality test."""
    m = gt_sorted.shape[1]
    lo = torch.searchsorted(gt_sorted, rec.to(gt_sorted.dtype))
    found = torch.gather(gt_sorted, 1, lo.clamp(max=m - 1))
    return (lo < m) & (found == rec)


def batch_metric_sums_reference(rec, gt_rows, gt_len, valid, topks, sorted_gt=False):
    """Plain PyTorch version of :func:`batch_metric_sums`.

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


def batch_metric_sums_cuda(rec, gt_rows, gt_len, valid, topks, sorted_gt=False):
    """Launch ``csrc/metric_sums.cu`` on the current stream: the per-user
    values at every cutoff, then their sums in a fixed order (so a second
    launch is bitwise the first). ``rec`` int64 (``torch.topk``'s ids),
    ``gt_rows`` and ``gt_len`` int32, ``valid`` bool, on one CUDA device; at most
    ``MAX_CUTOFFS`` cutoffs, each >= 1. Counts two launches a call in
    ``batch_metric_sums_cuda.launches``."""
    device = rec.device
    for name, t in (("rec", rec), ("gt_rows", gt_rows), ("gt_len", gt_len), ("valid", valid)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every operand on {device}")
    for name, t, dtype in (("rec", rec, torch.int64), ("gt_rows", gt_rows, torch.int32), ("gt_len", gt_len, torch.int32),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    B, K = rec.shape
    if gt_rows.ndim != 2 or gt_rows.shape[0] != B or gt_len.shape != (B,) or valid.shape != (B,):
        raise ValueError(f"gt_rows must be [B={B}, m], gt_len and valid [B]; got {tuple(gt_rows.shape)}, "
                         f"{tuple(gt_len.shape)}, {tuple(valid.shape)}")
    if not 1 <= len(topks) <= MAX_CUTOFFS or min(topks) < 1:
        raise ValueError(f"{len(topks)} cutoffs; the kernel takes 1 to {MAX_CUTOFFS}, each >= 1")
    if K < 1 or max(B, K, gt_rows.shape[1]) >= 2**31:
        raise ValueError(f"the kernel takes K >= 1 and int32 sizes; got rec {tuple(rec.shape)}, "
                         f"gt_rows {tuple(gt_rows.shape)}")
    rec, gt_rows, gt_len, valid = (t.contiguous() for t in (rec, gt_rows, gt_len, valid))
    # the per-user values [3 n + 1, B] (scratch), then their sums: [n, 3] and n_valid
    n_out = 3 * len(topks) + 1
    vals = torch.empty(n_out, B, dtype=torch.float32, device=device)
    out = torch.empty(n_out, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _build.load("metric_sums").metric_sums(
            rec.data_ptr(), gt_rows.data_ptr(), gt_len.data_ptr(), valid.data_ptr(), vals.data_ptr(), out.data_ptr(),
            B, K, gt_rows.shape[1], (ctypes.c_int * len(topks))(*topks), len(topks), int(sorted_gt), stream,
        )
    if err != 0:
        raise RuntimeError(f"metric_sums kernel launch failed: cudaError {err}")
    batch_metric_sums_cuda.launches += 1 + (B > 0)
    return out[:-1].view(len(topks), 3), out[-1]


batch_metric_sums_cuda.launches = 0


def batch_metric_sums(rec, gt_rows, gt_len, valid, topks, sorted_gt=False):
    """Per-batch metric partial sums, on the batch's device: the kernel for
    CUDA tensors (or it raises), the plain version for CPU tensors.

    rec:     [B, K] recommended item ids in rank order
    gt_rows: [B, m] ground-truth ids padded with the sentinel n_items
    gt_len:  [B] ground-truth sizes
    valid:   [B] bool, False for the padding users of a short last batch
    returns ([n_topks, 3] fp32 sums of (precision, recall, ndcg), fp32 n_valid)
    """
    kinds = {t.device.type for t in (rec, gt_rows, gt_len, valid)}
    if kinds == {"cuda"}:
        return batch_metric_sums_cuda(rec, gt_rows, gt_len, valid, topks, sorted_gt)
    if kinds == {"cpu"}:
        return batch_metric_sums_reference(rec, gt_rows, gt_len, valid, topks, sorted_gt)
    raise ValueError(f"the metric sums run on cuda or cpu tensors, all on one, not {sorted(kinds)}")


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
