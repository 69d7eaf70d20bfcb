"""Top-k retrieval over a score matrix, with per-row exclusions and banned
columns, and its exact form over an item axis sharded across ranks
(counterpart of ``inductive_recommendation_tpu/ops/topk.py``).

Replaces ``torch.topk`` at reference trainer.py:169 and its -inf masking at
trainer.py:155-167.

``masked_topk`` on CUDA tensors runs the hand-written kernel of
``ops/csrc/masked_topk.cu`` (``masked_topk_cuda``: each row's scores read
once, the exclusions applied and the top k selected on chip; one launch a
call where a row fits a block, two where rows are cut; counted in
``masked_topk_cuda.launches``); on CPU tensors the plain version,
``mask_scores`` then ``torch.topk``."""

from __future__ import annotations

import torch

from inductive_recommendation_tpu_torch.ops import _build

MAX_K = 128  # kMaxK in ops/csrc/masked_topk.cu
BLOCK_ITEMS = 49_152  # kMaxItems in ops/csrc/masked_topk.cu: the items one block selects from


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


def n_chunks(n_items: int) -> int:
    """The chunks the kernel cuts a row of ``n_items`` into: 1 (one launch)
    where a block holds the row, else a chunk a block and a second launch
    that merges the chunks' top k."""
    return -(-n_items // BLOCK_ITEMS)


def masked_topk_cuda(scores, k, exclude_idx=None, banned_mask=None):
    """``masked_topk`` by ``csrc/masked_topk.cu`` on the current stream (no
    synchronisation, no host copy): (values [rows, k] fp32, ids [rows, k]
    int64), by descending score, ties by the lower id. ``scores`` fp32
    [rows, n_items]; ``exclude_idx`` int32 [rows, m], ids outside
    [0, n_items) (the sentinel) ignored; ``banned_mask`` bool [n_items];
    1 <= k <= min(MAX_K, n_items). Counts its launches in
    ``masked_topk_cuda.launches``."""
    device = scores.device
    if scores.dtype != torch.float32 or scores.ndim != 2:
        raise TypeError(f"scores must be a 2-D float32 tensor, got {scores.dtype} {tuple(scores.shape)}")
    rows, n_items = scores.shape
    for name, t, dtype, shape in (("exclude_idx", exclude_idx, torch.int32, None),
                                  ("banned_mask", banned_mask, torch.bool, (n_items,))):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every operand on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if (t.shape != shape) if shape else (t.ndim != 2 or t.shape[0] != rows):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; scores are {tuple(scores.shape)}")
    if not 1 <= k <= min(MAX_K, n_items):
        raise ValueError(f"k {k}: the kernel takes 1 <= k <= min({MAX_K}, n_items {n_items})")
    chunks = n_chunks(n_items)
    if (chunks > 1 and chunks * k > BLOCK_ITEMS) or n_items >= 2**31:
        raise ValueError(f"n_items {n_items} at k {k}: the kernel merges at most {BLOCK_ITEMS} candidates a row")
    scores = scores.contiguous()
    m = 0
    if exclude_idx is not None:
        exclude_idx = exclude_idx.contiguous()
        m = exclude_idx.shape[1]
    values = torch.empty(rows, k, dtype=torch.float32, device=device)
    ids = torch.empty(rows, k, dtype=torch.int64, device=device)
    cand_val = cand_id = None
    if chunks > 1:
        cand_val = torch.empty(rows, chunks, k, dtype=torch.float32, device=device)
        cand_id = torch.empty(rows, chunks, k, dtype=torch.int64, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.load("masked_topk").masked_topk
    args = (scores.data_ptr(), ptr(exclude_idx), ptr(banned_mask), ptr(cand_val), ptr(cand_id), values.data_ptr(),
            ids.data_ptr(), rows, n_items, m, k, torch.cuda.current_stream(device).cuda_stream)
    if torch.cuda.current_device() == device.index:
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"masked_topk kernel launch failed: cudaError {err}")
    masked_topk_cuda.launches += (rows > 0) * (1 + (chunks > 1))
    return values, ids


masked_topk_cuda.launches = 0


def masked_topk(scores, k, exclude_idx=None, banned_mask=None):
    """Top-k after masking excluded per-row items and banned items: the
    kernel for CUDA tensors (or it raises), ``mask_scores`` + ``torch.topk``
    for CPU ones."""
    kinds = {t.device.type for t in (scores, exclude_idx, banned_mask) if t is not None}
    if kinds == {"cuda"}:
        return masked_topk_cuda(scores, k, exclude_idx, banned_mask)
    if kinds == {"cpu"}:
        return topk_scores(mask_scores(scores, exclude_idx, banned_mask), k)
    raise ValueError(f"masked_topk runs on cuda or cpu tensors, all on one, not {sorted(kinds)}")


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
