"""Exact top-k (user, item) pairs by cosine similarity over the whole user x
item grid, streamed in blocks of user rows: the DOSE family's selection
(reference model.py:503-545; counterpart of the flat form of
``inductive_recommendation_tpu/ops/cosine_topk.py:51-113``).

Per block, one ``torch.matmul`` gives the [block_rows, n_items] panel of
similarities, one ``torch.topk`` over the flattened panel keeps its best
min(k, block_rows * n_items), and a second ``torch.topk`` merges them with the
best k so far. The JAX package's two-stage (``row_cap``) and threshold-hinted
forms are not ported: both were measured slower than the flat form on the
DOSE selection (``cosine_topk.py:9-32`` there).

Like the JAX package, this is one exact global top-k: the reference's
two-halves split mis-offsets the second half's indices (model.py:537-540).
Ties may break differently from ``lax.top_k``.
"""

from __future__ import annotations

import torch


def _l2_normalize(x, eps=1e-12):
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


@torch.no_grad()
def blockwise_cosine_topk(users_r, items_r, k: int, negate_items: bool = False, block_rows: int = 512):
    """The k largest cos(user, item), streamed ``block_rows`` users at a time;
    ``negate_items=True`` ranks cos(u, -i), i.e. the k *lowest* similarities
    (DOSE_aug's ``all_items_r *= -1``, model.py:509).

    Returns (values fp32 [k] in descending order, user ids int32 [k], item
    ids int32 [k]). A block past the last user is padded with -inf rows, so
    each panel keeps min(k, block_rows * n_items) candidates."""
    n_users, n_items = users_r.shape[0], items_r.shape[0]
    un = _l2_normalize(users_r.float())
    itn = _l2_normalize(items_r.float())
    if negate_items:
        itn = -itn
    dev = un.device
    kk = min(k, block_rows * n_items)
    best_vals = torch.full((k,), float("-inf"), device=dev)
    best_uid = torch.zeros(k, dtype=torch.int64, device=dev)
    best_iid = torch.zeros(k, dtype=torch.int64, device=dev)
    for start in range(0, n_users, block_rows):
        sims = un[start : start + block_rows] @ itn.T  # [rows, n_items]
        pad = block_rows - sims.shape[0]
        if pad:
            sims = torch.cat([sims, sims.new_full((pad, n_items), float("-inf"))])
        vals, flat = torch.topk(sims.reshape(-1), kk)
        cand_vals = torch.cat([best_vals, vals])
        cand_uid = torch.cat([best_uid, start + flat // n_items])
        cand_iid = torch.cat([best_iid, flat % n_items])
        best_vals, pos = torch.topk(cand_vals, k)
        best_uid, best_iid = cand_uid[pos], cand_iid[pos]
    return best_vals, best_uid.int(), best_iid.int()
