"""BPR losses (counterpart of ``inductive_recommendation_tpu/train/losses.py``):
softplus(neg_score - pos_score), reference trainer.py:278,422."""

from __future__ import annotations

import torch
from torch.nn.functional import softplus


def bpr_loss(users_r, pos_r, neg_r) -> torch.Tensor:
    """Mean softplus(neg_score - pos_score) over the batch."""
    pos_scores = (users_r * pos_r).sum(dim=1)
    neg_scores = (users_r * neg_r).sum(dim=1)
    return softplus(neg_scores - pos_scores).mean()


def aux_bpr_w(emb, w, a_users, a_pos, a_neg, user_dim) -> torch.Tensor:
    """IGCN's auxiliary BPR on the raw core embedding rows, scored with the
    per-dimension weight ``w`` (reference trainer.py:542-549)."""
    au = emb[a_users]
    ap = emb[user_dim + a_pos]
    an = emb[user_dim + a_neg]
    pos_s = (au * ap * w[None, :]).sum(dim=1)
    neg_s = (au * an * w[None, :]).sum(dim=1)
    return softplus(neg_s - pos_s).mean()
