"""Losses (counterpart of ``inductive_recommendation_tpu/train/losses.py``):
BPR, softplus(neg_score - pos_score) (reference trainer.py:278,422);
InfoNCE with unpaired negatives, the ``info-nce-pytorch`` semantics the
reference uses for DOSE (model.py:14, ``InfoNCE(negative_mode='unpaired')``,
temperature 0.1); NeuMF's BCE (trainer.py:592-599) and MultiVAE's
multinomial log-likelihood (trainer.py:630-634)."""

from __future__ import annotations

import torch
from torch.nn.functional import log_softmax, softplus


def bpr_loss(users_r, pos_r, neg_r) -> torch.Tensor:
    """Mean softplus(neg_score - pos_score) over the batch."""
    pos_scores = (users_r * pos_r).sum(dim=1)
    neg_scores = (users_r * neg_r).sum(dim=1)
    return softplus(neg_scores - pos_scores).mean()


def bce_losses(pos_logits, neg_logits) -> torch.Tensor:
    """The softplus BCE terms, positives then negatives (trainer.py:592-599)."""
    return torch.cat([softplus(-pos_logits), softplus(neg_logits)])


def multinomial_ll_loss(scores, profiles, valid=None, n_valid=None) -> torch.Tensor:
    """-sum(profile * log_softmax(scores)) averaged over users; ``valid``
    (optional [B] 0/1 weights) leaves padded batch rows out of the mean, and
    ``n_valid`` (default ``valid.sum()``) is the count the sum is divided by
    (a data-mode slice divides by its whole batch's)."""
    ml = -(profiles * log_softmax(scores, dim=1)).sum(dim=1)
    if valid is None:
        return ml.mean()
    return (ml * valid).sum() / torch.clamp(valid.sum() if n_valid is None else n_valid, min=1.0)


def aux_bpr_rows(au, ap, an, w) -> torch.Tensor:
    """IGCN's auxiliary BPR on gathered core rows (users, positives,
    negatives), scored with the per-dimension weight ``w`` (reference
    trainer.py:542-549)."""
    pos_s = (au * ap * w[None, :]).sum(dim=1)
    neg_s = (au * an * w[None, :]).sum(dim=1)
    return softplus(neg_s - pos_s).mean()


def aux_bpr_w(emb, w, a_users, a_pos, a_neg, user_dim) -> torch.Tensor:
    """:func:`aux_bpr_rows` on the rows of the core embedding table."""
    return aux_bpr_rows(emb[a_users], emb[user_dim + a_pos], emb[user_dim + a_neg], w)


def _l2n(x, eps=1e-12):
    """Rows over their L2 norm, with the clamp under the square root: all-zero
    rows (a user isolated by a drop view) get a zero row and a finite
    gradient."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def info_nce(query, positive_key, negative_keys, temperature: float = 0.1) -> torch.Tensor:
    """Per-sample InfoNCE with unpaired negatives: all rows normalized, the
    logits [q·p, q·N^T] / t, cross-entropy with the positive at index 0.
    Returns [B] losses; the trainers take their mean (trainer.py:289)."""
    q, p, n = _l2n(query), _l2n(positive_key), _l2n(negative_keys)
    pos_logit = (q * p).sum(dim=-1, keepdim=True)  # [B, 1]
    logits = torch.cat([pos_logit, q @ n.T], dim=1) / temperature
    return -log_softmax(logits, dim=1)[:, 0]
