"""Dense user-profile rows built on the device from padded interaction lists
(counterpart of ``inductive_recommendation_tpu/utils/profiles.py``)."""

from __future__ import annotations

import torch


def dense_profiles(padded_items: torch.Tensor, users: torch.Tensor, n_items: int) -> torch.Tensor:
    """fp32 [B, n_items] multi-hot profiles of a user batch.

    ``padded_items`` is [n_users, L] padded with the sentinel ``n_items``: the
    scatter writes the padding into an extra column, which is dropped."""
    rows = padded_items[users].long()
    out = torch.zeros(rows.shape[0], n_items + 1, dtype=torch.float32, device=rows.device)
    out.scatter_(1, rows, 1.0)
    return out[:, :n_items]
