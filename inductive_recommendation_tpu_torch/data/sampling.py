"""BPR negative sampling on the device (counterpart of
``inductive_recommendation_tpu/data/sampling.py``).

The reference samples on the host in DataLoader workers (dataset.py:119-131):
a uniform user with at least one train item, a uniform positive of that
user, and rejection-sampled negatives. Here a batch is a few torch ops on the
model's device, drawn from an explicit ``torch.Generator`` on that device.

Layout: each user's train items, deduplicated and sorted, one slice per user
of ``items_flat`` (``offsets``/``deg``), O(|E|) memory.

Negatives are exact (no rejection): a rank r is drawn uniformly over the
user's non-positive items and mapped to the item x with r non-positives
before it (x - #{positives < x} == r) by a fixed-iteration binary search
over the user's sorted positives. This is the distribution the reference's
rejection loop converges to, with no false negatives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """The sampler's tensors on one device.

    valid_users: users with deg > 0; the reference resamples until it draws
    one (dataset.py:120-122), and a uniform choice among them is the closed
    form of that loop."""

    items_flat: torch.Tensor  # int64 [E], each user's slice sorted, no duplicates
    offsets: torch.Tensor  # int64 [n_users + 1]
    deg: torch.Tensor  # int64 [n_users]
    valid_users: torch.Tensor  # int64 [n_valid]
    n_items: int
    max_degree: int


def build_sampler_state(train_data, n_items, device="cpu") -> SamplerState:
    """From per-user train item lists. Duplicated items are dropped: the
    complement rank map needs strictly increasing positives."""
    lengths = np.fromiter((len(t) for t in train_data), dtype=np.int64, count=len(train_data))
    if lengths.sum() == 0:
        raise ValueError("no user has a train item: there is nothing to sample")
    users = np.repeat(np.arange(len(train_data), dtype=np.int64), lengths)
    items = np.concatenate([np.asarray(t, np.int64) for t in train_data if len(t)])
    keys = np.unique(users * max(n_items, 1) + items)  # sorted by user, then item
    users, items = keys // max(n_items, 1), keys % max(n_items, 1)
    deg = np.bincount(users, minlength=len(train_data))
    offsets = np.concatenate([[0], np.cumsum(deg)])

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=device)

    return SamplerState(
        items_flat=put(items),
        offsets=put(offsets),
        deg=put(deg),
        valid_users=put(np.nonzero(deg > 0)[0]),
        n_items=int(n_items),
        max_degree=int(deg.max()),
    )


def sample_bpr_batch(state: SamplerState, generator: torch.Generator, batch_size: int, neg_ratio: int = 1):
    """Draw (users [B], pos_items [B], neg_items [B, neg_ratio]), int64, on
    the state's device; ``generator`` must live there too.

    Users are uniform over users with a train item, the positive uniform over
    the user's train items (shared by its neg_ratio negatives), the negatives
    uniform over the user's non-positive items. A user who holds the whole
    catalog has no negative: its ids are clamped to the last item, as the
    JAX package does."""
    dev = state.deg.device

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=generator, device=dev)

    users = state.valid_users[randint(state.valid_users.shape[0], batch_size)]
    pos_slot = randint(1 << 30, batch_size) % state.deg[users]
    pos_items = state.items_flat[state.offsets[users] + pos_slot]

    flat_users = users.repeat_interleave(neg_ratio)
    deg = state.deg[flat_users]
    off = state.offsets[flat_users]
    r = randint(1 << 30, batch_size * neg_ratio) % torch.clamp(state.n_items - deg, min=1)
    # the first j in [0, deg] with P[j] - j > r: the invariant is
    # P[j] - j <= r below lo, and a fixed number of steps covers any degree
    last = state.items_flat.shape[0] - 1
    lo, hi = torch.zeros_like(deg), deg
    for _ in range(int(np.ceil(np.log2(max(2, state.max_degree)))) + 1):
        mid = (lo + hi) // 2
        p_mid = state.items_flat[torch.clamp(off + mid, 0, last)]
        # mid < hi: once lo == hi, mid points one past the user's slice (the
        # next user's items) and must not move lo
        go_right = (p_mid - mid <= r) & (mid < hi)
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    neg = torch.clamp(r + torch.minimum(lo, deg), max=state.n_items - 1)
    return users, pos_items, neg.view(batch_size, neg_ratio)
