"""The benchmark's data, made from the seed in numpy.

A frozen copy of the port's ``quick_synthetic_dataset`` (power-law users and
items with exponents 0.6 and 0.8, deduplicated pairs, a per-user 80/10/10
split), so that a later change to the program's generator cannot change what
the benchmark runs. The per-user split is vectorized; the arrays are the same
as the program's for the same seed (``tests/test_port_bench_data.py``).

The inductive traffic holds the newest users and items out of the model's
graph: ids at or above ``n_old_users`` / ``n_old_items`` (the least active,
since ids are ranked by activity). An arrival set relabels the new users
among themselves and the new items among themselves by a permutation drawn
from the seed: every set has the same degrees, so the same work, on another
graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Interactions:
    """Per-user train / val / test item lists as flat arrays with offsets,
    and the train pairs [n, 2] (user, item), users ascending."""

    n_users: int
    n_items: int
    train: tuple  # (items int64 [n], offsets int64 [n_users + 1])
    val: tuple
    test: tuple

    @property
    def train_array(self) -> np.ndarray:
        items, offsets = self.train
        users = np.repeat(np.arange(self.n_users, dtype=np.int64), np.diff(offsets))
        return np.stack([users, items], axis=1)

    def lists(self, split: str) -> list:
        """Python lists of item ids, one a user."""
        items, offsets = getattr(self, split)
        return [part.tolist() for part in np.split(items, offsets[1:-1])]


def seed_words(seed: int, *tags: int) -> np.random.SeedSequence:
    """A seed sequence of the run's seed (any non-negative integer) and tags."""
    return np.random.SeedSequence([int(seed), *(int(t) for t in tags)])


def _grouped(users, items, n_users):
    offsets = np.concatenate([[0], np.cumsum(np.bincount(users, minlength=n_users))]).astype(np.int64)
    return np.asarray(items, dtype=np.int64), offsets


# the per-user train / val / test shares, the program's generator's
SPLIT = (0.8, 0.1, 0.1)


def synthetic(n_users: int, n_items: int, n_interactions: int, seed) -> Interactions:
    """The power-law set: ``seed`` is an int or a ``np.random.SeedSequence``."""
    rng = np.random.default_rng(seed)
    u_w = (1.0 / np.arange(1, n_users + 1)) ** 0.6
    i_w = (1.0 / np.arange(1, n_items + 1)) ** 0.8
    users = rng.choice(n_users, size=n_interactions, p=u_w / u_w.sum())
    items = rng.choice(n_items, size=n_interactions, p=i_w / i_w.sum())
    pairs = np.unique(users.astype(np.int64) * n_items + items.astype(np.int64))
    rng.shuffle(pairs)
    users, items = pairs // n_items, pairs % n_items
    order = np.argsort(users, kind="stable")
    users, items = users[order], items[order]
    counts = np.bincount(users, minlength=n_users)
    starts = np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    pos = np.arange(len(users)) - starts
    n = np.repeat(counts, counts)
    n_tr = (n * SPLIT[0]).astype(np.int64)
    n_te = (n * SPLIT[2]).astype(np.int64)
    parts = (pos < n_tr, (pos >= n_tr) & (pos < n - n_te), pos >= n - n_te)
    train, val, test = (_grouped(users[m], items[m], n_users) for m in parts)
    return Interactions(n_users, n_items, train, val, test)


def _relabel(data: Interactions, user_perm, item_perm) -> Interactions:
    """Every list under the new ids, users re-grouped in id order, each
    user's items in their order."""
    out = {}
    for split in ("train", "val", "test"):
        items, offsets = getattr(data, split)
        users = np.repeat(np.arange(data.n_users, dtype=np.int64), np.diff(offsets))
        users, items = user_perm[users], item_perm[items]
        order = np.argsort(users, kind="stable")
        out[split] = _grouped(users[order], items[order], data.n_users)
    return Interactions(data.n_users, data.n_items, **out)


def old_part(data: Interactions, n_old_users: int, n_old_items: int) -> Interactions:
    """The graph before the arrivals: old users and old items only."""
    out = {}
    for split in ("train", "val", "test"):
        items, offsets = getattr(data, split)
        users = np.repeat(np.arange(data.n_users, dtype=np.int64), np.diff(offsets))
        keep = (users < n_old_users) & (items < n_old_items)
        out[split] = _grouped(users[keep], items[keep], n_old_users)
    return Interactions(n_old_users, n_old_items, **out)


def arrival_sets(data: Interactions, n_old_users: int, n_old_items: int, n_sets: int, seed) -> list:
    """``n_sets`` full graphs that agree on the old part: in each, the new
    users and the new items take ids permuted among themselves, drawn from
    ``seed`` and the set's index."""
    sets = []
    for k in range(n_sets):
        rng = np.random.default_rng(seed_words(seed, 7, k))
        user_perm = np.concatenate([np.arange(n_old_users), n_old_users + rng.permutation(data.n_users - n_old_users)])
        item_perm = np.concatenate([np.arange(n_old_items), n_old_items + rng.permutation(data.n_items - n_old_items)])
        sets.append(_relabel(data, user_perm.astype(np.int64), item_perm.astype(np.int64)))
    return sets
