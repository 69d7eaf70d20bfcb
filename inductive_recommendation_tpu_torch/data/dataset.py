"""Datasets (counterpart of ``inductive_recommendation_tpu/data/dataset.py``):
raw parsers, the k-core filter, the chronological split and the pre-split
files.

A dataset is host data: per-user item lists for train/val/test and the
``[n_train, 2]`` train pair array, all numpy or Python lists. Only the padded
per-user matrices that evaluation needs go to a device
(:func:`device_padded_from_lists`).

The semantics are those of the reference's dataset.py, as the JAX package
reproduces them:

- ``remove_sparse_ui``: the k-core (every kept user and item has >=
  min_inter distinct interactions), then dense ids in first-seen order
  (dataset.py:66-92);
- repeated (user, item) pairs keep the earliest timestamp, a user's list in
  first-seen order (dataset.py:28-37);
- ``generate_data``: each user's list sorted by time (stable), optionally
  shuffled with the GLOBAL ``np.random`` stream (seeded by
  ``utils.run.set_seed``), then split (dataset.py:94-114). Two reference
  quirks are kept: a user with ``int(n * split_ratio[2]) == 0`` gets the
  whole list as test (``lst[-0:]``) and an empty val split
  (``lst[n_train:-0]``);
- ``ProcessedDataset``: pre-split train/val/test.txt, n_items = max id + 1
  across the files (dataset.py:140-164);
- the raw parsers for Gowalla / Yelp / Amazon-Books (dataset.py:167-255), with
  UTC timestamps where the reference's ``time.mktime`` used the host's
  timezone (only the order feeds the split).

The JAX package builds each user's list with Python dicts, one interaction at
a time. Here the k-core, the deduplication and the split run vectorized over
the interaction arrays, with the same ids in the same order and
byte-identical output files; the per-interaction forms
(:func:`update_ui_sets`, :func:`update_user_inter_lists`,
:func:`build_user_inter_lists`) are kept as their reference.
"""

from __future__ import annotations

import calendar
import json
import os
import time

import numpy as np
import torch

from inductive_recommendation_tpu_torch.native import (
    kcore_masks,
    parse_adjacency_file,
    parse_amazon_file,
    parse_gowalla_file,
    parse_yelp_file,
)


def get_dataset(config):
    """Registry factory keyed by config['name'] (reference dataset.py:10-14)."""
    config = dict(config)
    return DATASETS[config["name"]](config)


def update_ui_sets(u, i, user_inter_sets, item_inter_sets):
    user_inter_sets.setdefault(u, set()).add(i)
    item_inter_sets.setdefault(i, set()).add(u)


def update_user_inter_lists(u, i, t, user_map, item_map, user_inter_lists):
    """Per-interaction reference form (dataset.py:28-37): a repeated (u, i)
    keeps the earliest timestamp."""
    if u in user_map and i in item_map:
        lst = user_inter_lists[user_map[u]]
        for entry in lst:
            if entry[0] == item_map[i]:
                entry[1] = min(entry[1], t)
                return
        lst.append([item_map[i], t])


def build_user_inter_lists(triples, user_map, item_map, n_users):
    """Bulk form of :func:`update_user_inter_lists` with the same output:
    [[item, earliest t], ...] per user, in first-seen order."""
    user_inter_lists = [[] for _ in range(n_users)]
    by_item = [{} for _ in range(n_users)]
    for u, i, t in triples:
        cu, ci = user_map.get(u), item_map.get(i)
        if cu is None or ci is None:
            continue
        entry = by_item[cu].get(ci)
        if entry is None:
            entry = by_item[cu][ci] = [ci, t]
            user_inter_lists[cu].append(entry)
        elif t < entry[1]:
            entry[1] = t
    return user_inter_lists


def output_data(file_path, data):
    """'user item item ...' rows (dataset.py:40-44)."""
    with open(file_path, "w") as f:
        for user in range(len(data)):
            f.write(" ".join([str(user)] + [str(item) for item in data[user]]) + "\n")


def first_seen_ids(ids):
    """(distinct values of ``ids`` in order of first appearance, each entry's
    index into them)."""
    uniq, first, inverse = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return uniq[order], rank[inverse.reshape(-1)]


def intern(values):
    """Hashable ids (strings) -> int64 ids numbered in first-seen order."""
    ids = {}
    return np.fromiter((ids.setdefault(v, len(ids)) for v in values), dtype=np.int64, count=len(values))


class BasicDataset:
    """Base dataset: per-user train/val/test item lists and the train pair
    array. ``__len__`` is the number of train pairs (the epoch size).
    ``negative_sample_ratio`` is the config's ``neg_ratio`` (default 1), the
    negatives ``BCETrainer`` draws per positive."""

    def __init__(self, dataset_config):
        self.config = dataset_config
        self.name = dataset_config["name"]
        self.min_interactions = dataset_config.get("min_inter")
        self.split_ratio = dataset_config.get("split_ratio")
        self.negative_sample_ratio = dataset_config.get("neg_ratio", 1)
        self.shuffle = dataset_config.get("shuffle", False)
        self.n_users = 0
        self.n_items = 0
        self.train_data = None
        self.val_data = None
        self.test_data = None
        self.train_array = None

    def _init_from_interned(self, users, items, ts):
        """Finish construction from the kept interactions (int ids, in file
        order): k-core, then the split."""
        cu, ci = self.remove_sparse_ui(users, items)
        self.generate_data(cu, ci, ts)

    # -- k-core filtering (dataset.py:66-92) --------------------------------
    def remove_sparse_ui(self, users, items):
        """The (min_inter)-core of the interactions' distinct (user, item)
        pairs (native peel, ``native.kcore_masks``), kept users and items
        numbered in first-seen order. Sets ``n_users``/``n_items``; returns
        each interaction's (dense user, dense item), -1 where filtered."""
        if self.min_interactions is None:
            raise ValueError(
                f"dataset '{self.name}' applies k-core filtering and requires 'min_inter' in its config "
                "(reference config.py sets it per dataset, e.g. 10 for Gowalla)"
            )
        user_ids, u = first_seen_ids(users)
        item_ids, i = first_seen_ids(items)
        n_u, n_i = len(user_ids), len(item_ids)
        pairs = np.unique(u * n_i + i)
        keep_u, keep_i = kcore_masks(pairs // n_i, pairs % n_i, n_u, n_i, self.min_interactions)
        self.n_users, self.n_items = int(keep_u.sum()), int(keep_i.sum())
        user_map = np.where(keep_u, np.cumsum(keep_u) - 1, -1)
        item_map = np.where(keep_i, np.cumsum(keep_i) - 1, -1)
        return user_map[u], item_map[i]

    # -- chronological split (dataset.py:94-114) ----------------------------
    def generate_data(self, users, items, ts):
        """Per-user chronological split of interactions with dense ids (-1:
        filtered), in file order. A repeated pair keeps its earliest time and
        its first position; each user's list is ordered by (time, first
        position), then shuffled if the config says so."""
        keep = (users >= 0) & (items >= 0)
        key = users[keep] * self.n_items + items[keep]
        ts = np.asarray(ts, dtype=np.int64)[keep]
        pairs, first = np.unique(key, return_index=True)
        by_time = np.lexsort((ts, key))  # each pair's earliest time leads its run
        starts = np.flatnonzero(np.diff(key[by_time], prepend=-1))
        t_min = ts[by_time][starts]
        user, item = pairs // self.n_items, pairs % self.n_items
        order = np.lexsort((first, t_min, user))
        user, item = user[order], item[order]
        counts = np.bincount(user, minlength=self.n_users)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        if self.shuffle:
            # reference parity (dataset.py:102-103): the GLOBAL np.random
            # stream, user by user; shuffling the positions takes the same
            # draws as shuffling the list
            for u in range(self.n_users):
                perm = np.arange(counts[u])
                np.random.shuffle(perm)
                item[offsets[u] : offsets[u + 1]] = item[offsets[u] + perm]
        n_train = (counts * self.split_ratio[0]).astype(np.int64)
        n_test = (counts * self.split_ratio[2]).astype(np.int64)
        pos = np.arange(len(item)) - np.repeat(offsets[:-1], counts)
        n_train, n_test, n = (np.repeat(a, counts) for a in (n_train, n_test, counts))
        # lst[:n_train], lst[n_train:-n_test] and lst[-n_test:], where
        # -0 makes val empty and test the whole list
        in_train = pos < n_train
        in_val = (n_test > 0) & (pos >= n_train) & (pos < n - n_test)
        in_test = (n_test == 0) | (pos >= n - n_test)
        self.train_data, self.val_data, self.test_data = (
            self._lists(user[m], item[m]) for m in (in_train, in_val, in_test)
        )
        self.train_array = np.stack([user[in_train], item[in_train]], axis=1)
        avg = float(counts.mean()) if self.n_users else 0.0
        print(
            "Users {:d}, Items {:d}, Average number of interactions {:.3f}, "
            "Total interactions {:.1f}".format(self.n_users, self.n_items, avg, avg * self.n_users)
        )

    def _lists(self, users, items):
        """Per-user Python lists of ``items`` (grouped by ``users``, in order)."""
        if not self.n_users:
            return []
        bounds = np.cumsum(np.bincount(users, minlength=self.n_users))[:-1]
        return [part.tolist() for part in np.split(items, bounds)]

    def __len__(self):
        return len(self.train_array)

    def output_dataset(self, path):
        os.makedirs(path, exist_ok=True)
        output_data(os.path.join(path, "train.txt"), self.train_data)
        output_data(os.path.join(path, "val.txt"), self.val_data)
        output_data(os.path.join(path, "test.txt"), self.test_data)


class ProcessedDataset(BasicDataset):
    """Pre-split train.txt / val.txt / test.txt under config['path'], read
    by the native parser; n_items = max item id + 1 across the three files."""

    def __init__(self, dataset_config):
        super().__init__(dataset_config)
        path = dataset_config["path"]
        self.train_data, flat, offs = self._read(os.path.join(path, "train.txt"))
        self.val_data, _, _ = self._read(os.path.join(path, "val.txt"))
        self.test_data, _, _ = self._read(os.path.join(path, "test.txt"))
        if not len(self.train_data) == len(self.val_data) == len(self.test_data):
            raise ValueError(f"train/val/test files under {path} differ in their number of users")
        self.n_users = len(self.train_data)
        users = np.repeat(np.arange(self.n_users, dtype=np.int64), np.diff(offs))
        self.train_array = np.stack([users, flat], axis=1)

    def _read(self, file_path):
        flat, offs = parse_adjacency_file(file_path)
        if len(flat):
            self.n_items = max(self.n_items, int(flat.max()) + 1)
        lists = [part.tolist() for part in np.split(flat, offs[1:-1])]
        return lists, flat, offs

    def read_data(self, file_path):
        return self._read(file_path)[0]


class GowallaDataset(BasicDataset):
    """Gowalla_totalCheckins.txt: TSV (user, time, lat, lon, item)
    (dataset.py:167-189), through the native fixed-format parser."""

    def __init__(self, dataset_config):
        super().__init__(dataset_config)
        path = os.path.join(dataset_config["path"], "Gowalla_totalCheckins.txt")
        self._init_from_interned(*parse_gowalla_file(path))


class YelpDataset(BasicDataset):
    """yelp_academic_dataset_review.json, one review a line; keeps stars > 3
    (dataset.py:192-225). The native parser reads the file; where it declines,
    each line is decoded ONCE with ``json.loads`` (the reference decodes it
    twice) and times are UTC (``calendar.timegm``)."""

    def __init__(self, dataset_config):
        super().__init__(dataset_config)
        path = os.path.join(dataset_config["path"], "yelp_academic_dataset_review.json")
        parsed = parse_yelp_file(path)
        if parsed is None:
            kept = []
            with open(path, "r") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        record = json.loads(line)
                        if float(record["stars"]) > 3.0:
                            kept.append((record["user_id"], record["business_id"], record["date"]))
            ts = [calendar.timegm(time.strptime(date, "%Y-%m-%d %H:%M:%S")) for _, _, date in kept]
            parsed = intern([k[0] for k in kept]), intern([k[1] for k in kept]), np.asarray(ts, dtype=np.int64)
        self._init_from_interned(*parsed)


class AmazonDataset(BasicDataset):
    """ratings_Books.csv: (user, item, rating, ts); keeps rating > 3
    (dataset.py:228-255), native parser first, then the exact Python one."""

    def __init__(self, dataset_config):
        super().__init__(dataset_config)
        path = os.path.join(dataset_config["path"], "ratings_Books.csv")
        parsed = parse_amazon_file(path)
        if parsed is None:
            kept = []
            with open(path, "r") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        u, i, r, t = line.split(",")
                        if float(r) > 3.0:
                            kept.append((u, i, t))
            parsed = (
                intern([k[0] for k in kept]),
                intern([k[1] for k in kept]),
                np.asarray([int(k[2]) for k in kept], dtype=np.int64),
            )
        self._init_from_interned(*parsed)


class SyntheticDataset(BasicDataset):
    """Power-law random bipartite graph with random timestamps, through the
    whole BasicDataset pipeline (not in the reference, which ships no data).

    Config keys: n_users, n_items, n_interactions, seed, split_ratio, and
    optional min_inter (the k-core applies when it is set; without it users
    and items are numbered in sorted order, as in the JAX package)."""

    def __init__(self, dataset_config):
        super().__init__(dataset_config)
        rng = np.random.default_rng(dataset_config.get("seed", 0))
        n_users, n_items = dataset_config["n_users"], dataset_config["n_items"]
        n_inter = dataset_config["n_interactions"]
        u_w = (1.0 / np.arange(1, n_users + 1)) ** 0.6
        i_w = (1.0 / np.arange(1, n_items + 1)) ** 0.8
        users = rng.choice(n_users, size=n_inter, p=u_w / u_w.sum())
        items = rng.choice(n_items, size=n_inter, p=i_w / i_w.sum())
        times = rng.integers(0, 10_000_000, size=n_inter)
        if self.min_interactions:
            self._init_from_interned(users, items, times)
            return
        user_ids, cu = np.unique(users, return_inverse=True)
        item_ids, ci = np.unique(items, return_inverse=True)
        self.n_users, self.n_items = len(user_ids), len(item_ids)
        self.generate_data(cu, ci, times)


class AuxiliaryDataset(BasicDataset):
    """Train interactions remapped to a model's core (template) id space
    (reference dataset.py:258-273): user ``user_map[u]`` holds ``item_map[i]``
    for each train item i of user u with both maps >= 0, in u's order.
    ``user_map``/``item_map`` are dense -1-padded arrays; ``len`` is the
    source's epoch size."""

    def __init__(self, dataset, user_map, item_map):
        super().__init__({"name": "AuxiliaryDataset"})
        user_map = np.asarray(user_map, dtype=np.int64)
        item_map = np.asarray(item_map, dtype=np.int64)
        self.n_users = int((user_map >= 0).sum())
        self.n_items = int((item_map >= 0).sum())
        self.length = len(dataset)
        lengths = [len(t) for t in dataset.train_data]
        users = np.repeat(user_map[: len(lengths)], lengths)
        items = np.concatenate([np.asarray(t, np.int64) for t in dataset.train_data] + [np.zeros(0, np.int64)])
        items = item_map[items]
        keep = (users >= 0) & (items >= 0)
        users, items = users[keep], items[keep]
        # a map is one-to-one, so a stable sort by core user keeps each
        # user's items in order
        order = np.argsort(users, kind="stable")
        users, items = users[order], items[order]
        offsets = np.concatenate([[0], np.cumsum(np.bincount(users, minlength=self.n_users))])
        self.train_data = [items[offsets[u] : offsets[u + 1]].tolist() for u in range(self.n_users)]
        self.train_array = np.stack([users, items], axis=1)

    def __len__(self):
        return self.length


def _flatten_ragged(lists, pad_to):
    """(flat, rows, slots, lengths, pad_to) for ragged per-user lists. Raises
    on a ``pad_to`` narrower than the longest row."""
    lengths = np.fromiter((len(l) for l in lists), dtype=np.int64, count=len(lists))
    max_len = int(lengths.max(initial=0))
    if pad_to is None:
        pad_to = max(1, max_len)
    elif pad_to < max_len:
        raise ValueError(f"pad_to {pad_to} < longest row {max_len}")
    if lengths.sum() == 0:
        return None, None, None, lengths, pad_to
    flat = np.concatenate([np.asarray(l, dtype=np.int32) for l in lists if len(l)])
    rows = np.repeat(np.arange(len(lists), dtype=np.int64), lengths)
    slots = np.arange(len(flat), dtype=np.int64) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    return flat, rows, slots, lengths, pad_to


def device_padded_from_lists(lists, n_items, pad_to=None, device="cpu"):
    """[n_users, L] int32 item matrix padded with the sentinel ``n_items``,
    filled on ``device`` from the O(E) flat components (uploading the dense
    padded matrix would move O(n_users * L))."""
    flat, rows, slots, _, pad_to = _flatten_ragged(lists, pad_to)
    padded = torch.full((len(lists), pad_to), n_items, dtype=torch.int32, device=device)
    if flat is not None:
        rows_t = torch.as_tensor(rows, device=device)
        slots_t = torch.as_tensor(slots, device=device)
        padded[rows_t, slots_t] = torch.as_tensor(flat, device=device)
    return padded


def pad_user_lists(lists, n_items, pad_to=None, sort=True):
    """Ragged per-user item lists -> ([n_users, L] int32 padded with the
    sentinel ``n_items``, int32 lengths), numpy. Rows are sorted by default."""
    flat, rows, slots, lengths, pad_to = _flatten_ragged(lists, pad_to)
    padded = np.full((len(lists), pad_to), n_items, dtype=np.int32)
    if flat is not None:
        padded[rows, slots] = flat
        if sort:
            padded.sort(axis=1)
    return padded, lengths.astype(np.int32)


def quick_synthetic_dataset(
    n_users,
    n_items,
    n_interactions,
    seed=0,
    split_ratio=(0.8, 0.1, 0.1),
    name="QuickSynthetic",
    neg_ratio=1,
):
    """Deduped random power-law bipartite graph with a per-user random split,
    built in numpy. The same seed gives the same arrays as the JAX package's
    ``quick_synthetic_dataset``; ``neg_ratio`` goes to the dataset config."""
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
    starts = np.concatenate([[0], np.cumsum(counts)])

    ds = BasicDataset({"name": name, "split_ratio": list(split_ratio), "neg_ratio": neg_ratio})
    ds.n_users, ds.n_items = n_users, n_items
    ds.train_data = [[] for _ in range(n_users)]
    ds.val_data = [[] for _ in range(n_users)]
    ds.test_data = [[] for _ in range(n_users)]
    train_rows = []
    for u in range(n_users):
        row = items[starts[u] : starts[u + 1]]
        n = len(row)
        n_tr = int(n * split_ratio[0])
        n_te = int(n * split_ratio[2])
        ds.train_data[u] = row[:n_tr].tolist()
        ds.val_data[u] = row[n_tr : n - n_te].tolist()
        ds.test_data[u] = row[n - n_te :].tolist()
        if n_tr:
            train_rows.append(np.stack([np.full(n_tr, u, dtype=np.int64), row[:n_tr]], axis=1))
    ds.train_array = (
        np.concatenate(train_rows, axis=0) if train_rows else np.zeros((0, 2), np.int64)
    )
    return ds


DATASETS = {
    "BasicDataset": BasicDataset,
    "ProcessedDataset": ProcessedDataset,
    "GowallaDataset": GowallaDataset,
    "YelpDataset": YelpDataset,
    "AmazonDataset": AmazonDataset,
    "SyntheticDataset": SyntheticDataset,
}
