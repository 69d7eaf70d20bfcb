"""Datasets (counterpart of ``inductive_recommendation_tpu/data/dataset.py``).

A dataset is host data: per-user item lists for train/val/test and the
``[n_train, 2]`` train pair array, all numpy or Python lists. Only the padded
per-user matrices that evaluation needs go to a device
(:func:`device_padded_from_lists`).

Ported so far: ``BasicDataset``, ``ProcessedDataset`` (pre-split text files,
reference dataset.py:140-164), ``AuxiliaryDataset`` and
``quick_synthetic_dataset``. The raw parsers, the k-core filter and
``SyntheticDataset`` are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def get_dataset(config):
    """Registry factory keyed by config['name'] (reference dataset.py:10-14)."""
    config = dict(config)
    return DATASETS[config["name"]](config)


class BasicDataset:
    """Base dataset: per-user train/val/test item lists and the train pair
    array. ``__len__`` is the number of train pairs (the epoch size).
    ``negative_sample_ratio`` is the config's ``neg_ratio`` (default 1), the
    negatives ``BCETrainer`` draws per positive."""

    def __init__(self, dataset_config):
        self.config = dataset_config
        self.name = dataset_config["name"]
        self.negative_sample_ratio = dataset_config.get("neg_ratio", 1)
        self.n_users = 0
        self.n_items = 0
        self.train_data = None
        self.val_data = None
        self.test_data = None
        self.train_array = None

    def __len__(self):
        return len(self.train_array)


def read_adjacency_file(file_path):
    """'user item item ...' lines -> (flat item ids int64, offsets int64).

    Reference semantics (dataset.py:145-164): the text is stripped and split
    on newlines, the leading user token of each line is discarded, the line
    number is the user id, and the items are the remaining non-empty
    space-separated tokens."""
    with open(file_path, "r") as f:
        lines = f.read().strip().split("\n")
    flat, offs = [], [0]
    for line in lines:
        flat.extend(int(t) for t in line.split(" ")[1:] if t)
        offs.append(len(flat))
    return np.asarray(flat, dtype=np.int64), np.asarray(offs, dtype=np.int64)


class ProcessedDataset(BasicDataset):
    """Pre-split train.txt / val.txt / test.txt under config['path'];
    n_items = max item id + 1 across the three files."""

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
        flat, offs = read_adjacency_file(file_path)
        if len(flat):
            self.n_items = max(self.n_items, int(flat.max()) + 1)
        lists = [flat[offs[u] : offs[u + 1]].tolist() for u in range(len(offs) - 1)]
        return lists, flat, offs


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
}
