"""Host-side (numpy) builders for the user-item bipartite graph: the
sym-normalized adjacency and IGCN's feature ("template") matrix.

A copy of the numpy builders of ``inductive_recommendation_tpu/graph/build.py``
with the same outputs, so that the port needs nothing of the JAX package.

Reference semantics reproduced:
- symmetric block adjacency [[0, R], [R^T, 0]]      utils.py:42-50
- D^-1/2 A D^-1/2 with degree clamped >= 1          model.py:89-98
- self-loop + row-L1 norm (NGCF)                    model.py:4008-4014
- IGCN template feature matrix + degree row powers  model.py:4139-4175
- train ∪ injected pairs (DOSE views, rankings)     utils.py:71-88
- random-subsample drop graph                       utils.py:91-103
- union "drop" graph (the reference's sample is a
  no-op, reproduced)                                utils.py:105-121
- set-difference drop graph                         utils.py:123-141

``device_sym_normalize`` is the one builder in torch: it normalizes a padded
edge buffer on the buffer's own device.
"""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.utils.profiling import span


def _dedupe_edges(train_array: np.ndarray) -> np.ndarray:
    """Unique (user, item) pairs, sorted (set semantics)."""
    if len(train_array) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return np.unique(np.asarray(train_array, dtype=np.int64), axis=0)


def bipartite_edges(train_array: np.ndarray, n_users: int, n_items: int):
    """(u, i) interaction pairs -> undirected bipartite edge list (row, col)
    over the (n_users + n_items)-node graph, both directions present."""
    train_array = np.asarray(train_array, dtype=np.int64).reshape(-1, 2)
    users, items = train_array[:, 0], train_array[:, 1]
    row = np.concatenate([users, items + n_users])
    col = np.concatenate([items + n_users, users])
    return row, col


def sym_normalize_values(row, col, n_nodes: int, counts=None):
    """Edge values of D^-1/2 A D^-1/2 with degree clamped >= 1; ``counts``
    carries duplicate multiplicities (model.py:89-98)."""
    if counts is None:
        counts = np.ones(len(row), dtype=np.float32)
    degree = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(degree, row, counts)
    degree = np.maximum(1.0, degree)
    d_inv = np.power(degree, -0.5)
    return (counts * d_inv[row] * d_inv[col]).astype(np.float32)


def sym_normalized_adjacency(train_array: np.ndarray, n_users: int, n_items: int):
    """Interactions -> sym-normalized bipartite COO (row, col, val), sorted by
    row. Repeated pairs are coalesced into multiplicities, as torch
    ``coalesce`` sums them in the reference."""
    train_array = np.asarray(train_array, dtype=np.int64).reshape(-1, 2)
    row, col = bipartite_edges(train_array, n_users, n_items)
    n = n_users + n_items
    keys = row * n + col
    uniq, counts = np.unique(keys, return_counts=True)
    row = (uniq // n).astype(np.int64)
    col = (uniq % n).astype(np.int64)
    val = sym_normalize_values(row, col, n, counts.astype(np.float32))
    order = np.argsort(row, kind="stable")
    return row[order], col[order], val[order]


def aug_union_edges(train_array: np.ndarray, aug_idx: np.ndarray) -> np.ndarray:
    """train ∪ injected (u, i) pairs, deduplicated, sorted by key
    (utils.py:71-88)."""
    train_array = np.asarray(train_array, dtype=np.int64).reshape(-1, 2)
    aug_idx = np.asarray(aug_idx, dtype=np.int64).reshape(-1, 2)
    n = int(max(train_array[:, 1].max(initial=0), aug_idx[:, 1].max(initial=0))) + 1
    keys = np.concatenate([train_array[:, 0] * n + train_array[:, 1], aug_idx[:, 0] * n + aug_idx[:, 1]])
    uniq = np.unique(keys)
    return np.stack([uniq // n, uniq % n], axis=1)


def drop_sample_edges(train_array: np.ndarray, aug_rate: float, rng: np.random.Generator) -> np.ndarray:
    """Random subsample keeping ``int(aug_rate * |E|)`` pairs (utils.py:91-103)."""
    train_array = np.asarray(train_array, dtype=np.int64).reshape(-1, 2)
    keep = rng.choice(len(train_array), size=int(len(train_array) * aug_rate), replace=False)
    return train_array[keep]


def drop_union_edges(train_array: np.ndarray, aug_idx: np.ndarray) -> np.ndarray:
    """The reference's ``generate_drop_daj_mat2``: its ``random.sample`` result
    is discarded (utils.py:110), so the graph is the deduplicated union."""
    return aug_union_edges(train_array, aug_idx)


def drop_difference_edges(train_array: np.ndarray, aug_idx: np.ndarray) -> np.ndarray:
    """train \\ aug, deduplicated and sorted by key (utils.py:123-141)."""
    train_array = np.asarray(train_array, dtype=np.int64).reshape(-1, 2)
    aug_idx = np.asarray(aug_idx, dtype=np.int64).reshape(-1, 2)
    if len(aug_idx) == 0:
        return _dedupe_edges(train_array)
    n = int(max(train_array[:, 1].max(initial=0), aug_idx[:, 1].max(initial=0))) + 1
    train_keys = np.unique(train_array[:, 0] * n + train_array[:, 1])
    aug_keys = np.unique(aug_idx[:, 0] * n + aug_idx[:, 1])
    keep = train_keys[~np.isin(train_keys, aug_keys)]
    return np.stack([keep // n, keep % n], axis=1)


def row_l1_normalize_values(row, col, n_nodes: int, counts=None):
    """Row-L1 normalization (used with self loops by NGCF, model.py:4008-4014)."""
    if counts is None:
        counts = np.ones(len(row), dtype=np.float32)
    rowsum = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(rowsum, row, counts)
    rowsum = np.where(rowsum == 0.0, 1.0, rowsum)
    return (counts / rowsum[row]).astype(np.float32)


@span("irt.graph.feat_matrix")
def build_feat_matrix(
    train_array: np.ndarray,
    n_users: int,
    n_items: int,
    user_map: np.ndarray,
    item_map: np.ndarray,
):
    """IGCN feature matrix as COO arrays + row sums (model.py:4160-4172).

    ``user_map``/``item_map`` map node id -> core index, -1 for non-core.
    Shape (n_users + n_items, user_dim + item_dim + 2): user row u has ones at
    columns user_dim + item_map[i] of its train items i, item row i ones at
    columns user_map[u] of its train users u; every user row has a 1 in column
    user_dim + item_dim, every item row in column user_dim + item_dim + 1.

    Returns (row, col, counts, row_sum): int64 row/col sorted by row, float32
    coalesced multiplicities, float32 row sums of the unweighted matrix.
    """
    train_array = np.asarray(train_array, dtype=np.int64).reshape(-1, 2)
    user_map = np.asarray(user_map, dtype=np.int64)
    item_map = np.asarray(item_map, dtype=np.int64)
    user_dim = int((user_map >= 0).sum())
    item_dim = int((item_map >= 0).sum())
    users, items = train_array[:, 0], train_array[:, 1]

    keep_i = item_map[items] >= 0
    row_u = users[keep_i]
    col_u = user_dim + item_map[items[keep_i]]
    keep_u = user_map[users] >= 0
    row_i = n_users + items[keep_u]
    col_i = user_map[users[keep_u]]
    row_gu = np.arange(n_users, dtype=np.int64)
    col_gu = np.full(n_users, user_dim + item_dim, dtype=np.int64)
    row_gi = np.arange(n_items, dtype=np.int64) + n_users
    col_gi = np.full(n_items, user_dim + item_dim + 1, dtype=np.int64)

    row = np.concatenate([row_u, row_i, row_gu, row_gi])
    col = np.concatenate([col_u, col_i, col_gu, col_gi])
    n_cols = user_dim + item_dim + 2
    keys = row * n_cols + col
    uniq, counts = np.unique(keys, return_counts=True)
    row = (uniq // n_cols).astype(np.int64)
    col = (uniq % n_cols).astype(np.int64)
    counts = counts.astype(np.float32)

    row_sum = np.zeros(n_users + n_items, dtype=np.float64)
    np.add.at(row_sum, row, counts)
    order = np.argsort(row, kind="stable")
    return row[order], col[order], counts[order], row_sum.astype(np.float32)


def feat_values_for_alpha(row, base_counts, row_sum, alpha: float):
    """Annealed feature-matrix edge weights: the coalesced multiplicity times
    row_sum^((alpha-1)/2 - 0.5) of the edge's row (model.py:4127-4130).
    Works on numpy arrays and on torch tensors alike."""
    exponent = (alpha - 1.0) / 2.0 - 0.5
    return base_counts * row_sum[row] ** exponent


def device_sym_normalize(row: torch.Tensor, col: torch.Tensor, edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """D^-1/2 A D^-1/2 values of a padded edge buffer, on the tensors' device:
    ``edge_mask`` is 1.0 for a live edge and 0.0 for padding, whose values
    come out 0; the degree (the masked row counts) is clamped >= 1
    (model.py:92)."""
    degree = torch.zeros(n_nodes, dtype=edge_mask.dtype, device=edge_mask.device).index_add_(0, row, edge_mask)
    d_inv = degree.clamp(min=1.0).pow(-0.5)
    return edge_mask * d_inv[row] * d_inv[col]
