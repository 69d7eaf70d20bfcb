"""Node-importance rankings for IGCN's core (template) selection.

A copy of ``inductive_recommendation_tpu/graph/ranking.py`` (numpy and scipy
only, so its results equal the JAX package's exactly), kept here so that the
port needs nothing of the JAX package. Reference utils.py:186-215, with three
metrics:
- ``degree``: row sums of the bipartite adjacency;
- ``sort`` / ``greedy``: column sums of the row-L1-normalized adjacency;
- ``page_rank``: PageRank over the undirected bipartite graph, a power
  iteration at networkx's defaults.

Each ranking returns (ranked_users, ranked_items): node ids sorted by
descending metric.
"""

from __future__ import annotations

import heapq

import numpy as np

from inductive_recommendation_tpu_torch.graph.build import aug_union_edges, bipartite_edges


def _coalesced_bipartite(train_array, n_users, n_items):
    row, col = bipartite_edges(train_array, n_users, n_items)
    n = n_users + n_items
    keys = row * n + col
    uniq, counts = np.unique(keys, return_counts=True)
    return (uniq // n).astype(np.int64), (uniq % n).astype(np.int64), counts.astype(np.float64)


def pagerank(row, col, weight, n_nodes, alpha=0.85, tol=1e-6, max_iter=100):
    """Power-iteration PageRank at networkx's defaults (utils.py:205-210):
    converged when sum(|p - p_prev|) < n * tol; raises after ``max_iter``
    iterations, as networkx does."""
    rowsum = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(rowsum, row, weight)
    dangling = rowsum == 0.0
    out_w = weight / np.where(rowsum[row] == 0.0, 1.0, rowsum[row])
    p = np.full(n_nodes, 1.0 / n_nodes, dtype=np.float64)
    for _ in range(max_iter):
        contrib = np.zeros(n_nodes, dtype=np.float64)
        np.add.at(contrib, col, p[row] * out_w)
        dangling_mass = p[dangling].sum()
        p_new = alpha * (contrib + dangling_mass / n_nodes) + (1.0 - alpha) / n_nodes
        if np.abs(p_new - p).sum() < n_nodes * tol:
            return p_new
        p = p_new
    raise RuntimeError(f"PageRank power iteration failed to converge in {max_iter} iterations")


def graph_rank_nodes(dataset, ranking_metric: str):
    """Rank users and items by descending importance (utils.py:186-215)."""
    return rank_nodes_from_edges(dataset.train_array, dataset.n_users, dataset.n_items, ranking_metric)


def graph_aug_rank_nodes(dataset, ranking_metric: str, aug_idx):
    """Rank over the train ∪ injected-edge graph (utils.py:217-246), whose
    duplicates collapse to weight 1 (``aug_union_edges``)."""
    edges = aug_union_edges(np.asarray(dataset.train_array), np.asarray(aug_idx))
    return rank_nodes_from_edges(edges, dataset.n_users, dataset.n_items, ranking_metric)


def graph_drop_rank_nodes(dataset, ranking_metric: str, drop_edges=None):
    """Rank over a dropped-edge graph (utils.py:248-277): the caller passes
    the drop view's [m, 2] edge list; None ranks the full train graph (the
    reference's call is missing its ``aug_rate`` argument, as the JAX
    package documents)."""
    edges = np.asarray(drop_edges) if drop_edges is not None else dataset.train_array
    return rank_nodes_from_edges(edges, dataset.n_users, dataset.n_items, ranking_metric)


def svd_rank_nodes(edge_array, n_users, n_items, ranking_metric: str, rank=64):
    """SVD-based node ranking (reference utils.py:143-199, commented out
    there, "for theoretical analysis"), with the JAX package's documented
    divergences: an exact truncated SVD (``scipy.sparse.linalg.svds``), a
    popped node stays popped in ``greedy``, and heap ties break by node id.

    - ``sort``: rowsum(A Aᵀ)_i · ||U_i||²;
    - ``greedy``: repeatedly pop the node of smallest accumulated metric,
      bumping each unpopped co-interacting neighbour j by ||U_j||² · (A Aᵀ)_ij;
      the last node popped ranks first.

    Host-side, run once; the greedy mode is O(nnz(A Aᵀ) · log n) in Python."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import svds

    row, col, counts = _coalesced_bipartite(np.asarray(edge_array), n_users, n_items)
    if ranking_metric not in ("sort", "greedy"):
        raise ValueError(f"unknown ranking_metric {ranking_metric!r} (expected 'sort' or 'greedy')")
    ui = row < n_users  # the user -> item half of the symmetric adjacency
    part = sp.csr_matrix((counts[ui], (row[ui], col[ui] - n_users)), shape=(n_users, n_items))
    k = min(rank, min(part.shape) - 1)
    if k < 1:
        raise ValueError(f"graph too small for a rank-{rank} SVD: {part.shape}")
    u, _, vt = svds(part.astype(np.float64), k=k)

    def greedy_or_sort(adj, factor):
        norm_sq = np.linalg.norm(factor, axis=1) ** 2
        co = (adj @ adj.T).tocsr()
        if ranking_metric == "sort":
            return np.asarray(co.sum(axis=1)).squeeze(axis=1) * norm_sq

        n = adj.shape[0]
        metrics = np.asarray(adj.sum(axis=1)).squeeze(axis=1) * norm_sq
        order = np.zeros(n, dtype=np.float64)
        heap = [(metrics[i], i) for i in range(n)]
        heapq.heapify(heap)
        popped = np.zeros(n, dtype=bool)
        for nu in range(n):
            while True:
                m, i = heapq.heappop(heap)
                if not popped[i] and m == metrics[i]:  # skip stale entries
                    break
            popped[i] = True
            order[i] = nu
            lo, hi = co.indptr[i], co.indptr[i + 1]
            for j, w in zip(co.indices[lo:hi], co.data[lo:hi]):
                if popped[j]:
                    continue
                metrics[j] += norm_sq[j] * w
                heapq.heappush(heap, (metrics[j], j))
        return order

    user_metrics = greedy_or_sort(part, u)
    item_metrics = greedy_or_sort(part.T.tocsr(), vt.T)
    return np.argsort(user_metrics)[::-1].copy(), np.argsort(item_metrics)[::-1].copy()


def rank_nodes_from_edges(edge_array, n_users, n_items, ranking_metric: str):
    """Core ranking over an arbitrary [m, 2] (user, item) edge list."""
    row, col, counts = _coalesced_bipartite(np.asarray(edge_array), n_users, n_items)
    n = n_users + n_items
    if ranking_metric == "degree":
        metrics = np.zeros(n, dtype=np.float64)
        np.add.at(metrics, row, counts)
    elif ranking_metric in ("sort", "greedy"):
        # column sums of the row-L1-normalized adjacency (utils.py:202-204)
        rowsum = np.zeros(n, dtype=np.float64)
        np.add.at(rowsum, row, counts)
        norm_w = counts / np.where(rowsum[row] == 0.0, 1.0, rowsum[row])
        metrics = np.zeros(n, dtype=np.float64)
        np.add.at(metrics, col, norm_w)
    elif ranking_metric == "page_rank":
        metrics = pagerank(row, col, counts, n)
    else:
        raise ValueError(
            f"unknown ranking_metric {ranking_metric!r} (expected 'degree', 'sort', 'greedy' or 'page_rank')"
        )
    user_metrics, item_metrics = metrics[:n_users], metrics[n_users:]
    return np.argsort(user_metrics)[::-1].copy(), np.argsort(item_metrics)[::-1].copy()
