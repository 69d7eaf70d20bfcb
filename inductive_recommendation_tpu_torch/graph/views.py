"""DOSE's contrastive views as one symmetric CSR each, built on the device
once per epoch (counterpart of the edge-view part of
``inductive_recommendation_tpu/graph/views.py``).

A view is the train graph with some pairs removed and/or some pairs added,
sym-normalized by its own degrees (reference utils.py:71-141 +
model.py:409-420):

    A_view = D^-1/2 (A_train o keep  U  A_inject) D^-1/2,  degrees clamped >= 1.

Every kept or injected pair is written in both directions with the value
``d_inv[r] * d_inv[c]``, which is the same float both ways, so the view CSR
is symmetric and is its own transpose: ``spmm_csr(view, x)`` runs the
hand-written SpMM forward and, on the same layout, backward. One product per
layer replaces the JAX package's masked base product plus delta product, so
JAX's ``view_spmm`` and ``view_propagate_mean`` (``views.py:900-932``) are
``ops.spmm_csr`` and ``ops.propagate_mean`` on the view.

:func:`build_view_csr` concatenates the kept base edges and the injected
ones, sorts them by row with a stable ``torch.sort`` and forms ``row_ptr``
with ``bincount`` + ``cumsum`` (``ops.csr_spmm.csr_on_device``), all with
torch ops on the engine's device:
no host round trip of O(|E|) arrays per epoch. The kernel finds its chunk
schedule from ``row_ptr`` on the card, so a view needs no host plan.

No counterpart, replaced by the view CSR: ``EdgeView``, ``BakedView`` and
``bake_view`` (JAX ``views.py:45-127``), ``_delta_spmm`` (``:130-154``),
``chunked_segment_structs`` / ``chunked_delta_spmm`` (``:157-212,314-335``),
and ``ViewEngine.make_view``, the host builder (``:456-520``): the port has
no host fallback, and ``keep_mask_from_drop_pairs_on_device`` also serves
for the host ``keep_mask_from_drop_pairs`` (``:626-638``). The pair keys are
int64, so the 32-bit-key fallbacks of ``:557-593`` are not needed.

DOSE_aug2's feature matrix over train plus the selected pairs is one
rectangular CSR and its transpose, rebuilt on the device at every epoch end
(:func:`build_aug_feat_csr`), so that its products, forward and backward
under the in-kernel dropout, are the hand-written SpMM. It replaces the
fixed-budget rectangular delta: ``device_make_feat_delta`` /
``feat_delta_host`` (``:730-868``) and the delta SpMMs with their chunked
structures (``:215-422``).
"""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.graph.build import build_feat_matrix
from inductive_recommendation_tpu_torch.ops.csr_spmm import CsrSpMM, csr_on_device, with_annealed_values
from inductive_recommendation_tpu_torch.utils.profiling import span


def _draw_generator(seed: int, counter: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, counter) alone, so that a
    restored counter replays the same draw."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(counter) & 0xFFFFFFFF]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def random_pairs_on_device(counter: int, *, n: int, n_users: int, n_items: int, seed: int, device):
    """int64 [n, 2] uniform random (user, item) pairs, drawn on ``device``
    (JAX ``views.py:871-879``; torch's Philox bits, not threefry's)."""
    g = _draw_generator(seed, counter, device)
    u = torch.randint(0, n_users, (n,), generator=g, device=device)
    i = torch.randint(0, n_items, (n,), generator=g, device=device)
    return torch.stack([u, i], dim=1)


def random_keep_mask_on_device(counter: int, *, n_pairs: int, n_keep: int, seed: int, device):
    """bool [n_pairs] with exactly ``n_keep`` True, drawn on ``device``
    (reference random.sample semantics; JAX ``views.py:882-889``)."""
    g = _draw_generator(seed, counter, device)
    keep = torch.zeros(n_pairs, dtype=torch.bool, device=device)
    keep[torch.randperm(n_pairs, generator=g, device=device)[:n_keep]] = True
    return keep


class ViewEngine:
    """Per-model factory of view CSRs over one deduplicated train pair set.

    The raw both-direction edge list is kept on ``device``, sorted by row
    once: edge e joins node ``edge_row[e]`` to ``edge_col[e]`` for the train
    pair ``eid_pair[e]``, so one per-pair mask expands to both directions."""

    def __init__(self, train_array, n_users, n_items, delta_budget: int = 0, device="cpu"):
        self.n_users, self.n_items = n_users, n_items
        self.n_nodes = n_users + n_items
        self.device = torch.device(device)
        self.delta_budget = int(delta_budget)
        pairs = np.unique(np.asarray(train_array, dtype=np.int64).reshape(-1, 2), axis=0)
        self.train_pairs = pairs
        n_pairs = len(pairs)
        row = np.concatenate([pairs[:, 0], n_users + pairs[:, 1]])
        col = np.concatenate([n_users + pairs[:, 1], pairs[:, 0]])
        order = np.argsort(row, kind="stable")

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64, device=self.device)

        # sorted (unique) keys u * n_items + i of the train pairs
        self.train_keys = put(pairs[:, 0] * n_items + pairs[:, 1])
        self.edge_row = put(row[order])
        self.edge_col = put(col[order])
        self.eid_pair = put(np.concatenate([np.arange(n_pairs), np.arange(n_pairs)])[order])

    @property
    def n_pairs(self) -> int:
        return len(self.train_pairs)

    def _train_position(self, keys):
        """(position of each key in ``train_keys`` clamped to range, whether
        it is there)."""
        if self.n_pairs == 0:
            return torch.zeros_like(keys), torch.zeros_like(keys, dtype=torch.bool)
        pos = torch.clamp(torch.searchsorted(self.train_keys, keys), max=self.n_pairs - 1)
        return pos, self.train_keys[pos] == keys

    @span("irt.epoch_end.view_build")
    def make_view_on_device(self, keep_pair_mask=None, add_pairs=None, add_valid=None) -> CsrSpMM:
        """The view CSR of the train pairs ``keep_pair_mask`` keeps (all by
        default) and the injected ``add_pairs``, with the semantics of the
        JAX ``make_view`` (``views.py:456-520``):

        - ``add_valid`` masks out rows of ``add_pairs`` (a thresholded
          selection); duplicates within the injected pairs count once;
        - an injected pair already in train is not a delta: it force-keeps
          its train pair;
        - more than ``delta_budget`` injected pairs left after that raises
          ``ValueError``."""
        keep = torch.ones(self.n_pairs, dtype=torch.bool, device=self.device)
        if keep_pair_mask is not None:
            keep = torch.as_tensor(keep_pair_mask, device=self.device).to(torch.bool).clone()
        delta = torch.zeros(0, dtype=torch.int64, device=self.device)
        if add_pairs is not None and len(add_pairs) > 0:
            add = torch.as_tensor(add_pairs, device=self.device).to(torch.int64).reshape(-1, 2)
            if add_valid is not None:
                add = add[torch.as_tensor(add_valid, device=self.device).to(torch.bool)]
            keys = torch.unique(add[:, 0] * self.n_items + add[:, 1])
            pos, in_train = self._train_position(keys)
            keep[pos[in_train]] = True
            delta = keys[~in_train]
            if delta.shape[0] > self.delta_budget:
                raise ValueError(f"delta {delta.shape[0]} exceeds budget {self.delta_budget}")
        return build_view_csr(self, keep, (delta // self.n_items, delta % self.n_items))

    def keep_mask_from_drop_pairs_on_device(self, drop_pairs) -> torch.Tensor:
        """bool [n_pairs]: every train pair except the given (u, i) pairs (set
        difference, utils.py:123-141; pairs not in train are ignored)."""
        keep = torch.ones(self.n_pairs, dtype=torch.bool, device=self.device)
        drop = torch.as_tensor(drop_pairs, device=self.device).to(torch.int64).reshape(-1, 2)
        pos, hit = self._train_position(drop[:, 0] * self.n_items + drop[:, 1])
        keep[pos[hit]] = False
        return keep


def build_view_csr(engine: ViewEngine, keep: torch.Tensor, delta) -> CsrSpMM:
    """The symmetric view CSR of the train pairs ``keep`` retains and the
    injected pairs ``delta`` = (users, items), sym-normalized by the view's
    degrees (clamped >= 1), on the engine's device.

    Within a row the kept train edges come first, in the engine's order, then
    the injected ones; dropped edges are left out. ``eid`` is each edge's
    position in that concatenation."""
    n_users, n = engine.n_users, engine.n_nodes
    delta_u, delta_i = delta
    kept_e = keep[engine.eid_pair]
    rows = torch.cat([engine.edge_row[kept_e], delta_u, n_users + delta_i])
    cols = torch.cat([engine.edge_col[kept_e], n_users + delta_i, delta_u])
    # a node's degree is its row's edge count: both directions are listed
    degree = torch.bincount(rows, minlength=n)
    d_inv = torch.pow(torch.clamp(degree.to(torch.float64), min=1.0), -0.5)
    vals = (d_inv[rows] * d_inv[cols]).to(torch.float32)
    return csr_on_device(rows, cols, vals, (n, n), symmetric=True, route="view")


# -- DOSE_aug2's augmented feature matrix --------------------------------------------


def aug_feat_base(train_pairs, n_users, n_items, user_map, item_map, device) -> dict:
    """The static train part of the augmented feature matrix, on ``device``
    once: the COO of ``build_feat_matrix`` over the deduplicated
    ``train_pairs`` with the core maps (``rows``, ``cols``, ``counts``), its
    row sums (``row_sum``) and the maps themselves (int64, -1 off the core)."""
    row, col, counts, row_sum = build_feat_matrix(train_pairs, n_users, n_items, user_map, item_map)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return {
        "rows": put(row, torch.int64), "cols": put(col, torch.int64), "counts": put(counts, torch.float32),
        "row_sum": put(row_sum, torch.float32),
        "user_map": put(user_map, torch.int64), "item_map": put(item_map, torch.int64),
    }


def build_aug_feat_csr(base: dict, train_keys, add_pairs, alpha: float, *, n_users: int, n_items: int,
                       user_dim: int, n_cols: int):
    """-> (the feature matrix over train plus ``add_pairs`` as a CSR with its
    transpose, with IGCN's weights at ``alpha``; its unweighted row sums),
    on the device (JAX ``device_make_feat_delta``, reference
    model.py:935-978).

    The selected pairs are deduplicated and those already in train dropped
    (int64 keys u * n_items + i against the sorted ``train_keys``). Each
    remaining pair (u, i) adds (u, user_dim + item_map[i]) where item i is
    in the core and (n_users + i, user_map[u]) where user u is, each with
    value 1, and 1 to its row's sum. The forward (rows x cols) and the
    transpose (cols x rows) are built from the same triples, so their edge
    ids agree and a dropout seed drops the same edges both ways; their
    launches count under the route ``aug_feat``."""
    n_rows = n_users + n_items
    rows, cols, vals = base["rows"], base["cols"], base["counts"]
    add = torch.as_tensor(add_pairs, device=rows.device).to(torch.int64).reshape(-1, 2)
    keys = torch.unique(add[:, 0] * n_items + add[:, 1])
    if train_keys.shape[0]:
        pos = torch.clamp(torch.searchsorted(train_keys, keys), max=train_keys.shape[0] - 1)
        keys = keys[train_keys[pos] != keys]
    au, ai = keys // n_items, keys % n_items
    im, um = base["item_map"][ai], base["user_map"][au]
    e1, e2 = im >= 0, um >= 0
    d_rows = torch.cat([au[e1], n_users + ai[e2]])
    d_cols = torch.cat([user_dim + im[e1], um[e2]])
    row_sum = base["row_sum"] + torch.bincount(d_rows, minlength=n_rows).to(torch.float32)
    rows, cols = torch.cat([rows, d_rows]), torch.cat([cols, d_cols])
    vals = torch.cat([vals, torch.ones(d_rows.shape[0], dtype=torch.float32, device=vals.device)])
    transpose = csr_on_device(cols, rows, vals, (n_cols, n_rows), transposed=True, route="aug_feat")
    mat = csr_on_device(rows, cols, vals, (n_rows, n_cols), transpose=transpose, route="aug_feat")
    return with_annealed_values(mat, row_sum, alpha), row_sum
