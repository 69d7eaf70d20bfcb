"""The DOSE family (reference model.py:367-3877; counterpart of
``inductive_recommendation_tpu/models/dose.py``): IGCN plus graph
augmentation plus InfoNCE contrastive learning. The variants differ in

1. how candidate (u, i) pairs are selected: extremes of cosine similarity
   (``ops/cosine_topk.py``), random pairs, degree-tail pairs or a threshold;
2. which view graphs are built: injection (union), random subsample, set
   difference, or the reference's no-op "drop" (union);
3. which representations feed InfoNCE.

Each view is one symmetric CSR rebuilt on the device at every epoch end
(``graph/views.py``), so a view's propagation is the hand-written SpMM,
forward and backward. A DOSE_aug training step runs 16 products: IGCN's 8,
one more feature product under its own dropout draw for the view, the view's
n_layers products and their backward. DOSE_aug2 also rebuilds, at every
epoch end, the feature matrix over train plus the selected pairs as one
rectangular CSR with its transpose (``graph.views.build_aug_feat_csr``),
which feeds its view's propagation.

The JAX package's documented divergences from the reference are kept: one
exact global cosine top-k; ``DOSE_aug.update_aug_adj`` regenerates the aug
graph; ``DOSE_aug_drop2`` has an ``update_aug_adj``; the selection uses
eval-mode representations; ``DOSE_aug4`` keeps the top ``aug_num`` pairs with
cos >= pai. A config's ``taugh`` is ignored, as the reference ignores it
(model.py:564 builds InfoNCE at its temperature 0.1).
"""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.graph import graph_aug_rank_nodes, graph_rank_nodes, sym_normalized_adjacency
from inductive_recommendation_tpu_torch.graph.views import (
    ViewEngine,
    aug_feat_base,
    build_aug_feat_csr,
    random_keep_mask_on_device,
    random_pairs_on_device,
)
from inductive_recommendation_tpu_torch.models.igcn import IGCN
from inductive_recommendation_tpu_torch.ops import build_csr_spmm, propagate_mean, spmm_csr
from inductive_recommendation_tpu_torch.ops.cosine_topk import blockwise_cosine_topk
from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed, spmm_csr_dropout
from inductive_recommendation_tpu_torch.train.losses import info_nce
from inductive_recommendation_tpu_torch.utils.profiling import span


class _DOSEBase(IGCN):
    """IGCN plus contrastive views, ``self.views[key]`` (view CSRs)."""

    #: the views regenerated at every epoch end
    view_keys: tuple = ("aug_adj",)
    #: drop-only variants inject nothing: their engine's budget is 0
    injects_pairs: bool = True

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.aug_num = int(model_config.get("aug_num", 0))
        self.aug_rate = model_config.get("aug_rate", 0.2)
        self.aug_ratio = model_config.get("aug_ratio", 0.2)
        self.pai = model_config.get("pai", 0.9)
        self._aug_seed = int(model_config.get("aug_seed", 0))
        self._np_rng = np.random.default_rng(self._aug_seed)
        # the draw counter of the random recipes, its snapshot at the last
        # update_aug_adj and at the last initial-view build
        self._aug_counter = 0
        self._aug_counter_base = 0
        self._initial_counter_base = 0
        self._views_updated = False
        self._defer_views = False
        self._establish_views(dataset)

    def _establish_views(self, dataset):
        """(Re)build the view engine and the initial views for ``dataset``."""
        budget = max(self.aug_num, 1) if self.injects_pairs else 0
        if getattr(self, "_view_engine_for", None) is not dataset:
            # a checkpoint restore passes the same dataset: keep the engine
            self.view_engine = ViewEngine(
                dataset.train_array, self.n_users, self.n_items, delta_budget=budget, device=self.device
            )
            self._view_engine_for = dataset
        self._dedup_train = self.view_engine.train_pairs
        if self._defer_views:
            # restoring an updated run: rebuild_views makes the real views next
            return
        # initial views: snapshot the counter so that a save before the next
        # update_aug_adj replays these draws
        self._initial_counter_base = self._aug_counter
        self._views_updated = False
        self.views = {k: self._initial_view(k) for k in self.view_keys}

    def _build_graph_buffers(self, dataset):
        """IGCN's rebuild (``restore_aux``, ``attach_dataset``) also
        re-establishes the views; not during IGCN's own ``__init__``."""
        super()._build_graph_buffers(dataset)
        if hasattr(self, "view_engine"):
            self._establish_views(dataset)

    # -- per-variant recipe ----------------------------------------------------
    def _make_view(self, key, params):
        """The view CSR of ``key`` for the current params."""
        raise NotImplementedError

    def _initial_view(self, key):
        """The view before any update (default: the train graph)."""
        return self.view_engine.make_view_on_device()

    # -- machinery -------------------------------------------------------------
    def update_aug_adj(self, params=None):
        """Regenerate the views from ``params`` (epoch end), after a snapshot
        of the draw counter so that a restore replays this update."""
        self._aug_counter_base = self._aug_counter
        self._views_updated = True
        self._update_views(params)

    def _update_views(self, params):
        self.views = {k: self._make_view(k, params) for k in self.view_keys}

    def rebuild_views(self, params=None):
        """After a checkpoint load, with the restored params: regenerate the
        views the saved run trained on. Random recipes replay their draws from
        the counter's snapshot; cosine recipes select again from the restored
        params and annealed feature matrix."""
        if self._views_updated:
            self._aug_counter = self._aug_counter_base
            self._update_views(params)

    def checkpoint_aux(self):
        aux = dict(super().checkpoint_aux())
        aux["aug_counter"] = int(self._aug_counter)
        aux["aug_counter_base"] = int(self._aug_counter_base)
        aux["initial_counter_base"] = int(self._initial_counter_base)
        aux["views_updated"] = bool(self._views_updated)
        return aux

    def restore_aux(self, aux):
        """The trainer follows this with ``rebuild_views(params)``; for an
        updated run the views are left to that call."""
        if not aux:
            return
        aux = dict(aux)
        counter = int(aux.pop("aug_counter", 0))
        base = int(aux.pop("aug_counter_base", 0))
        init_base = int(aux.pop("initial_counter_base", 0))
        updated = bool(aux.pop("views_updated", False))
        # a run restored before its first update replays its initial draws
        self._aug_counter = init_base
        self._defer_views = updated
        try:
            super().restore_aux(aux)  # -> _build_graph_buffers -> _establish_views
        finally:
            self._defer_views = False
        self._aug_counter = counter
        self._aug_counter_base = base
        self._initial_counter_base = init_base
        self._views_updated = updated

    @span("irt.epoch_end.select")
    @torch.no_grad()
    def _cos_pairs(self, params, k, negate_items, restrict=None):
        """int64 [k', 2] top (u, i) pairs by cosine similarity (items negated
        with ``negate_items``) of the eval-mode representations, k' = min(k,
        candidates). ``restrict`` = (user ids, item ids) limits the
        candidates to those and maps the result back."""
        rep = self.get_rep(params, training=False)
        users_r, items_r = rep[: self.n_users], rep[self.n_users :]
        if restrict is not None:
            r_users, r_items = (torch.as_tensor(r, dtype=torch.int64, device=self.device) for r in restrict)
            users_r, items_r = users_r[r_users], items_r[r_items]
        k = min(k, users_r.shape[0] * items_r.shape[0])
        _, uid, iid = blockwise_cosine_topk(users_r, items_r, k, negate_items=negate_items)
        uid, iid = uid.long(), iid.long()
        if restrict is not None:
            uid, iid = r_users[uid], r_items[iid]
        return torch.stack([uid, iid], dim=1)

    def _random_keep_mask(self, rate):
        """Host draw of exactly ``int(n_pairs * rate)`` kept train pairs from
        numpy's ``default_rng(aug_seed)``, the JAX package's generator."""
        n_pairs = len(self._dedup_train)
        keep = np.zeros(n_pairs, dtype=bool)
        keep[self._np_rng.choice(n_pairs, size=int(n_pairs * rate), replace=False)] = True
        return keep

    def _device_key(self):
        self._aug_counter += 1
        return self._aug_counter

    def _random_pairs_device(self, n):
        return random_pairs_on_device(
            self._device_key(), n=int(n), n_users=self.n_users, n_items=self.n_items,
            seed=self._aug_seed, device=self.device,
        )

    def _random_keep_mask_device(self, rate):
        n_pairs = len(self._dedup_train)
        return random_keep_mask_on_device(
            self._device_key(), n_pairs=n_pairs, n_keep=int(n_pairs * rate), seed=self._aug_seed, device=self.device
        )

    def _view_x0(self, params, training, generator):
        """The layer-0 input of a view's propagation (DOSE_aug2 feeds its
        augmented feature matrix here)."""
        return self.inductive_rep_layer(params, training=training, generator=generator)

    def view_users(self, params, key, users, training, generator):
        """User rows of the representation propagated over view ``key``; the
        feature-matrix dropout is drawn anew for each view (model.py:488-501)."""
        x0 = self._view_x0(params, training, generator)
        return propagate_mean(self.views[key], x0, self.n_layers)[users]

    # -- forward ---------------------------------------------------------------
    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None, negatives=None):
        """-> (users_r, pos_r, neg_r, l2, contrastive): IGCN's BPR terms on the
        main graph and the [B] per-user contrastive loss. ``negatives`` maps
        a batch's view rows to InfoNCE's negative keys (default: the rows
        themselves; data mode gathers the whole batch's)."""
        users_r, pos_r, neg_r, l2 = super().bpr_forward(
            params, users, pos_items, neg_items, training=training, generator=generator
        )
        neg = negatives or (lambda v: v)
        return users_r, pos_r, neg_r, l2, self._contrastive(params, users, users_r, training, generator, neg)

    def _contrastive(self, params, users, users_r, training, generator, neg):
        v = self.view_users(params, self.view_keys[0], users, training, generator)
        return info_nce(users_r, v, neg(v))


# -- injection variants -----------------------------------------------------------


class DOSE_aug(_DOSEBase):
    """Inject the aug_num lowest-cosine pairs (items negated before the top-k,
    model.py:503-545) into the train graph (union)."""

    def _make_view(self, key, params):
        return self.view_engine.make_view_on_device(add_pairs=self._cos_pairs(params, self.aug_num, True))


class DOSE_aug2(DOSE_aug):
    """DOSE_aug whose selection takes the highest-cosine pairs
    (model.py:1034-1051 has no negation) and which also rebuilds, at every
    epoch end, the feature matrix over train plus those pairs
    (model.py:935-978) at the alpha then in force: ``aug_feat``, one
    rectangular CSR with its transpose built on the device
    (``graph.views.build_aug_feat_csr``), the layer-0 input of the view's
    propagation. Until the first update that input comes from the main
    ``feat``, which is the same matrix (the JAX package seeds its aug feature
    matrix with an all-in-train, hence empty, delta).

    With ``feature_ratio`` < 1 the augmented matrix's core is selected once,
    from a ranking over the first augmented graph (``graph_aug_rank_nodes``,
    model.py:941), at the main core's sizes; a checkpoint keeps it, and
    ``attach_dataset`` extends it with -1 for new nodes."""

    def _make_view(self, key, params):
        self._last_aug_pairs = self._cos_pairs(params, self.aug_num, False)
        return self.view_engine.make_view_on_device(add_pairs=self._last_aug_pairs)

    def _update_views(self, params):
        super()._update_views(params)
        self._update_aug_feat()

    def _aug_core_maps(self):
        """The core maps of the augmented matrix: the main ones at
        feature_ratio 1; else selected from the first augmented graph, with
        as many users and items as the main core (the shared table's rows)."""
        if self.feature_ratio >= 1.0:
            return self.user_map, self.item_map
        if not hasattr(self, "aug_user_map"):
            ranked_u, ranked_i = graph_aug_rank_nodes(
                self.dataset, self.ranking_metric, self._last_aug_pairs.cpu().numpy()
            )
            um = np.full(self.n_users, -1, dtype=np.int64)
            um[ranked_u[: self.user_dim]] = np.arange(self.user_dim)
            im = np.full(self.n_items, -1, dtype=np.int64)
            im[ranked_i[: self.item_dim]] = np.arange(self.item_dim)
            self.aug_user_map, self.aug_item_map = um, im
        return self.aug_user_map, self.aug_item_map

    def _update_aug_feat(self):
        if self._aug_base is None:
            user_map, item_map = self._aug_core_maps()
            self._aug_base = aug_feat_base(self._dedup_train, self.n_users, self.n_items, user_map, item_map,
                                           self.device)
        self.aug_feat, self.aug_row_sum = build_aug_feat_csr(
            self._aug_base, self.view_engine.train_keys, self._last_aug_pairs, self.alpha,
            n_users=self.n_users, n_items=self.n_items, user_dim=self.user_dim, n_cols=self.feat_n_cols,
        )

    def _build_graph_buffers(self, dataset):
        # (also in IGCN.__init__) a restore or attach_dataset rebuilds the
        # layouts: the augmented matrix's train part is stale, and until the
        # next update the main feat serves
        self._aug_base = None
        self.aug_feat = self.aug_row_sum = None
        super()._build_graph_buffers(dataset)

    def attach_dataset(self, dataset):
        if hasattr(self, "aug_user_map"):
            um = np.full(dataset.n_users, -1, dtype=np.int64)
            um[: len(self.aug_user_map)] = self.aug_user_map
            im = np.full(dataset.n_items, -1, dtype=np.int64)
            im[: len(self.aug_item_map)] = self.aug_item_map
            self.aug_user_map, self.aug_item_map = um, im
        super().attach_dataset(dataset)

    def checkpoint_aux(self):
        aux = dict(super().checkpoint_aux())
        if hasattr(self, "aug_user_map"):
            # selected once, from the first augmented graph: a restore must
            # not select again from a later epoch's pairs
            aux["aug_user_map"] = np.asarray(self.aug_user_map)
            aux["aug_item_map"] = np.asarray(self.aug_item_map)
        return aux

    def restore_aux(self, aux):
        if not aux:
            return
        aux = dict(aux)
        if "aug_user_map" in aux:
            self.aug_user_map = np.asarray(aux.pop("aug_user_map"))
            self.aug_item_map = np.asarray(aux.pop("aug_item_map"))
        super().restore_aux(aux)

    def _view_x0(self, params, training, generator):
        if self.aug_feat is None:
            return super()._view_x0(params, training, generator)
        emb = params["embedding"][: self.feat_n_cols]
        if training and self.dropout > 0.0:
            return spmm_csr_dropout(self.aug_feat, emb, dropout_seed(generator), self.dropout)
        return spmm_csr(self.aug_feat, emb)


class DOSE_aug3(_DOSEBase):
    """Random edge injection (model.py:1162-1176)."""

    def _make_view(self, key, params):
        return self.view_engine.make_view_on_device(add_pairs=self._random_pairs_device(self.aug_num))

    def _initial_view(self, key):
        return self._make_view(key, None)


class DOSE_aug4(_DOSEBase):
    """Threshold injection: the pairs with cos >= pai (model.py:750-769), at
    most aug_num of them (the highest)."""

    @torch.no_grad()
    def _make_view(self, key, params):
        k = max(min(self.aug_num, self.n_users * self.n_items), 1)
        rep = self.get_rep(params, training=False)
        vals, uid, iid = blockwise_cosine_topk(rep[: self.n_users], rep[self.n_users :], k)
        pairs = torch.stack([uid.long(), iid.long()], dim=1)
        return self.view_engine.make_view_on_device(add_pairs=pairs, add_valid=vals >= self.pai)


# -- drop variants ----------------------------------------------------------------


class DOSE_drop(_DOSEBase):
    """Drop the aug_num highest-cosine train pairs (set difference,
    model.py:1407-1418 + utils.py:123-141)."""

    injects_pairs = False
    _negate_items = False

    def _make_view(self, key, params):
        pairs = self._cos_pairs(params, self.aug_num, self._negate_items)
        return self.view_engine.make_view_on_device(
            keep_pair_mask=self.view_engine.keep_mask_from_drop_pairs_on_device(pairs)
        )


class DOSE_drop2(_DOSEBase):
    """Random drop keeping aug_rate of the train pairs (model.py:1726-1736)."""

    injects_pairs = False

    def _make_view(self, key, params):
        return self.view_engine.make_view_on_device(keep_pair_mask=self._random_keep_mask_device(self.aug_rate))

    def _initial_view(self, key):
        return self._make_view(key, None)


class DOSE_drop3(DOSE_drop):
    """Drop the aug_num lowest-cosine train pairs (items negated,
    model.py:2748-2790)."""

    _negate_items = True


class TEST(DOSE_drop2):
    """DOSE_drop2 whose main adjacency is a random-drop graph too
    (model.py:1989-1990), fixed for the run and kept in the checkpoint, so a
    restore serves this run's graph (not a fresh draw)."""

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self._main_keep = self._random_keep_mask(self.aug_rate)
        self._apply_main_drop()

    def _apply_main_drop(self):
        r, c, v = sym_normalized_adjacency(self._dedup_train[self._main_keep], self.n_users, self.n_items)
        n = self.n_users + self.n_items
        self.norm_adj = build_csr_spmm(r, c, v, (n, n), symmetric=True, device=self.device)

    def _build_graph_buffers(self, dataset):
        super()._build_graph_buffers(dataset)
        if hasattr(self, "_main_keep"):
            if len(self._main_keep) != len(self._dedup_train):
                # a new dataset (attach_dataset): draw again over its pairs
                self._main_keep = self._random_keep_mask(self.aug_rate)
            self._apply_main_drop()

    def checkpoint_aux(self):
        return dict(super().checkpoint_aux(), main_keep=np.asarray(self._main_keep))

    def restore_aux(self, aux):
        if not aux:
            return
        aux = dict(aux)
        if "main_keep" in aux:
            self._main_keep = np.asarray(aux.pop("main_keep")).astype(bool)
        super().restore_aux(aux)


class TEST2(DOSE_drop2):
    """Two random-drop views and InfoNCE between them (model.py:2279-2280,
    2499-2514)."""

    view_keys = ("aug_adj", "aug_adj2")

    def _contrastive(self, params, users, users_r, training, generator, neg):
        v1 = self.view_users(params, "aug_adj", users, training, generator)
        v2 = self.view_users(params, "aug_adj2", users, training, generator)
        return info_nce(v1, v2, neg(v2))


# -- combined variants ------------------------------------------------------------


class DOSE_aug_drop(_DOSEBase):
    """A random-injection graph and a random-drop graph, two InfoNCE terms.
    The reference's quirk is kept: both terms propagate over the aug graph
    (model.py:3140-3142), so they differ only by their dropout draws; the
    drop graph is still built and regenerated."""

    view_keys = ("aug_adj", "drop_adj")

    def _make_view(self, key, params):
        if key == "aug_adj":
            return self.view_engine.make_view_on_device(add_pairs=self._random_pairs_device(self.aug_num))
        return self.view_engine.make_view_on_device(keep_pair_mask=self._random_keep_mask_device(self.aug_rate))

    def _initial_view(self, key):
        return self._make_view(key, None)

    def _contrastive(self, params, users, users_r, training, generator, neg):
        v_aug = self.view_users(params, "aug_adj", users, training, generator)
        v_drop = self.view_users(params, "aug_adj", users, training, generator)
        return info_nce(users_r, v_aug, neg(v_aug)) + info_nce(users_r, v_drop, neg(v_drop))


class DOSE_aug_drop2(_DOSEBase):
    """The top-cosine pairs among the degree tails (the users and items past
    the top aug_ratio by degree, model.py:3291-3325) injected; the "drop"
    graph is the reference's no-op drop, the same union (utils.py:105-121);
    the loss uses the drop view (model.py:3394-3407)."""

    view_keys = ("aug_adj", "drop_adj")

    def __init__(self, model_config, dataset, device):
        self._rank_tails(dataset, model_config.get("aug_ratio", 0.2))
        super().__init__(model_config, dataset, device)

    def _rank_tails(self, dataset, aug_ratio):
        ranked_users, ranked_items = graph_rank_nodes(dataset, "degree")
        self._tail_users = ranked_users[int(dataset.n_users * aug_ratio) :].copy()
        self._tail_items = ranked_items[int(dataset.n_items * aug_ratio) :].copy()

    def attach_dataset(self, dataset):
        # the degree tails of the new dataset hold its new cold nodes
        self._rank_tails(dataset, self.aug_ratio)
        super().attach_dataset(dataset)

    def _make_view(self, key, params):
        pairs = self._cos_pairs(params, self.aug_num, False, restrict=(self._tail_users, self._tail_items))
        return self.view_engine.make_view_on_device(add_pairs=pairs)

    def _update_views(self, params):
        # one selection and one view: both keys are the same union graph
        view = self._make_view("aug_adj", params)
        self.views = {"aug_adj": view, "drop_adj": view}

    def _contrastive(self, params, users, users_r, training, generator, neg):
        v = self.view_users(params, "drop_adj", users, training, generator)
        return info_nce(users_r, v, neg(v))


class DOSE_aug_drop3(_DOSEBase):
    """One top-cosine selection feeds an injection graph and a difference
    graph (model.py:3473-3497); the loss uses the drop view
    (model.py:3626-3639)."""

    view_keys = ("aug_adj", "drop_adj")

    def _update_views(self, params):
        eng = self.view_engine
        pairs = self._cos_pairs(params, self.aug_num, False)
        self.views = {
            "aug_adj": eng.make_view_on_device(add_pairs=pairs),
            "drop_adj": eng.make_view_on_device(keep_pair_mask=eng.keep_mask_from_drop_pairs_on_device(pairs)),
        }

    def _contrastive(self, params, users, users_r, training, generator, neg):
        v = self.view_users(params, "drop_adj", users, training, generator)
        return info_nce(users_r, v, neg(v))


class DOSE_test(DOSE_aug):
    """DOSE_aug whose ``bpr_forward`` returns the aug-view user reps in the
    contrastive slot (model.py:3843-3855); DOSEtestTrainer takes their mean
    as the "contrastive" term, as the reference does."""

    def _contrastive(self, params, users, users_r, training, generator, neg):
        return self.view_users(params, "aug_adj", users, training, generator)

