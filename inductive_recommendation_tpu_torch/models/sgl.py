"""SGL and HALF (reference model.py:130-365; counterpart of
``inductive_recommendation_tpu/models/sgl.py``): LightGCN plus random
edge-drop views regenerated at every epoch end, and InfoNCE.

- SGL: two drop views, InfoNCE between the two views' user reps
  (model.py:213-228);
- HALF: one drop view, InfoNCE between the main reps and the view's
  (model.py:332-349).

A view keeps exactly ``int(aug_rate * n_pairs)`` of the deduplicated train
pairs (``graph.views.random_keep_mask_on_device``) and is one symmetric CSR
built on the device (``ViewEngine.make_view_on_device``), which the
hand-written SpMM propagates forward and backward, as DOSE's views. A view's
draw is keyed by a counter, whose snapshot at the last ``update_aug_adj`` a
checkpoint keeps, so that a reload replays the same views bit for bit.
"""

from __future__ import annotations

from inductive_recommendation_tpu_torch.graph.views import ViewEngine, random_keep_mask_on_device
from inductive_recommendation_tpu_torch.models.base import l2_sq_rows
from inductive_recommendation_tpu_torch.models.lightgcn import LightGCN
from inductive_recommendation_tpu_torch.ops import propagate_mean
from inductive_recommendation_tpu_torch.train.losses import info_nce


class SGL(LightGCN):
    #: the drop views, regenerated at every epoch end (HALF keeps one, model.py:270-271)
    view_keys: tuple = ("aug_adj1", "aug_adj2")

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.aug_rate = model_config.get("aug_rate", 0.8)
        self._aug_seed = int(model_config.get("aug_seed", 0))
        self.view_engine = ViewEngine(dataset.train_array, self.n_users, self.n_items, delta_budget=0, device=self.device)
        # the draw counter, its snapshot at the last update_aug_adj, and
        # whether there was one
        self._view_counter = 0
        self._view_counter_base = 0
        self._views_updated = False
        self._regen_views()

    def _drop_view(self):
        """A view keeping ``int(n_pairs * aug_rate)`` train pairs, drawn on
        the device from (aug_seed, the next counter)."""
        self._view_counter += 1
        n_pairs = self.view_engine.n_pairs
        keep = random_keep_mask_on_device(
            self._view_counter, n_pairs=n_pairs, n_keep=int(n_pairs * self.aug_rate), seed=self._aug_seed,
            device=self.device,
        )
        return self.view_engine.make_view_on_device(keep_pair_mask=keep)

    def _regen_views(self):
        self.views = {k: self._drop_view() for k in self.view_keys}

    def update_aug_adj(self, params=None):
        """Regenerate the views (epoch end, model.py:232-237), after a
        snapshot of the counter so that a restore replays this update."""
        self._view_counter_base = self._view_counter
        self._views_updated = True
        self._regen_views()

    def rebuild_views(self, params=None):
        """After a checkpoint load: the views the saved run trained on,
        replayed from the counter's snapshot (from 0 before any update)."""
        self._view_counter = self._view_counter_base if self._views_updated else 0
        self._regen_views()

    def checkpoint_aux(self):
        return dict(
            super().checkpoint_aux(),
            view_counter=int(self._view_counter),
            view_counter_base=int(self._view_counter_base),
            views_updated=bool(self._views_updated),
        )

    def restore_aux(self, aux):
        """The trainer follows this with ``rebuild_views``."""
        if not aux:
            return
        aux = dict(aux)
        self._view_counter = int(aux.pop("view_counter", self._view_counter))
        self._view_counter_base = int(aux.pop("view_counter_base", 0))
        self._views_updated = bool(aux.pop("views_updated", False))
        super().restore_aux(aux)

    def view_users(self, params, key, users):
        """User rows of the embedding propagated over view ``key``."""
        emb = params["embedding"][: self.n_users + self.n_items]
        return propagate_mean(self.views[key], emb, self.n_layers)[users]

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None, negatives=None):
        """-> (users_r, pos_r, neg_r, l2, contrastive): the propagated reps of
        the batch, L2 on those reps (model.py:224-225), and the [B]
        per-user InfoNCE; ``negatives`` maps a batch's view rows to its
        negative keys (default: the rows themselves)."""
        rep = self.get_rep(params, training=training)
        users_r, pos_r, neg_r = rep[users], rep[self.n_users + pos_items], rep[self.n_users + neg_items]
        closs = self._contrastive(params, users, users_r, negatives or (lambda v: v))
        return users_r, pos_r, neg_r, l2_sq_rows(users_r, pos_r, neg_r), closs

    def _contrastive(self, params, users, users_r, neg):
        v1 = self.view_users(params, "aug_adj1", users)
        v2 = self.view_users(params, "aug_adj2", users)
        return info_nce(v1, v2, neg(v2))


class HALF(SGL):
    view_keys = ("aug_adj1",)

    def _contrastive(self, params, users, users_r, neg):
        v1 = self.view_users(params, "aug_adj1", users)
        return info_nce(users_r, v1, neg(v1))
