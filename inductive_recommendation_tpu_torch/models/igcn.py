"""IGCN, the inductive model (reference model.py:4107-4220), and IMF
(model.py:4290-4297).

A node's representation is built from its feature (template) row alone: a
sparse row over the core users/items plus two type tokens, aggregated against
a core-sized embedding table (``inductive_rep_layer``), then propagated over
the normalized adjacency. Users and items never seen in training get
representations without retraining (``attach_dataset``).

As in the JAX package, the annealed feature-matrix weights
``row_sum^((alpha-1)/2 - 0.5)`` (model.py:4127-4134) are folded into the CSR
values once per anneal (``ops.csr_spmm.with_annealed_values``), never per
product. A ``get_rep`` runs 1 + n_layers SpMMs, and its backward as many on
the transpose layouts. In training the feature-matrix product drops edges in
the kernel, from a hash of the edge id (``ops.csr_spmm.spmm_csr_dropout``;
reference model.py:4189 via NGCF.dropout_sp_mat).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from inductive_recommendation_tpu_torch.graph import build_feat_matrix, graph_rank_nodes
from inductive_recommendation_tpu_torch.models.base import BasicModel, l2_sq_rows
from inductive_recommendation_tpu_torch.models.lightgcn import build_norm_adj
from inductive_recommendation_tpu_torch.ops import build_csr_spmm, with_annealed_values
from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed
from inductive_recommendation_tpu_torch.utils.profiling import span


def select_core(dataset, feature_ratio, ranking_metric):
    """Core (template) user/item selection: the top ``feature_ratio`` of the
    node ranking (model.py:4141-4148), as dense -1-padded map arrays."""
    n_users, n_items = dataset.n_users, dataset.n_items
    if feature_ratio < 1.0:
        ranked_users, ranked_items = graph_rank_nodes(dataset, ranking_metric)
        core_users = ranked_users[: int(n_users * feature_ratio)]
        core_items = ranked_items[: int(n_items * feature_ratio)]
    else:
        core_users = np.arange(n_users, dtype=np.int64)
        core_items = np.arange(n_items, dtype=np.int64)
    user_map = np.full(n_users, -1, dtype=np.int64)
    user_map[core_users] = np.arange(len(core_users))
    item_map = np.full(n_items, -1, dtype=np.int64)
    item_map[core_items] = np.arange(len(core_items))
    return user_map, item_map


class IGCN(BasicModel):
    graph_propagation = True

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.embedding_size = model_config["embedding_size"]
        self.n_layers = model_config["n_layers"]
        self.dropout = model_config["dropout"]
        self.feature_ratio = model_config["feature_ratio"]
        self.alpha = 1.0
        self.delta = model_config.get("delta", 0.99)
        self.ranking_metric = model_config.get("ranking_metric", "sort")

        self.user_map, self.item_map = select_core(dataset, self.feature_ratio, self.ranking_metric)
        self._build_graph_buffers(dataset)
        n_rows = self._align_rows(self.feat_n_cols)
        self.embedding = nn.Parameter(torch.empty(n_rows, self.embedding_size, device=self.device))
        self.w = nn.Parameter(torch.empty(self.embedding_size, device=self.device))
        self.init_params()

    def _build_graph_buffers(self, dataset):
        self.user_dim = int((self.user_map >= 0).sum())
        self.item_dim = int((self.item_map >= 0).sum())
        row, col, counts, row_sum = build_feat_matrix(
            dataset.train_array, dataset.n_users, dataset.n_items, self.user_map, self.item_map
        )
        self.feat_n_cols = self.user_dim + self.item_dim + 2
        self._feat_base = build_csr_spmm(
            row,
            col,
            counts,
            (dataset.n_users + dataset.n_items, self.feat_n_cols),
            symmetric=False,
            device=self.device,
        )
        self._feat_row_sum = torch.as_tensor(row_sum, device=self.device)
        self.feat = with_annealed_values(self._feat_base, self._feat_row_sum, self.alpha)
        self.norm_adj = build_norm_adj(dataset, self.device)

    @span("irt.graph.attach")
    def attach_dataset(self, dataset):
        """Inductive protocol: rebuild the graph layouts from a new dataset
        (train plus new interactions) and keep the core maps and the trained
        table (model.py:4219); nodes new to the maps get -1."""
        um = np.full(dataset.n_users, -1, dtype=np.int64)
        um[: len(self.user_map)] = self.user_map
        im = np.full(dataset.n_items, -1, dtype=np.int64)
        im[: len(self.item_map)] = self.item_map
        self.user_map, self.item_map = um, im
        self.dataset = dataset
        self.n_users, self.n_items = dataset.n_users, dataset.n_items
        self._build_graph_buffers(dataset)

    @span("irt.epoch_end.anneal")
    def feat_mat_anneal(self):
        """alpha *= delta, and the feature values re-weighted (model.py:4127-4134)."""
        self.alpha *= self.delta
        self.feat = with_annealed_values(self._feat_base, self._feat_row_sum, self.alpha)

    @torch.no_grad()
    def init_params(self, generator=None):
        self.embedding.normal_(0.0, 0.1, generator=generator)
        self.w.fill_(1.0)
        return self.params()

    def inductive_rep_layer(self, params, training=False, generator=None):
        """The feature-matrix product; in training with edge dropout, its seed
        drawn from the CPU ``generator``."""
        emb = params["embedding"][: self.feat_n_cols]
        if training and self.dropout > 0.0:
            return self.placement.spmm_dropout(self.feat, emb, dropout_seed(generator), self.dropout)
        return self.placement.spmm(self.feat, emb)

    @span("irt.model.get_rep")
    def get_rep(self, params, training=False, generator=None):
        x0 = self.inductive_rep_layer(params, training=training, generator=generator)
        return self.placement.propagate_mean(self.norm_adj, x0, self.n_layers)

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        """NGCF.bpr_forward shape (model.py:4202-4203): the propagated reps of
        the batch, L2 on those reps."""
        rep = self.get_rep(params, training=training, generator=generator)
        users_r, pos_r, neg_r = self.placement.batch_rows(rep, users, pos_items, neg_items, self.n_users)
        return users_r, pos_r, neg_r, l2_sq_rows(users_r, pos_r, neg_r)

    def checkpoint_aux(self):
        return {
            "user_map": np.asarray(self.user_map),
            "item_map": np.asarray(self.item_map),
            "alpha": float(self.alpha),
        }

    def restore_aux(self, aux):
        """Restore the maps and alpha, and rebuild the layouts from the current
        dataset with them (reference generate_feat(is_updating=True))."""
        if not aux:
            return
        self.user_map = np.asarray(aux["user_map"])
        self.item_map = np.asarray(aux["item_map"])
        self.alpha = float(aux["alpha"])
        self._build_graph_buffers(self.dataset)


class IMF(IGCN):
    """Inductive MF: the inductive rep layer alone, no graph convolution."""

    @span("irt.model.get_rep")
    def get_rep(self, params, training=False, generator=None):
        return self.inductive_rep_layer(params, training=training, generator=generator)
