"""LightGCN (reference model.py:79-127): one embedding table over users and
items, n_layers of normalized-adjacency propagation, layer mean."""

from __future__ import annotations

import torch
from torch import nn

from inductive_recommendation_tpu_torch.graph import sym_normalized_adjacency
from inductive_recommendation_tpu_torch.models.base import BasicModel, l2_sq_rows
from inductive_recommendation_tpu_torch.ops import build_csr_spmm
from inductive_recommendation_tpu_torch.utils.profiling import span


@span("irt.graph.norm_adj")
def build_norm_adj(dataset, device):
    """The sym-normalized adjacency (model.py:89-98) as a CSR layout on
    ``device``; every GCN-style model shares it."""
    row, col, val = sym_normalized_adjacency(dataset.train_array, dataset.n_users, dataset.n_items)
    n = dataset.n_users + dataset.n_items
    return build_csr_spmm(row, col, val, (n, n), symmetric=True, device=device)


class LightGCN(BasicModel):
    graph_propagation = True

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.embedding_size = model_config["embedding_size"]
        self.n_layers = model_config["n_layers"]
        self.norm_adj = build_norm_adj(dataset, self.device)
        n_rows = self._align_rows(self.n_users + self.n_items)
        self.embedding = nn.Parameter(torch.empty(n_rows, self.embedding_size, device=self.device))
        self.init_params()

    @torch.no_grad()
    def init_params(self, generator=None):
        self.embedding.normal_(0.0, 0.1, generator=generator)
        return self.params()

    def get_rep(self, params, training=False, generator=None):
        emb = params["embedding"][: self.n_users + self.n_items]
        return self.placement.propagate_mean(self.norm_adj, emb, self.n_layers)

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        """The propagated reps of the batch, L2 on the ego embeddings
        (model.py:114-117)."""
        rep = self.get_rep(params, training=training)
        rows = self.placement.batch_rows
        l2 = l2_sq_rows(*rows(params["embedding"], users, pos_items, neg_items, self.n_users))
        return (*rows(rep, users, pos_items, neg_items, self.n_users), l2)
