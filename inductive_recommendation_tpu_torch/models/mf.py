"""Matrix factorization (reference model.py:56-76; counterpart of
``inductive_recommendation_tpu/models/mf.py``): a user and an item table,
dot-product scores. No sparse product."""

from __future__ import annotations

import torch
from torch import nn

from inductive_recommendation_tpu_torch.models.base import BasicModel, l2_sq_rows


class MF(BasicModel):
    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.embedding_size = model_config["embedding_size"]
        d = self.embedding_size
        self.user_embedding = nn.Parameter(torch.empty(self._align_rows(self.n_users), d, device=self.device))
        self.item_embedding = nn.Parameter(torch.empty(self._align_rows(self.n_items), d, device=self.device))
        self.init_params()

    @torch.no_grad()
    def init_params(self, generator=None):
        """normal(0, 0.1) tables (JAX ``normal_init``)."""
        self.user_embedding.normal_(0.0, 0.1, generator=generator)
        self.item_embedding.normal_(0.0, 0.1, generator=generator)
        return self.params()

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        users_e = params["user_embedding"][users]
        pos_e = params["item_embedding"][pos_items]
        neg_e = params["item_embedding"][neg_items]
        return users_e, pos_e, neg_e, l2_sq_rows(users_e, pos_e, neg_e)

    def make_scoring_state(self, params):
        return params

    def score(self, state, users):
        return state["user_embedding"][users] @ state["item_embedding"][: self.n_items].T
