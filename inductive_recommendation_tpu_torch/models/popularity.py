"""Popularity baseline (reference model.py:4091-4104; counterpart of
``inductive_recommendation_tpu/models/popularity.py``): every user's score
of an item is its train degree."""

from __future__ import annotations

import numpy as np
import torch

from inductive_recommendation_tpu_torch.models.base import BasicModel


class Popularity(BasicModel):
    trainable = False

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        items = np.asarray(dataset.train_array).reshape(-1, 2)[:, 1]
        degree = np.bincount(items, minlength=self.n_items).astype(np.float32)
        self.register_buffer("item_degree", torch.as_tensor(degree, device=self.device))

    def init_params(self, generator=None):
        return {}

    def make_scoring_state(self, params):
        return self.item_degree

    def score(self, state, users):
        return state[None, :].expand(users.shape[0], self.n_items)
