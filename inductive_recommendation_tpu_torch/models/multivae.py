"""MultiVAE (reference model.py:4348-4408; counterpart of
``inductive_recommendation_tpu/models/multivae.py``): a variational
autoencoder over L2-normalized user interaction profiles.

Profiles are built on the device from the padded train lists. The
reference's edge dropout on the sparse profile (model.py:4382) is plain
dropout on the dense rows: dropping a zero is a no-op, so the two have the
same distribution. No sparse product.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from inductive_recommendation_tpu_torch.data.dataset import device_padded_from_lists
from inductive_recommendation_tpu_torch.models.base import BasicModel, Linear, linear
from inductive_recommendation_tpu_torch.ops.dropout import device_generator, dropout_keep
from inductive_recommendation_tpu_torch.utils.profiles import dense_profiles


class MultiVAE(BasicModel):
    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.dropout = model_config["dropout"]
        layer_sizes = list(model_config["layer_sizes"])
        self.e_layer_sizes = [self.n_items] + layer_sizes
        self.d_layer_sizes = self.e_layer_sizes[::-1]
        self.mid_size = self.e_layer_sizes[-1]
        self.e_layer_sizes[-1] = self.mid_size * 2  # mean ++ log_var
        self.train_padded = device_padded_from_lists(dataset.train_data, self.n_items, device=self.device)
        deg = np.fromiter((len(t) for t in dataset.train_data), dtype=np.int64, count=len(dataset.train_data))
        self.register_buffer(
            "inv_norm", torch.as_tensor(1.0 / np.sqrt(np.maximum(deg, 1)), dtype=torch.float32, device=self.device)
        )
        e, dec = self.e_layer_sizes, self.d_layer_sizes
        self.encoder = nn.ModuleList(Linear(e[i], e[i + 1], self.device) for i in range(len(e) - 1))
        self.decoder = nn.ModuleList(Linear(dec[i], dec[i + 1], self.device) for i in range(len(dec) - 1))

    @torch.no_grad()
    def init_params(self, generator=None):
        for layer in (*self.encoder, *self.decoder):
            layer.reset(generator)
        return self.params()

    def profiles(self, users, normalized=True) -> torch.Tensor:
        p = dense_profiles(self.train_padded, users, self.n_items)
        return p * self.inv_norm[users][:, None] if normalized else p

    def ml_forward(self, params, users, training=False, generator=None, keep=None, eps=None):
        """-> (scores [B, n_items], kl [B], l2 [1]) per model.py:4377-4401.

        In training the profile dropout mask ``keep`` (bool [B, n_items]) and
        the reparameterization noise ``eps`` ([B, mid]) are drawn on the
        device from a generator seeded by the CPU ``generator``, unless given."""
        h = self.profiles(users)
        draws = None
        if training and ((keep is None and self.dropout > 0) or eps is None):
            draws = device_generator(generator, h.device)
        if training and self.dropout > 0:
            if keep is None:
                keep = dropout_keep(h.shape, self.dropout, draws, h.device)
            h = torch.where(keep, h / (1.0 - self.dropout), 0.0)

        n_e, n_d = len(self.encoder), len(self.decoder)
        l2 = h.new_zeros(1)
        for i in range(n_e):
            h = linear(params, f"encoder.{i}", h if i == 0 else torch.tanh(h))
            l2 = l2 + (params[f"encoder.{i}.w"] ** 2).sum()
        mean, log_var = h[:, : self.mid_size], h[:, -self.mid_size :]
        std = torch.exp(0.5 * log_var)
        # the reference's KL payload (model.py:4392): 2 KL(N(mu, sigma) || N(0, 1))
        # + D, without the textbook 0.5 and -1, kept for the loss's parity
        kl = (-log_var + torch.exp(log_var) + mean**2).sum(dim=1)
        if training:
            if eps is None:
                eps = torch.randn(mean.shape, generator=draws, device=mean.device)
            h = mean + eps * std
        else:
            h = mean
        for i in range(n_d - 1):
            h = torch.tanh(linear(params, f"decoder.{i}", h))
            l2 = l2 + (params[f"decoder.{i}.w"] ** 2).sum()
        scores = linear(params, f"decoder.{n_d - 1}", h)
        l2 = l2 + (params[f"decoder.{n_d - 1}.w"] ** 2).sum()
        return scores, kl, l2

    def draw_noise(self, batch_size: int, generator=None):
        """(keep, eps) of a training batch of ``batch_size`` users, drawn as
        :meth:`ml_forward` draws them (keep None at dropout 0): a data-mode
        rank draws the whole batch's and keeps its rows."""
        draws = device_generator(generator, self.device)
        keep = None
        if self.dropout > 0:
            keep = dropout_keep((batch_size, self.n_items), self.dropout, draws, self.device)
        return keep, torch.randn((batch_size, self.mid_size), generator=draws, device=self.device)

    def make_scoring_state(self, params):
        return params

    def score(self, state, users):
        return self.ml_forward(state, users, training=False)[0]
