"""NGCF (reference model.py:3986-4055; counterpart of
``inductive_recommendation_tpu/models/ngcf.py``): the self-loop row-L1
adjacency, per-layer gc/bi linear transforms, leaky-relu, message dropout
and the L2-normalized concat of the layers.

A + I is not symmetric once row-normalized, so its layout carries the
transpose, on which the backward runs the same kernel. In training one edge
dropout mask serves every layer of a step (the reference drops the
adjacency once per forward, model.py:4030-4044): every layer's product is
``spmm_csr_dropout`` under the same seed, which the kernel hashes with the
edge id, so the forward and the transpose products drop the same edges. A
``get_rep`` is n_layers products, a training step twice as many.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from inductive_recommendation_tpu_torch.graph import bipartite_edges, row_l1_normalize_values
from inductive_recommendation_tpu_torch.models.base import BasicModel, Linear, kaiming_uniform_, l2_sq_rows, linear
from inductive_recommendation_tpu_torch.ops import build_csr_spmm, spmm_csr, spmm_csr_dropout
from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed
from inductive_recommendation_tpu_torch.ops.dropout import device_generator, dropout_keep


def selfloop_l1_coo(dataset):
    """COO (row, col, val, n) of A + I, row-L1 normalized (model.py:4008-4014);
    repeated pairs are coalesced into multiplicities."""
    n = dataset.n_users + dataset.n_items
    row, col = bipartite_edges(dataset.train_array, dataset.n_users, dataset.n_items)
    row = np.concatenate([row, np.arange(n)])
    col = np.concatenate([col, np.arange(n)])
    uniq, counts = np.unique(row * n + col, return_counts=True)
    row, col = uniq // n, uniq % n
    return row, col, row_l1_normalize_values(row, col, n, counts.astype(np.float32)), n


def build_selfloop_l1_adj(dataset, device):
    """A + I, row-L1 normalized, with its transpose layout (for the backward
    under edge dropout)."""
    row, col, val, n = selfloop_l1_coo(dataset)
    return build_csr_spmm(row, col, val, (n, n), symmetric=False, device=device)


def l2_normalize_rows(h: torch.Tensor) -> torch.Tensor:
    """h / sqrt(max(|h|^2, 1e-24)), the clamp inside the square root: an
    isolated node whose self-loop is dropped has an exactly-zero row, and a
    norm clamped outside the root would still give 0/0 in the backward (JAX
    ``ngcf.py:102-113``)."""
    return h / torch.sqrt(torch.clamp((h * h).sum(dim=1, keepdim=True), min=1e-24))


class NGCF(BasicModel):
    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.dropout = model_config["dropout"]
        self.embedding_size = model_config["embedding_size"]
        self.layer_sizes = list(model_config["layer_sizes"])
        self.n_layers = len(self.layer_sizes)
        self.norm_adj = build_selfloop_l1_adj(dataset, self.device)
        sizes = [self.embedding_size] + self.layer_sizes
        self.embedding = nn.Parameter(
            torch.empty(self.n_users + self.n_items, self.embedding_size, device=self.device)
        )
        self.gc_layers = nn.ModuleList(Linear(sizes[i], sizes[i + 1], self.device) for i in range(self.n_layers))
        self.bi_layers = nn.ModuleList(Linear(sizes[i], sizes[i + 1], self.device) for i in range(self.n_layers))
        self.init_params()

    @torch.no_grad()
    def init_params(self, generator=None):
        kaiming_uniform_(self.embedding, self.embedding_size, generator)
        for layer in (*self.gc_layers, *self.bi_layers):
            layer.reset(generator)
        return self.params()

    def get_rep(self, params, training=False, generator=None):
        """[n_users + n_items, d + sum(layer_sizes)]: the embedding and each
        layer's normalized output, side by side. In training with dropout,
        the edge mask's seed and the message masks' generator are drawn from
        the CPU ``generator``."""
        h = params["embedding"]
        layers = [h]
        drop = training and self.dropout > 0.0
        if drop:
            seed = dropout_seed(generator)
            messages = device_generator(generator, h.device)
        for i in range(self.n_layers):
            m0 = spmm_csr_dropout(self.norm_adj, h, seed, self.dropout) if drop else spmm_csr(self.norm_adj, h)
            m1 = h * m0
            h = nn.functional.leaky_relu(
                linear(params, f"gc_layers.{i}", m0) + linear(params, f"bi_layers.{i}", m1), negative_slope=0.2
            )
            if drop:
                keep = dropout_keep(h.shape, self.dropout, messages, h.device)
                h = torch.where(keep, h / (1.0 - self.dropout), 0.0)
            layers.append(l2_normalize_rows(h))
        return torch.cat(layers, dim=1)

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        rep = self.get_rep(params, training=training, generator=generator)
        users_r = rep[users]
        pos_r = rep[self.n_users + pos_items]
        neg_r = rep[self.n_users + neg_items]
        return users_r, pos_r, neg_r, l2_sq_rows(users_r, pos_r, neg_r)
