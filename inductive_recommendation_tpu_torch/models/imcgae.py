"""IMCGAE (reference model.py:4300-4345; counterpart of
``inductive_recommendation_tpu/models/imcgae.py``): personal plus shared
general/identical embeddings concatenated to width 3d, per-layer decaying
node dropout, 1/(i+2) layer scaling, sum-combined.

As in the JAX package the propagation runs on the compact operand
``[P | u_mask | i_mask | 1]`` of width d + 3 (JAX ``imcgae.py:35-52``): the
shared blocks are rank one per node type, so the layers' action on them is
their action on the three coefficient columns, and rows are expanded to 3d
only where they are read. The operand is padded with zero columns to a
multiple of 4 (68 at d = 64), so that the kernel gathers it with 16-byte
loads; A maps a zero column to a zero column, so the padding stays exactly
zero and is sliced off after the last layer.
"""

from __future__ import annotations

import torch
from torch import nn

from inductive_recommendation_tpu_torch.models.base import BasicModel, l2_sq_rows
from inductive_recommendation_tpu_torch.models.lightgcn import build_norm_adj
from inductive_recommendation_tpu_torch.ops.dropout import node_dropout_mask


class IMCGAE(BasicModel):
    graph_propagation = True

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.embedding_size = model_config["embedding_size"]
        self.n_layers = model_config["n_layers"]
        self.dropout = model_config["dropout"]
        self.norm_adj = build_norm_adj(dataset, self.device)
        # the personal rows, then the identical, general-user and general-item ones
        self.embedding = nn.Parameter(
            torch.empty(self.n_users + self.n_items + 3, self.embedding_size, device=self.device)
        )
        self.init_params()

    @torch.no_grad()
    def init_params(self, generator=None):
        self.embedding.normal_(0.0, 0.1, generator=generator)
        return self.params()

    @property
    def operand_width(self) -> int:
        """d + 3 rounded up to a multiple of 4: the propagated width."""
        return -(-(self.embedding_size + 3) // 4) * 4

    def operand(self, params) -> torch.Tensor:
        """[n, operand_width]: the personal rows, the user / item / all-ones
        coefficient columns, then zero columns up to a multiple of 4."""
        emb = params["embedding"]
        n, d = self.n_users + self.n_items, self.embedding_size
        is_user = (torch.arange(n, device=emb.device) < self.n_users).to(emb.dtype)
        coeff = torch.stack([is_user, 1.0 - is_user, torch.ones_like(is_user)], dim=1)
        coeff = self.placement.local_rows(coeff, self.norm_adj)
        personal = emb[:n]
        return torch.cat([personal, coeff, emb.new_zeros(personal.shape[0], self.operand_width - d - 3)], dim=1)

    def shared_rows(self, params):
        """(general_u, general_i, identical): the table's last three rows,
        or ``special``'s in the edge layout (:meth:`edge_params`)."""
        if "special" in params:
            special = params["special"]
            return special[1], special[2], special[0]
        emb, n = params["embedding"], self.n_users + self.n_items
        return emb[n + 1], emb[n + 2], emb[n]

    def edge_params(self, params):
        """Edge mode shards the personal rows and keeps the three shared ones
        apart, whole on every rank, as ``special``."""
        emb, n = params["embedding"], self.n_users + self.n_items
        return {"embedding": emb[:n], "special": emb[n : n + 3]}

    def from_edge_params(self, params):
        return {"embedding": torch.cat([params["embedding"], params["special"]])}

    def compact_rep(self, params, training=False, generator=None, padded=False):
        """([n, d + 3] propagated compact rows, (general_u, general_i,
        identical)); with ``padded`` the operand's zero padding columns are
        kept. Layer i drops nodes at rate max(dropout - 0.1 i, 0), an
        identity at rate 0, its mask drawn whole on the device from a seed
        drawn from the CPU ``generator``."""
        place, emb = self.placement, params["embedding"]
        n = self.n_users + self.n_items
        h = final = self.operand(params)
        for i in range(self.n_layers):
            # the reference's dropout - 0.1 i goes negative for small rates;
            # clamped, a deep layer is an identity (JAX imcgae.py:74-81)
            rate = max(self.dropout - 0.1 * i, 0.0)
            if training and rate > 0.0:
                mask = node_dropout_mask(generator, n, rate, training, emb.device)
                h = h * place.local_rows(mask, self.norm_adj)[:, None]
            h = place.spmm(self.norm_adj, h)
            final = final + h * (1.0 / (i + 2))
        parts = self.shared_rows(params)
        return (final if padded else final[:, : self.embedding_size + 3]), parts

    @staticmethod
    def expand_rows(compact_rows, parts):
        """[*, d + 3] compact rows -> [*, 3d]: the personal block, then the
        general and identical blocks rebuilt from their coefficients."""
        general_u, general_i, identical = parts
        p, a, b, c = compact_rows[:, :-3], compact_rows[:, -3:-2], compact_rows[:, -2:-1], compact_rows[:, -1:]
        return torch.cat([p, a * general_u + b * general_i, c * identical], dim=1)

    def get_rep(self, params, training=False, generator=None):
        return self.expand_rows(*self.compact_rep(params, training, generator))

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        """Only the batch's rows are expanded to 3d: the full [n, 3d] matrix
        never forms in a step."""
        compact, parts = self.compact_rep(params, training, generator)
        rows = self.placement.batch_rows(compact, users, pos_items, neg_items, self.n_users)
        users_r, pos_r, neg_r = (self.expand_rows(r, parts) for r in rows)
        return users_r, pos_r, neg_r, l2_sq_rows(users_r, pos_r, neg_r)
