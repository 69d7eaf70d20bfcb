"""IDCF_LGCN (reference model.py:3879-3983; counterpart of
``inductive_recommendation_tpu/models/idcf.py``): inductive CF by relational
attention over a frozen, pretrained LightGCN table.

Every node's query is its neighbourhood's sum of frozen rows (``feat``, the
0/1 adjacency columns of the old users and items, a rectangular CSR
multiplied with no gradient); per head it attends over ``n_samples`` sampled
user (item) rows of the table. The heads are fused by a linear layer and
propagated LightGCN-style over the sym-normalized adjacency, forward and
backward through the SpMM kernel: a training step is 1 + 2 n_layers
products. A logsumexp contrastive term pulls each representation towards
its own frozen row, against the last head's samples (the reference reads
the loop variable after the loop, model.py:3946-3955).

The frozen table is a registered buffer, so the optimizer never sees it. It
comes from ``pretrained_embedding`` or from ``lgcn_path``, a LightGCN
checkpoint written by this package's ``save_checkpoint`` or by the JAX
package's (``train.checkpoint.load_checkpoint`` reads both).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from inductive_recommendation_tpu_torch.graph import bipartite_edges
from inductive_recommendation_tpu_torch.models.base import BasicModel, Linear, l2_sq_rows, linear
from inductive_recommendation_tpu_torch.models.lightgcn import build_norm_adj
from inductive_recommendation_tpu_torch.ops import build_csr_spmm
from inductive_recommendation_tpu_torch.train.checkpoint import load_checkpoint


def relation_gat(params, name: str, x, neighbors):
    """One head's dot-product attention of the queries ``x`` [n, d] over the
    keys ``neighbors`` [m, d] (model.py:3879-3892)."""
    q = linear(params, name + ".wq", x)
    k = linear(params, name + ".wk", neighbors)
    attn = torch.softmax(q @ k.T, dim=1)
    return linear(params, name + ".wv", attn @ neighbors)


class _GatUnit(nn.Module):
    def __init__(self, d, device):
        super().__init__()
        self.wq, self.wk, self.wv = (Linear(d, d, device) for _ in range(3))


class IDCF_LGCN(BasicModel):
    graph_propagation = True

    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.embedding_size = model_config["embedding_size"]
        self.n_layers = model_config["n_layers"]
        self.n_headers = model_config["n_headers"]
        self.n_samples = model_config.get("n_samples", 50)
        self.n_old_users, self.n_old_items = self.n_users, self.n_items

        if "pretrained_embedding" in model_config:
            emb = np.asarray(model_config["pretrained_embedding"], np.float32)
        else:
            emb = load_checkpoint(model_config["lgcn_path"])["params"]["embedding"].numpy()
        want = (self.n_old_users + self.n_old_items, self.embedding_size)
        if emb.shape != want:
            raise ValueError(f"pretrained LightGCN table shape {emb.shape} != {want}")
        self.register_buffer("frozen_embedding", torch.as_tensor(emb, device=self.device))

        # feat: adjacency columns of the old users, then of the old items
        # (model.py:3921-3925); at build time every node is old
        row, col = bipartite_edges(dataset.train_array, self.n_users, self.n_items)
        self.feat = build_csr_spmm(
            row, col, np.ones(len(row), np.float32),
            (self.n_users + self.n_items, self.n_old_users + self.n_old_items), device=self.device,
        )
        self.norm_adj = build_norm_adj(dataset, self.device)
        d = self.embedding_size
        self.gat_units = nn.ModuleList(_GatUnit(d, self.device) for _ in range(self.n_headers))
        self.w_out = Linear(d * self.n_headers, d, self.device)
        self._weight_names = [name for name, _ in self.named_parameters()]
        self.init_params()

    @torch.no_grad()
    def init_params(self, generator=None):
        for unit in self.gat_units:
            for layer in (unit.wq, unit.wk, unit.wv):
                layer.reset(generator)
        self.w_out.reset(generator)
        return self.params()

    def draw_samples(self, generator=None) -> torch.Tensor:
        """int64 [n_headers, 2, n_samples] sampled (user, item) table rows,
        per head the users then the items (JAX ``idcf.py:103-106``), drawn on
        the CPU from ``generator``. None draws from a CPU generator seeded 0
        on every call, so that evaluation is deterministic; JAX draws its
        evaluation samples from ``jax.random.key(0)``, another stream."""
        g = torch.Generator().manual_seed(0) if generator is None else generator
        heads = []
        for _ in range(self.n_headers):
            su = torch.randint(0, self.n_old_users, (self.n_samples,), generator=g)
            si = torch.randint(0, self.n_old_items, (self.n_samples,), generator=g)
            heads.append(torch.stack([su, si]))
        return torch.stack(heads).to(self.device)

    def representations(self, params, generator=None, samples=None, contrastive=False):
        """(the fused heads [n, d], the per-node contrastive term [n] or None);
        ``samples`` as :meth:`draw_samples` gives them (drawn when None).
        The rows are the placement's: every row on one device, a rank's
        rows in edge mode (the rows past the graph's, its padding, with a
        contrastive term against a zero row)."""
        place, emb = self.placement, self.frozen_embedding
        with torch.no_grad():
            x_q = place.spmm(self.feat, place.local_rows(emb, self.feat, operand=True))
        if samples is None:
            samples = self.draw_samples(generator)
        w = place.shared(params, self._weight_names)
        first = place.first_row(x_q)
        n_u = min(max(self.n_users - first, 0), x_q.shape[0])  # the users come first
        outputs = []
        for i in range(self.n_headers):
            sampled_users = emb[samples[i, 0]]
            sampled_items = emb[self.n_old_users + samples[i, 1]]
            user_reps = relation_gat(w, f"gat_units.{i}", x_q[:n_u], sampled_users)
            item_reps = relation_gat(w, f"gat_units.{i}", x_q[n_u:], sampled_items)
            outputs.append(torch.cat([user_reps, item_reps], dim=0))
        reps = linear(w, "w_out", torch.cat(outputs, dim=1))
        if not contrastive:
            return reps, None
        u_rep, i_rep = reps[:n_u], reps[n_u:]
        user_loss = torch.logsumexp(u_rep @ sampled_users.T, dim=1) - (u_rep * emb[first : first + n_u]).sum(1)
        first_item = max(first - self.n_users, 0)
        item_own = emb[self.n_old_users + first_item :][: max(min(self.n_items - first_item, i_rep.shape[0]), 0)]
        if item_own.shape[0] < i_rep.shape[0]:
            item_own = torch.nn.functional.pad(item_own, (0, 0, 0, i_rep.shape[0] - item_own.shape[0]))
        item_loss = torch.logsumexp(i_rep @ sampled_items.T, dim=1) - (i_rep * item_own).sum(1)
        return reps, torch.cat([user_loss, item_loss])

    def get_rep(self, params, training=False, generator=None, samples=None, contrastive=False):
        reps, closs = self.representations(
            params, generator if training else None, samples, contrastive=contrastive
        )
        final = self.placement.propagate_mean(self.norm_adj, reps, self.n_layers)
        return (final, closs) if contrastive else final

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None, samples=None):
        """-> (users_r, pos_r, neg_r, l2, contrastive), l2 with the squared
        query and key weights of every head (model.py:3966-3972)."""
        rep, closs = self.get_rep(params, training, generator, samples, contrastive=True)
        rows = self.placement.batch_rows
        c_u, c_p, c_n = rows(closs, users, pos_items, neg_items, self.n_users)
        contrastive = c_u + c_p + c_n
        users_r, pos_r, neg_r = rows(rep, users, pos_items, neg_items, self.n_users)
        l2 = l2_sq_rows(users_r, pos_r, neg_r)
        for i in range(self.n_headers):
            l2 = l2 + (params[f"gat_units.{i}.wq.w"] ** 2).sum() + (params[f"gat_units.{i}.wk.w"] ** 2).sum()
        return users_r, pos_r, neg_r, l2, contrastive
