"""NeuMF (reference model.py:4411-4467; counterpart of
``inductive_recommendation_tpu/models/neumf.py``): GMF and MLP towers with
the pretraining architectures ``gmf`` -> ``mlp`` -> ``neumf`` that
``BCETrainer``'s three phases switch (trainer.py:575-586). No sparse
product."""

from __future__ import annotations

import torch
from torch import nn

from inductive_recommendation_tpu_torch.models.base import BasicModel, Linear, kaiming_uniform_

ARCHS = ("gmf", "mlp", "neumf")


class NeuMF(BasicModel):
    def __init__(self, model_config, dataset, device):
        super().__init__(model_config, dataset, device)
        self.embedding_size = model_config["embedding_size"]
        self.layer_sizes = list(model_config["layer_sizes"])
        self.arch = "gmf"
        d, half = self.embedding_size, self.layer_sizes[0] // 2
        n_u, n_i = self._align_rows(self.n_users), self._align_rows(self.n_items)

        def table(rows, width):
            return nn.Parameter(torch.empty(rows, width, device=self.device))

        self.mf_user_embedding, self.mf_item_embedding = table(n_u, d), table(n_i, d)
        self.mlp_user_embedding, self.mlp_item_embedding = table(n_u, half), table(n_i, half)
        sizes = self.layer_sizes
        self.mlp_layers = nn.ModuleList(Linear(sizes[i], sizes[i + 1], self.device) for i in range(len(sizes) - 1))
        # the ones-initialized fusion layer, no bias (model.py:4439)
        self.output_w = nn.Parameter(torch.empty(sizes[-1] + d, device=self.device))
        self.init_params()

    @torch.no_grad()
    def init_params(self, generator=None):
        for t in (self.mf_user_embedding, self.mf_item_embedding, self.mlp_user_embedding, self.mlp_item_embedding):
            kaiming_uniform_(t, t.shape[1], generator)
        return self.init_mlp_layers(generator)

    @torch.no_grad()
    def init_mlp_layers(self, generator=None):
        """Re-randomize the MLP layers and reset the fusion weights to ones
        (model.py:4435-4439), in place: the start of the ``neumf`` phase."""
        for layer in self.mlp_layers:
            layer.reset(generator)
        self.output_w.fill_(1.0)
        return self.params()

    def checkpoint_aux(self):
        # the pretraining phase is model state: a resume past a phase
        # boundary lands in the saved architecture
        return {"arch": self.arch}

    def restore_aux(self, aux):
        if aux and "arch" in aux:
            self.arch = str(aux["arch"])

    def bce_forward(self, params, users, items, arch=None):
        """-> (logits [B], l2 [B]) per model.py:4441-4460."""
        arch = arch or self.arch
        if arch not in ARCHS:
            raise ValueError(f"arch {arch!r} is not one of {ARCHS}")
        mf_vec = params["mf_user_embedding"][users] * params["mf_item_embedding"][items]
        mlp_vec = torch.cat([params["mlp_user_embedding"][users], params["mlp_item_embedding"][items]], dim=1)
        for i in range(len(self.mlp_layers)):
            w, b = params[f"mlp_layers.{i}.w"], params[f"mlp_layers.{i}.b"]
            mlp_vec = nn.functional.leaky_relu(mlp_vec @ w + b, negative_slope=0.01)
        if arch == "gmf":
            mlp_vec = torch.zeros_like(mlp_vec)
        elif arch == "mlp":
            mf_vec = torch.zeros_like(mf_vec)
        scored = torch.cat([mf_vec, mlp_vec], dim=1) * params["output_w"][None, :]
        return scored.sum(dim=1), (scored**2).sum(dim=1)

    def make_scoring_state(self, params):
        return params

    def score(self, state, users, item_block: int = 8192):
        """[B, n_items] logits of every (user, item) pair, item block by item
        block (the reference flattens the whole B x n_items grid at once,
        model.py:4462-4466; blocks bound the memory)."""
        out = []
        for start in range(0, self.n_items, item_block):
            items = torch.arange(start, min(start + item_block, self.n_items), device=users.device)
            logits, _ = self.bce_forward(state, users.repeat_interleave(len(items)), items.repeat(len(users)))
            out.append(logits.view(len(users), len(items)))
        return torch.cat(out, dim=1)
