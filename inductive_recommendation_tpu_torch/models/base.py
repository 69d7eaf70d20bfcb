"""Model protocol (counterpart of ``inductive_recommendation_tpu/models/base.py``).

A model is an ``nn.Module`` that owns its parameters and its graph layouts on
one device. Its methods take the parameters as a ``{name: tensor}`` mapping,
as the JAX package's functions take a parameter pytree, so the same model can
be scored with parameters carried across from JAX (``models/convert.py``);
``model.params()`` is the module's own mapping:

    model = get_model(config, dataset, device="cuda")
    params = model.params()
    state = model.make_scoring_state(params)   # the full propagated rep
    scores = model.score(state, users)         # [B, n_items]
    u_r, p_r, n_r, l2 = model.bpr_forward(params, users, pos, neg,
                                          generator=cpu_generator)  # training

The forward passes take their sparse products, batch rows and the like
from ``model.placement`` (``models/placement.py``): one device unless a
trainer runs them under another inside ``model.placed(...)`` (edge mode).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from inductive_recommendation_tpu_torch.models.placement import LOCAL


class BasicModel(nn.Module):
    """Name/shape bookkeeping and the default dot-product scoring
    (reference model.py:35-53). ``trainable`` is False for the eval-only
    baselines (ItemKNN, Popularity), which ``BasicTrainer.train`` only
    validates. ``graph_propagation`` is True for the models whose forward
    pass propagates over the whole graph, the ones edge mode shards.
    ``graph_step`` is True for the models whose training step a trainer on
    one CUDA device replays as one CUDA graph (``train/step_graph.py``): the
    forward draws nothing on the host but its dropout seeds
    (``ops.csr_spmm.dropout_seed``) and rebinds no attribute of the model,
    and its step has been held bit for bit to the eager one on the card.
    The others stay eager, among them NGCF, whose message masks come from a
    CUDA generator seeded from the host (``ops.dropout.device_generator``)."""

    trainable = True
    graph_propagation = False
    graph_step = False
    #: where the forward passes run (``placed`` swaps it for a block)
    placement = LOCAL

    def __init__(self, model_config, dataset, device):
        super().__init__()
        self.config = dict(model_config)
        self.name = model_config["name"]
        self.dataset = dataset
        self.device = torch.device(device)
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        # tables round up to a multiple of this (kept from the JAX package,
        # where it made row-sharded tables divisible); padding rows are never
        # read
        self.table_align = int(model_config.get("table_align", 1))

    def _align_rows(self, n: int) -> int:
        a = max(self.table_align, 1)
        return -(-n // a) * a

    def params(self) -> dict[str, torch.Tensor]:
        """The module's own parameters by name."""
        return dict(self.named_parameters())

    def init_params(self, generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Refill the parameters in place from ``generator``; returns params()."""
        raise NotImplementedError

    def get_rep(self, params, training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        """Full [(n_users + n_items), d] representation matrix; ``generator``
        (on the CPU) seeds training-time randomness."""
        raise NotImplementedError

    def bpr_forward(self, params, users, pos_items, neg_items, training=True, generator=None):
        """-> (users_r, pos_r, neg_r, l2_norm_sq) for a BPR batch of int64 ids."""
        raise NotImplementedError

    @torch.no_grad()
    def make_scoring_state(self, params) -> torch.Tensor:
        """Computed once per evaluation; default: the full representation,
        whole on every rank."""
        return self.placement.gather(self.get_rep(params, training=False), self.n_users + self.n_items)

    @contextlib.contextmanager
    def placed(self, placement):
        """The forward passes run under ``placement`` inside the block."""
        before = self.placement
        self.placement = placement
        try:
            yield self
        finally:
            self.placement = before

    def edge_params(self, params) -> dict:
        """The parameters as edge mode holds them before it shards the
        tables: as they are, unless a model keeps rows of a table apart."""
        return params

    def from_edge_params(self, params) -> dict:
        """The inverse of :meth:`edge_params`, back to the model's layout."""
        return params

    def score(self, state, users) -> torch.Tensor:
        """[B, n_items] dot-product scores against the item reps
        (reference model.py:122-127)."""
        return state[users] @ state[self.n_users :].T

    def checkpoint_aux(self):
        """Non-parameter state to persist with a checkpoint."""
        return {}

    def restore_aux(self, aux):
        pass


def l2_sq_rows(*tensors) -> torch.Tensor:
    """Per-sample sum of squared L2 norms, the reference's regularizer
    (model.py:69-70 et al.)."""
    total = 0.0
    for t in tensors:
        total = total + (t * t).sum(dim=-1)
    return total


class Linear(nn.Module):
    """A linear layer's parameters in the JAX package's layout
    (``models/base.py:127-136`` there): ``w`` [in, out], ``b`` [out], applied
    as ``x @ w + b``, so that parameters carry across untransposed."""

    def __init__(self, in_features: int, out_features: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_features, out_features, device=device))
        self.b = nn.Parameter(torch.empty(out_features, device=device))
        self.reset(None)

    @torch.no_grad()
    def reset(self, generator):
        """Kaiming-uniform weight over fan_in = in_features, zero bias
        (reference init_one_layer, model.py:28-32)."""
        kaiming_uniform_(self.w, self.w.shape[0], generator)
        self.b.zero_()


def linear(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with the layer ``name``'s entries of ``params``."""
    return x @ params[name + ".w"] + params[name + ".b"]


@torch.no_grad()
def kaiming_uniform_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) in place (JAX
    ``kaiming_uniform_init``)."""
    bound = math.sqrt(6.0 / fan_in)
    return t.uniform_(-bound, bound, generator=generator)
