"""Edge mode's placement: a model's forward pass over this rank's shards
(counterpart of the JAX package's edge-sharded steps, which keep a copy of
each model's forward pass; here the model's own runs).

:class:`EdgePlacement` gives a model (``models/placement.py`` lists what it
asks of a placement) the operators of a ('data', 'model') mesh on which the
graph, the embedding table and its Adam moments are sharded over 'model':

- a product over a layout runs on this rank's shard of it
  (``parallel/spmm.py``): the model passes the whole layout it holds, and
  the shard is cut on the device (``shard_csr``) the first time that
  layout is seen and dropped with it, so that a layout the model rebuilds
  (a per-epoch view, the feature matrix after an anneal, the graph after
  ``attach_dataset`` or a checkpoint load) is cut anew. Its output is this
  rank's block of rows, the next product's operand;
- a batch's rows come from a masked local gather summed over the 'model'
  group (JAX step.py:270-282): one all-reduce for a batch's users,
  positives and negatives, whose backward passes the cotangent on, so
  every rank of the group computes the same loss;
- replicated weights applied to a rank's own rows enter through
  ``collectives.shared``, whose backward sums the group's parts;
- a mask drawn whole is cut to this rank's rows, so every draw is the
  single-device model's;
- AttIGCN's attention folds the query on this rank's rows, gathers it and
  runs the sharded softmax (``parallel/attention.py``);
- the representation for scoring is all-gathered whole.

The product's dropout is keyed by the global edge id, so the masks are the
single-device ones; at world 1 the shard is the whole layout and its
transpose the whole layout's, and a step is the single-device step.
"""

from __future__ import annotations

import functools
import weakref

import torch

from inductive_recommendation_tpu_torch.ops.attention_spmm import folded_query
from inductive_recommendation_tpu_torch.parallel.attention import sharded_attention
from inductive_recommendation_tpu_torch.parallel.collectives import (
    all_gather,
    gather_rows_grad,
    replicated_sum,
    shared,
)
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, local_rows
from inductive_recommendation_tpu_torch.parallel.spmm import (
    ROUTE,
    edge_sharded_spmm,
    edge_sharded_spmm_values,
    propagate_sharded,
    shard_csr,
    values_shard,
)


def _masked_take(t, ids, rank, group):
    """Rows ``ids`` of a tensor row-sharded over ``group`` (this rank holds
    rows ``[rank * len(t), (rank + 1) * len(t))``), on every rank: each rank's
    rows it holds, the rest 0, summed over the group. ``ids`` is a tuple of
    id tensors, each gathered by its own index, so that the backward sums a
    repeated row's cotangents as the single-device index ops do; one
    all-reduce serves them all."""
    block, parts = t.shape[0], []
    for g in ids:
        local = g - rank * block
        ok = (local >= 0) & (local < block)
        parts.append(torch.where(ok.view(-1, *[1] * (t.ndim - 1)), t[torch.clamp(local, 0, block - 1)], 0.0))
    rows = replicated_sum(torch.cat(parts) if len(parts) > 1 else parts[0], group)
    return rows.split([len(g) for g in ids])


class EdgePlacement:
    """Edge mode on ``mesh``: see the module docstring. ``negatives`` maps a
    'data' slice's view rows to the whole batch's (InfoNCE's negatives),
    None when the batch is not split."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group("model")
        self.rank = mesh.get_local_rank("model")
        self.negatives = None
        if axis_size(mesh, "data") > 1:
            self.negatives = functools.partial(gather_rows_grad, group=mesh.get_group("data"))
        self._shards = {}

    # -- layouts -----------------------------------------------------------------
    def cut(self, mat):
        """This rank's shard of the whole layout ``mat``, cut anew; a values
        layout's shard is one too."""
        route = ROUTE if mat.route is None else f"{ROUTE}_{mat.route}"
        shard = shard_csr(mat, axis_size(self.mesh, "model"), self.rank, route)
        return shard if mat.t_pos is None else values_shard(shard, route)

    def shard(self, mat):
        """:meth:`cut` once for each layout, kept while the layout lives."""
        key = id(mat)
        if key not in self._shards:
            ref = weakref.ref(mat, lambda _, key=key, shards=self._shards: shards.pop(key, None))
            self._shards[key] = (ref, self.cut(mat))
        return self._shards[key][1]

    # -- the operators -----------------------------------------------------------
    def spmm(self, mat, x):
        return edge_sharded_spmm(self.shard(mat), x, self.group, "scatter")

    def spmm_dropout(self, mat, x, seed: int, p: float):
        return edge_sharded_spmm(self.shard(mat), x, self.group, "scatter", drop=(seed, p))

    def spmm_values(self, mat, x, values):
        return edge_sharded_spmm_values(self.shard(mat), x, values, self.group)

    def propagate_mean(self, mat, x0, n_layers: int):
        return propagate_sharded(self.shard(mat), x0, n_layers, self.group)

    def rows(self, t, ids):
        return _masked_take(t, (ids,), self.rank, self.group)[0]

    def batch_rows(self, t, users, pos, neg, offset: int):
        return _masked_take(t, (users, offset + pos, offset + neg), self.rank, self.group)

    def shared(self, params, names):
        """``params`` with the replicated weights ``names`` made shared, in
        one all-reduce in the backward; as they are with no gradient."""
        if not torch.is_grad_enabled():
            return params
        names = list(names)
        return dict(params, **dict(zip(names, shared([params[name] for name in names], self.group))))

    def local_rows(self, t, mat, operand: bool = False):
        shard = self.shard(mat)
        return local_rows(t, self.mesh, n_rows=shard.n_cols_pad if operand else shard.n_rows_pad)

    def first_row(self, t) -> int:
        return self.rank * t.shape[0]

    def attention(self, op, mat, q, w_k, b_k, v, temperature: float):
        """The folded query of this rank's rows gathered whole, then the
        attention on this rank's edges of ``mat`` (``op``, the single-device
        attention, is not used)."""
        qk, qb = folded_query(q, w_k, b_k, v.shape[-1])
        qk, qb = (gather_rows_grad(t.contiguous(), self.group) for t in (qk, qb))
        return sharded_attention(self.shard(mat), qk, qb, v, temperature, self.group)

    def gather(self, rep, n_rows: int):
        return all_gather(rep.contiguous(), self.group)[:n_rows]
