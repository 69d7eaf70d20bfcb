"""Sharded training steps for LightGCN (BPR) and IGCN (counterpart of
``inductive_recommendation_tpu/parallel/step.py``'s BPR and IGCN steps).

Every step takes the GLOBAL batch as its arguments: every rank draws the same
batch from the same generator state (the trainer samples it with the
device sampler) and keeps its slice, so the loss is the single-device
trainer's on the same seed. Steps update ``params`` in place through
``optimizer`` and return the global batch loss, the same on every rank.

Data mode (:func:`make_sharded_bpr_step`, :func:`make_sharded_igcn_step`):
the model runs whole on every rank, on its 1/(D*S) slice of the batch. Its
tables are row-sharded over 'model' (``parallel/mesh.py``), all-gathered
before the forward; a table's gradient is reduce-scattered back over 'model'
(the ranks of a 'model' group hold different slices of the batch), the
rest all-reduced over every rank, and the tables' Adam moments stay
sharded. The loss is each slice's sum over the global batch size, so the
reductions are plain sums.

Edge mode (:func:`make_edge_sharded_bpr_step`,
:func:`make_edge_sharded_igcn_step`): the graph (``parallel/spmm.py``), the
table and its Adam moments are sharded over 'model', and on a (D, S) mesh
the batch splits D ways over 'data' while every product and its collectives
stay inside the S ranks of a 'model' group. The ranks of a group compute
one loss alike: the batch rows of the row-sharded representation come from
a masked local gather summed over the group (``_masked_take``, a
batch-sized all-reduce whose backward passes the cotangent on). Each
group's loss is its slice's sum over the global batch, and one gradient
all-reduce over 'data' joins the groups (JAX step.py:355-357).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed
from inductive_recommendation_tpu_torch.parallel.collectives import all_gather, all_reduce, reduce_scatter, replicated_sum
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, param_spec
from inductive_recommendation_tpu_torch.parallel.spmm import bake_annealed, edge_sharded_spmm, propagate_sharded


def _slice(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"batch_size {n} must divide over {parts} {what}")
    b = n // parts
    return slice(index * b, (index + 1) * b)


# -- data mode -------------------------------------------------------------------


def _make_data_step(optimizer, params, batch_size, mesh, local_loss):
    """The data-parallel step around ``local_loss(full_params, *batch_slice)``,
    the mean-based objective of one slice."""
    sl = _slice(batch_size, mesh.size(), dist.get_rank(), f"ranks of the mesh {tuple(mesh.shape)}")
    share = (sl.stop - sl.start) / batch_size
    model_g, data_g = mesh.get_group("model"), mesh.get_group("data")
    n_data = axis_size(mesh, "data")

    def step(*batch):
        full = {
            name: all_gather(p.detach(), model_g).requires_grad_(True) if param_spec(name, p) else p
            for name, p in params.items()
        }
        loss = local_loss(full, *(t[sl] for t in batch)) * share
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for name, p in params.items():
            g = full[name].grad if param_spec(name, p) else p.grad
            if g is None:
                continue
            if param_spec(name, p):
                g = reduce_scatter(g, model_g)
                if n_data > 1:
                    all_reduce(g, data_g)
            else:
                all_reduce(g, None)
            p.grad = g
        optimizer.step()
        return all_reduce(loss.detach(), None)

    return step


def make_sharded_bpr_step(model, optimizer, params, batch_size, l2_reg, mesh, generator=None):
    """-> step(users, pos, neg) -> loss: BPR + L2 (JAX step.py:70-101) over
    ``params`` sharded by ``mesh.shard_params``; ``generator`` (CPU) seeds a
    model's training-time dropout, the same on every rank."""
    from inductive_recommendation_tpu_torch.train.losses import bpr_loss  # the training package imports this module

    def local_loss(full, users, pos, neg):
        u_r, p_r, n_r, l2 = model.bpr_forward(full, users, pos, neg, training=True, generator=generator)[:4]
        return bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean()

    return _make_data_step(optimizer, params, batch_size, mesh, local_loss)


def make_sharded_igcn_step(model, optimizer, params, batch_size, l2_reg, aux_reg, mesh, generator=None):
    """-> step(users, pos, neg, a_users, a_pos, a_neg) -> loss: IGCN's main
    BPR + L2 + the auxiliary BPR on the core table weighted by w (JAX
    step.py:1879-1922)."""
    from inductive_recommendation_tpu_torch.train.losses import aux_bpr_w, bpr_loss

    def local_loss(full, users, pos, neg, a_users, a_pos, a_neg):
        u_r, p_r, n_r, l2 = model.bpr_forward(full, users, pos, neg, training=True, generator=generator)[:4]
        aux = aux_bpr_w(full["embedding"], full["w"], a_users, a_pos, a_neg, model.user_dim)
        return bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean() + aux_reg * aux

    return _make_data_step(optimizer, params, batch_size, mesh, local_loss)


# -- edge mode -------------------------------------------------------------------


def _masked_take(tbl, ids, block, rank, group):
    """Rows ``ids`` of a table row-sharded over ``group`` (this rank holds
    ``[rank * block, (rank + 1) * block)``), on every rank: each rank's rows
    it owns, the rest 0, summed over the group (JAX step.py:270-282)."""
    lid = ids - rank * block
    ok = (lid >= 0) & (lid < block)
    rows = torch.where(ok[:, None], tbl[torch.clamp(lid, 0, block - 1)], 0.0)
    return replicated_sum(rows, group)


class _EdgeStep:
    """What the edge steps share: the mesh's groups, this rank's batch slice
    over 'data', and the update with its one gradient all-reduce over 'data'."""

    def __init__(self, mesh, optimizer, params, batch_size):
        self.group = mesh.get_group("model")
        self.data_group = mesh.get_group("data") if axis_size(mesh, "data") > 1 else None
        self.sl = _slice(batch_size, axis_size(mesh, "data"), mesh.get_local_rank("data"), "ranks of the 'data' axis")
        self.b = self.sl.stop - self.sl.start
        self.optimizer, self.params, self.batch_size = optimizer, params, batch_size

    def update(self, total):
        """``total``: this slice's summed objective; returns the global loss."""
        loss = total / self.batch_size
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.data_group is not None:
            for p in self.params.values():
                if p.grad is not None:
                    all_reduce(p.grad, self.data_group)
        self.optimizer.step()
        loss = loss.detach()
        return loss if self.data_group is None else all_reduce(loss, self.data_group)

    def gather_rep(self, rep_local, n_rows):
        return all_gather(rep_local, self.group)[:n_rows]

    def take(self, tbl, ids, block, rank):
        """Rows ``ids`` of the row-sharded ``tbl``, split [users; pos; neg]."""
        return _masked_take(tbl, ids, block, rank, self.group).split(self.b)


def make_edge_sharded_bpr_step(emat, mesh, optimizer, params, batch_size, l2_reg, n_users, n_layers):
    """LightGCN's BPR step with the adjacency (``emat``, this rank's shard),
    the ``[n_cols_pad, d]`` table (``params["embedding"]``, this rank's
    ``[block, d]`` rows) and its Adam moments sharded over 'model' (JAX
    step.py:104-268): ``BPRTrainer``'s objective, BPR + L2 on the ego rows,
    on this rank's slice. -> step(users, pos, neg) -> loss, with
    ``step.eval_rep()``: the whole ``[n_rows, d]`` representation on every
    rank, forward only."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows  # the model package imports the trainers
    from inductive_recommendation_tpu_torch.train.losses import bpr_loss

    es = _EdgeStep(mesh, optimizer, params, batch_size)

    def step(users, pos, neg):
        ids = torch.cat([users[es.sl], n_users + pos[es.sl], n_users + neg[es.sl]])
        x = params["embedding"]
        rep = propagate_sharded(emat, x, n_layers, es.group)
        l2 = l2_sq_rows(*es.take(x, ids, emat.block, emat.rank))
        loss = bpr_loss(*es.take(rep, ids, emat.row_block, emat.rank)) + l2_reg * l2.mean()
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep():
        return es.gather_rep(propagate_sharded(emat, params["embedding"], n_layers, es.group), emat.n_rows)

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_igcn_step(feat_emat, adj_emat, row_sum, mesh, optimizer, params, batch_size, l2_reg, aux_reg,
                                n_users, user_dim, n_layers, dropout, generator=None):
    """IGCN's step with the feature matrix (``feat_emat``), the adjacency
    (``adj_emat``), the core table and its Adam moments sharded over 'model'
    (JAX step.py:285-586): the inductive layer (annealed values baked once an
    alpha, edge dropout drawn in the kernel from the global edge ids with a
    seed from the CPU ``generator``, as the single-device model draws it),
    ``n_layers`` adjacency layers (0: IMF), and ``IGCNTrainer``'s objective
    on this rank's slice: BPR + L2 on the batch's reps and the auxiliary BPR
    on the core rows weighted by ``params["w"]``.

    -> step(users, pos, neg, a_users, a_pos, a_neg, alpha=1.0) -> loss, and
    ``step.eval_rep(alpha)``: the whole representation on every rank."""
    if feat_emat.n_rows_pad != adj_emat.n_cols_pad:
        raise ValueError("feat output rows and adjacency operand rows must pad identically")
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows
    from inductive_recommendation_tpu_torch.train.losses import aux_bpr_rows, bpr_loss

    es = _EdgeStep(mesh, optimizer, params, batch_size)
    p_drop = float(dropout)
    baked = {}

    def feat_at(alpha):
        a = float(alpha)
        if a not in baked:  # once an epoch (feat_mat_anneal)
            baked.clear()
            baked[a] = bake_annealed(feat_emat, row_sum, a)
        return baked[a]

    def rep_local(alpha, drop=None):
        x0 = edge_sharded_spmm(feat_at(alpha), params["embedding"], es.group, "scatter", drop=drop)
        return propagate_sharded(adj_emat, x0, n_layers, es.group)

    def step(users, pos, neg, a_users, a_pos, a_neg, alpha=1.0):
        drop = (dropout_seed(generator), p_drop) if p_drop > 0.0 else None
        ids = torch.cat([users[es.sl], n_users + pos[es.sl], n_users + neg[es.sl]])
        reps = es.take(rep_local(alpha, drop), ids, feat_emat.row_block, feat_emat.rank)
        a_ids = torch.cat([a_users[es.sl], user_dim + a_pos[es.sl], user_dim + a_neg[es.sl]])
        aux = aux_bpr_rows(*es.take(params["embedding"], a_ids, feat_emat.block, feat_emat.rank), params["w"])
        # L2 on the propagated reps, as IGCN.bpr_forward
        loss = bpr_loss(*reps) + l2_reg * l2_sq_rows(*reps).mean() + aux_reg * aux
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep(alpha):
        return es.gather_rep(rep_local(alpha), feat_emat.n_rows)

    step.eval_rep = eval_rep
    return step
