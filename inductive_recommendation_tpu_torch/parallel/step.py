"""Sharded training steps (counterpart of
``inductive_recommendation_tpu/parallel/step.py``).

Every step takes the GLOBAL batch as its arguments: every rank draws the same
batch from the same generator state (the trainer samples it with the
device sampler) and keeps its slice, so the loss is the single-device
trainer's on the same seed. Steps update ``params`` in place through
``optimizer`` and return the global batch loss, the same on every rank.

Data mode (:func:`make_data_step`, around a trainer's ``batch_loss``): the
model runs whole on every rank, on its 1/(D*S) slice of the batch. Its tables are
row-sharded over 'model' (``parallel/mesh.py``), all-gathered before the
forward; a table's gradient is reduce-scattered back over 'model' (the
ranks of a 'model' group hold different slices of the batch), the rest
all-reduced over every rank, and the tables' Adam moments stay sharded.
Each rank's loss is its slice's term of the global loss, so the reductions
are plain sums. In-batch InfoNCE takes the whole batch's view rows as its
negatives: a slice gathers them (``collectives.gather_rows_grad``).

Edge mode (``make_edge_sharded_*_step``): the graph (``parallel/spmm.py``),
the table and its Adam moments are sharded over 'model', and on a (D, S)
mesh the batch splits D ways over 'data' while every product and its
collectives stay inside the S ranks of a 'model' group. The ranks of a group
compute one loss alike: the batch rows of a row-sharded representation come
from a masked local gather summed over the group (``_masked_take``, a
batch-sized all-reduce whose backward passes the cotangent on). A
replicated weight applied to a rank's own rows (NGCF's, IDCF's and AttIGCN's
linear layers) enters through ``collectives.shared``, whose backward sums
the group's parts. Each group's loss is its slice's sum over the global
batch; one gradient all-reduce over 'data' joins the groups (JAX
step.py:355-357), and InfoNCE's negatives are gathered over 'data'.

The families: LightGCN (:func:`make_edge_sharded_bpr_step`), IGCN / IMF
(:func:`make_edge_sharded_igcn_step`), the DOSE variants
(:func:`make_edge_sharded_dose_step`, the four contrastive modes over
per-epoch view shards, DOSE_aug2's augmented feature shard), SGL / HALF
(:func:`make_edge_sharded_sgl_step`), NGCF, IMCGAE, IDCF_LGCN and AttIGCN
(with the sharded attention softmax, ``parallel/attention.py``). Every
random draw (the dropout seeds, NGCF's message masks, IMCGAE's node masks,
IDCF's samples) is made in the single-device model's order and count from
the same host generator, and the kernel keys its edge dropout by the
global edge id, so the masks are the single-device ones; the JAX package
draws per shard (its parity is checked at dropout 0). Each step builds its
loss's terms in the single-device model's and trainer's order (the L2 of
the batch rows before the BPR term, as ``bpr_forward`` computes it): a batch
row feeds several terms, and the backward sums their cotangents in the
reverse order of their creation, so another order changes the gradients'
last bits, which NGCF's training amplifies within a few steps.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch.ops.csr_spmm import dropout_seed
from inductive_recommendation_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    gather_rows_grad,
    reduce_scatter,
    replicated_sum,
    shared,
)
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, local_rows, param_spec
from inductive_recommendation_tpu_torch.parallel.spmm import (
    bake_annealed,
    edge_sharded_spmm,
    propagate_sharded,
    values_shard,
)

#: the DOSE contrastive modes (JAX step.py:620-633)
DOSE_MODES = ("single", "double_same", "cross", "mean")


def _slice(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"batch_size {n} must divide over {parts} {what}")
    b = n // parts
    return slice(index * b, (index + 1) * b)


# -- data mode -------------------------------------------------------------------


def make_data_step(optimizer, params, batch_size, mesh, local_loss, prepare=None):
    """The data-parallel step around ``local_loss(full_params, sl,
    *global_batch)``, which returns this rank's term of the global loss
    from the rows ``sl`` of the batch. ``optimizer`` may be a callable that
    returns the current optimizer (a trainer that re-creates it);
    ``prepare(*batch)`` extends the global batch before the slice (the
    draws a model makes over the whole batch)."""
    sl = _slice(batch_size, mesh.size(), dist.get_rank(), f"ranks of the mesh {tuple(mesh.shape)}")
    model_g, data_g = mesh.get_group("model"), mesh.get_group("data")
    n_data = axis_size(mesh, "data")

    def step(*batch):
        opt = optimizer() if callable(optimizer) else optimizer
        full = {
            name: all_gather(p.detach(), model_g).requires_grad_(True) if param_spec(name, p) else p
            for name, p in params.items()
        }
        if prepare is not None:
            batch = prepare(*batch)
        loss = local_loss(full, sl, *batch)
        opt.zero_grad(set_to_none=True)
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
        opt.step()
        return all_reduce(loss.detach(), None)

    return step


def mean_loss_on_slice(mean_loss, batch_size):
    """``local_loss`` for :func:`make_data_step` from a mean-based objective
    ``mean_loss(full, *batch_slice)``: the slice's mean times its share."""

    def local_loss(full, sl, *batch):
        return mean_loss(full, *(t[sl] for t in batch)) * ((sl.stop - sl.start) / batch_size)

    return local_loss


def gather_negatives(v: torch.Tensor) -> torch.Tensor:
    """A data-mode slice's view rows -> the whole batch's, in rank order
    (every rank of the mesh holds one slice)."""
    return gather_rows_grad(v, None)


# -- edge mode -------------------------------------------------------------------


def _masked_take(tbl, ids, block, rank, group):
    """Rows ``ids`` of a table row-sharded over ``group`` (this rank holds
    ``[rank * block, (rank + 1) * block)``), on every rank: each rank's rows
    it owns, the rest 0, summed over the group (JAX step.py:270-282).

    ``ids`` may be a tuple of id tensors: each is gathered by its own index,
    as the single-device models index a batch's users, positives and
    negatives apart, so that the backward sums a repeated row's cotangents
    in the same order; one all-reduce serves them all, and the rows come
    back split alike."""
    groups = ids if isinstance(ids, tuple) else (ids,)
    parts = []
    for g in groups:
        lid = g - rank * block
        ok = (lid >= 0) & (lid < block)
        parts.append(torch.where(ok[:, None], tbl[torch.clamp(lid, 0, block - 1)], 0.0))
    rows = replicated_sum(torch.cat(parts) if len(parts) > 1 else parts[0], group)
    return rows.split([len(g) for g in groups]) if isinstance(ids, tuple) else rows


class _EdgeStep:
    """What the edge steps share: the mesh's groups, this rank's batch slice
    over 'data', the update with its one gradient all-reduce over 'data',
    and InfoNCE's negatives gathered over 'data'."""

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
        """Rows of the row-sharded ``tbl`` for each id tensor of the tuple
        ``ids`` (users, positives, negatives for a batch)."""
        return _masked_take(tbl, ids, block, rank, self.group)

    def negatives(self, v):
        """The slice's view rows -> the global batch's (InfoNCE's negatives)."""
        return v if self.data_group is None else gather_rows_grad(v, self.data_group)

    def batch_ids(self, users, pos, neg, n_users):
        return users[self.sl], n_users + pos[self.sl], n_users + neg[self.sl]

    def shared(self, names):
        """The replicated parameters ``names`` for row-local work."""
        names = list(names)
        return dict(zip(names, shared([self.params[name] for name in names], self.group)))


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
        ids = es.batch_ids(users, pos, neg, n_users)
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


class _Inductive:
    """The inductive layer over a sharded feature matrix: the annealed
    values baked once an alpha (``bake_annealed``), the edge dropout drawn in
    the kernel from the global edge ids with a seed from the CPU
    ``generator``, then ``n_layers`` adjacency layers."""

    def __init__(self, es, feat_emat, adj_emat, row_sum, n_layers, dropout, generator):
        if feat_emat.n_rows_pad != adj_emat.n_cols_pad:
            raise ValueError("feat output rows and adjacency operand rows must pad identically")
        self.es, self.feat, self.adj, self.row_sum = es, feat_emat, adj_emat, row_sum
        self.n_layers, self.p, self.generator = n_layers, float(dropout), generator
        self.baked = {}

    def feat_at(self, alpha):
        a = float(alpha)
        if a not in self.baked:  # once an epoch (feat_mat_anneal)
            self.baked.clear()
            self.baked[a] = bake_annealed(self.feat, self.row_sum, a)
        return self.baked[a]

    def draw(self):
        """The next dropout (seed, p) from the host generator, or None."""
        return (dropout_seed(self.generator), self.p) if self.p > 0.0 else None

    def x0(self, x, alpha, drop=None, feat=None):
        """Layer 0: the (annealed) feature product of the table rows ``x``."""
        feat = self.feat_at(alpha) if feat is None else feat
        return edge_sharded_spmm(feat, x, self.es.group, "scatter", drop=drop)

    def propagate(self, x0, adj=None):
        return propagate_sharded(self.adj if adj is None else adj, x0, self.n_layers, self.es.group)

    def batch_reps(self, rep, ids):
        return self.es.take(rep, ids, self.feat.row_block, self.feat.rank)

    def aux_rows(self, x, a_users, a_pos, a_neg, user_dim):
        sl = self.es.sl
        return self.es.take(x, (a_users[sl], user_dim + a_pos[sl], user_dim + a_neg[sl]), self.feat.block,
                            self.feat.rank)


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
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows
    from inductive_recommendation_tpu_torch.train.losses import aux_bpr_rows, bpr_loss

    es = _EdgeStep(mesh, optimizer, params, batch_size)
    ind = _Inductive(es, feat_emat, adj_emat, row_sum, n_layers, dropout, generator)

    def step(users, pos, neg, a_users, a_pos, a_neg, alpha=1.0):
        x = params["embedding"]
        reps = ind.batch_reps(ind.propagate(ind.x0(x, alpha, ind.draw())), es.batch_ids(users, pos, neg, n_users))
        l2 = l2_sq_rows(*reps)  # on the propagated reps, as IGCN.bpr_forward
        aux = aux_bpr_rows(*ind.aux_rows(x, a_users, a_pos, a_neg, user_dim), params["w"])
        loss = bpr_loss(*reps) + l2_reg * l2.mean() + aux_reg * aux
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep(alpha):
        return es.gather_rep(ind.propagate(ind.x0(params["embedding"], alpha)), feat_emat.n_rows)

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_dose_step(feat_emat, adj_emat, row_sum, mesh, optimizer, params, batch_size, l2_reg, aux_reg,
                                contrastive_reg, n_users, user_dim, n_layers, dropout, contrastive="single",
                                generator=None):
    """The DOSE family's step (JAX step.py:588-1100): IGCN's step plus
    ``contrastive_reg`` times the variant's term over per-epoch view shards
    (``parallel.spmm.shard_csr`` of the model's view CSRs). The view
    branch's layer 0 is the feature product under its own dropout draw
    (model.py:488-501), or, once DOSE_aug2 has one, the augmented feature
    matrix's shard (already annealed) under that draw. The modes:

    - ``single``: InfoNCE(users_r, v, v) over one view;
    - ``double_same``: two draws over the same view, the InfoNCE terms
      summed (DOSE_aug_drop);
    - ``cross``: InfoNCE(v1, v2, v2) between two views (TEST2);
    - ``mean``: the mean of the view's user rows (DOSE_test).

    -> step(users, pos, neg, a_users, a_pos, a_neg, views, alpha=1.0,
    aug_feat=None) -> loss, ``views`` a tuple of one or two view shards;
    ``step.eval_rep(alpha)`` scores with the main representation."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows
    from inductive_recommendation_tpu_torch.train.losses import aux_bpr_rows, bpr_loss, info_nce

    if contrastive not in DOSE_MODES:
        raise ValueError(f"unknown contrastive mode {contrastive!r}; one of {DOSE_MODES}")
    es = _EdgeStep(mesh, optimizer, params, batch_size)
    ind = _Inductive(es, feat_emat, adj_emat, row_sum, n_layers, dropout, generator)

    def step(users, pos, neg, a_users, a_pos, a_neg, views, alpha=1.0, aug_feat=None):
        x = params["embedding"]
        reps = ind.batch_reps(ind.propagate(ind.x0(x, alpha, ind.draw())), es.batch_ids(users, pos, neg, n_users))
        u_r, l2 = reps[0], l2_sq_rows(*reps)

        def view_users(view):
            # a fresh dropout draw for each view branch, as get_rep draws it
            rep_v = ind.propagate(ind.x0(x, alpha, ind.draw(), feat=aug_feat), adj=view)
            return _masked_take(rep_v, users[es.sl], view.row_block, view.rank, es.group)

        if contrastive == "single":
            v = view_users(views[0])
            closs = info_nce(u_r, v, es.negatives(v))
        elif contrastive == "double_same":
            v1, v2 = view_users(views[0]), view_users(views[0])
            closs = info_nce(u_r, v1, es.negatives(v1)) + info_nce(u_r, v2, es.negatives(v2))
        elif contrastive == "cross":
            v1, v2 = view_users(views[0]), view_users(views[-1])
            closs = info_nce(v1, v2, es.negatives(v2))
        else:
            # the mean of the [B, d] slot: per row, its mean over d
            closs = view_users(views[0]).mean(dim=1)
        aux = aux_bpr_rows(*ind.aux_rows(x, a_users, a_pos, a_neg, user_dim), params["w"])
        loss = bpr_loss(*reps) + l2_reg * l2.mean() + aux_reg * aux + contrastive_reg * closs.mean()
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep(alpha):
        return es.gather_rep(ind.propagate(ind.x0(params["embedding"], alpha)), feat_emat.n_rows)

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_sgl_step(adj_emat, mesh, optimizer, params, batch_size, l2_reg, contrastive_reg, n_users,
                               n_layers, contrastive="cross"):
    """SGL / HALF over the LightGCN base (JAX step.py:1101-1262): BPR + L2 on
    the propagated reps + ``contrastive_reg`` times InfoNCE between the two
    drop views' user rows (``cross``, SGL) or between the main rows and one
    view's (``single``, HALF), the views per-epoch shards.

    -> step(users, pos, neg, views) -> loss; ``step.eval_rep()``."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows
    from inductive_recommendation_tpu_torch.train.losses import bpr_loss, info_nce

    if contrastive not in ("single", "cross"):
        raise ValueError(f"unknown contrastive mode {contrastive!r}")
    es = _EdgeStep(mesh, optimizer, params, batch_size)

    def view_users(view, x, users):
        return _masked_take(propagate_sharded(view, x, n_layers, es.group), users[es.sl], view.row_block, view.rank,
                            es.group)

    def step(users, pos, neg, views):
        x = params["embedding"]
        rep = propagate_sharded(adj_emat, x, n_layers, es.group)
        u_r, p_r, n_r = es.take(rep, es.batch_ids(users, pos, neg, n_users), adj_emat.row_block, adj_emat.rank)
        v1 = view_users(views[0], x, users)
        if contrastive == "cross":
            v2 = view_users(views[1], x, users)
            closs = info_nce(v1, v2, es.negatives(v2))
        else:
            closs = info_nce(u_r, v1, es.negatives(v1))
        l2 = l2_sq_rows(u_r, p_r, n_r)
        loss = bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean() + contrastive_reg * closs.mean()
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep():
        return es.gather_rep(propagate_sharded(adj_emat, params["embedding"], n_layers, es.group), adj_emat.n_rows)

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_ngcf_step(emat, mesh, optimizer, params, batch_size, l2_reg, n_users, n_layers, dropout,
                                generator=None):
    """NGCF's step (JAX step.py:1263-1387) with the self-loop row-L1
    adjacency and the table sharded over 'model', the per-layer linears
    replicated (applied to each rank's rows through ``shared``). In training
    one edge-dropout seed serves every layer, and each layer's message mask
    is drawn whole ([n, width]) from the same device generator as the
    single-device model's, each rank keeping its rows.

    -> step(users, pos, neg) -> loss; ``step.eval_rep()``."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows, linear
    from inductive_recommendation_tpu_torch.models.ngcf import l2_normalize_rows
    from inductive_recommendation_tpu_torch.ops.dropout import device_generator, dropout_keep
    from inductive_recommendation_tpu_torch.train.losses import bpr_loss

    if emat.n_rows_pad != emat.n_cols_pad:
        raise ValueError("NGCF's layers need a square adjacency")
    es = _EdgeStep(mesh, optimizer, params, batch_size)
    p_drop = float(dropout)
    names = [n for n in params if n.startswith(("gc_layers.", "bi_layers."))]

    def forward(training):
        h = params["embedding"]
        lin = es.shared(names) if training else params
        layers = [h]
        drop = training and p_drop > 0.0
        if drop:
            seed = dropout_seed(generator)
            messages = device_generator(generator, h.device)
        for i in range(n_layers):
            m0 = edge_sharded_spmm(emat, h, es.group, "scatter", drop=(seed, p_drop) if drop else None)
            h = torch.nn.functional.leaky_relu(
                linear(lin, f"gc_layers.{i}", m0) + linear(lin, f"bi_layers.{i}", h * m0), negative_slope=0.2
            )
            if drop:
                keep = dropout_keep((emat.n_rows, h.shape[1]), p_drop, messages, h.device)
                keep = local_rows(keep, mesh, n_rows=emat.n_rows_pad)
                h = torch.where(keep, h / (1.0 - p_drop), 0.0)
            layers.append(l2_normalize_rows(h))
        return torch.cat(layers, dim=1)

    def step(users, pos, neg):
        reps = es.take(forward(True), es.batch_ids(users, pos, neg, n_users), emat.row_block, emat.rank)
        l2 = l2_sq_rows(*reps)
        loss = bpr_loss(*reps) + l2_reg * l2.mean()
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep():
        return es.gather_rep(forward(False), emat.n_rows)

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_imcgae_step(emat, mesh, optimizer, params, batch_size, l2_reg, n_users, n_layers, dropout,
                                  operand_width, generator=None):
    """IMCGAE's step (JAX step.py:1388-1505): the personal rows
    (``params["embedding"]``) sharded over 'model', the three shared rows
    (``params["special"]``: identical, general-user, general-item)
    replicated; the compact operand [P | u_mask | i_mask | 1] padded with
    zero columns to ``operand_width`` (68 at d 64) is propagated, its node
    dropout drawn whole ([n]) per layer as the single-device model draws it,
    each rank keeping its rows, and batch rows expand to 3d at the loss.

    -> step(users, pos, neg) -> loss; ``step.eval_rep()`` the [n, 3d] rep."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows
    from inductive_recommendation_tpu_torch.models.imcgae import IMCGAE
    from inductive_recommendation_tpu_torch.ops.dropout import node_dropout_mask
    from inductive_recommendation_tpu_torch.train.losses import bpr_loss

    es = _EdgeStep(mesh, optimizer, params, batch_size)
    n, p_drop = emat.n_rows, float(dropout)

    def operand():
        emb = params["embedding"]
        blk, d = emb.shape
        g = emat.rank * blk + torch.arange(blk, device=emb.device)
        is_user, real = (g < n_users).to(emb.dtype), (g < n).to(emb.dtype)
        coeff = torch.stack([is_user, real - is_user, real], dim=1)
        return torch.cat([emb, coeff, emb.new_zeros(blk, operand_width - d - 3)], dim=1)

    def compact(training):
        h = final = operand()
        for i in range(n_layers):
            rate = max(p_drop - 0.1 * i, 0.0)
            if training and rate > 0.0:
                mask = node_dropout_mask(generator, n, rate, True, h.device)
                h = h * local_rows(mask, mesh, n_rows=emat.n_rows_pad)[:, None]
            h = edge_sharded_spmm(emat, h, es.group, "scatter")
            final = final + h * (1.0 / (i + 2))
        return final[:, : params["embedding"].shape[1] + 3]

    def parts():
        sp = params["special"]
        return sp[1], sp[2], sp[0]

    def step(users, pos, neg):
        rows = es.take(compact(True), es.batch_ids(users, pos, neg, n_users), emat.row_block, emat.rank)
        reps = [IMCGAE.expand_rows(r, parts()) for r in rows]
        l2 = l2_sq_rows(*reps)
        loss = bpr_loss(*reps) + l2_reg * l2.mean()
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep():
        return IMCGAE.expand_rows(es.gather_rep(compact(False), n), parts())

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_idcf_step(model, feat_emat, adj_emat, frozen, mesh, optimizer, params, batch_size, l2_reg,
                                contrastive_reg, generator=None):
    """IDCF_LGCN's step (JAX step.py:1506-1672): the feature matrix
    (``feat_emat``, the 0/1 adjacency columns of the old nodes), the
    adjacency and the frozen LightGCN table (``frozen``, this rank's rows of
    the feature matrix's operand: no gradient, no Adam moments) sharded over
    'model'; the heads, fused and propagated, run on each rank's rows with
    the replicated weights (``shared``). The samples are drawn from the host
    generator by ``model.draw_samples`` as the single-device model draws
    them; the sampled and batch rows of the frozen table come from masked
    takes. ``IDCFTrainer``'s objective: BPR + L2 (the reps and every head's
    squared query and key weights) + ``contrastive_reg`` times the
    logsumexp term on the batch's pre-propagation rows (model.py:3946-3955).

    -> step(users, pos, neg) -> loss; ``step.eval_rep()``."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows, linear
    from inductive_recommendation_tpu_torch.models.idcf import relation_gat
    from inductive_recommendation_tpu_torch.train.losses import bpr_loss

    es = _EdgeStep(mesh, optimizer, params, batch_size)
    n_users, n_old_u = model.n_users, model.n_old_users
    rb = feat_emat.row_block
    n_user_rows = min(max(n_users - feat_emat.rank * rb, 0), rb)  # this rank's user rows come first

    def frozen_rows(ids):
        with torch.no_grad():
            return _masked_take(frozen, ids, feat_emat.block, feat_emat.rank, es.group)

    def representations(training):
        with torch.no_grad():
            x_q = edge_sharded_spmm(feat_emat, frozen, es.group, "scatter")
        samples = model.draw_samples(generator if training else None)
        w = es.shared(list(params)) if training else params
        heads, h = model.n_headers, model.n_samples
        sampled = frozen_rows(torch.cat([samples[:, 0], n_old_u + samples[:, 1]], dim=1).reshape(-1))
        sampled = sampled.view(heads, 2, h, -1)
        outs = []
        for i in range(heads):
            users_part = relation_gat(w, f"gat_units.{i}", x_q[:n_user_rows], sampled[i, 0])
            items_part = relation_gat(w, f"gat_units.{i}", x_q[n_user_rows:], sampled[i, 1])
            outs.append(torch.cat([users_part, items_part], dim=0))
        return linear(w, "w_out", torch.cat(outs, dim=1)), sampled[-1, 0], sampled[-1, 1]

    def propagate(reps):
        return propagate_sharded(adj_emat, reps, model.n_layers, es.group)

    def step(users, pos, neg):
        reps0, s_u, s_i = representations(True)
        ids = es.batch_ids(users, pos, neg, n_users)
        u_r, p_r, n_r = es.take(propagate(reps0), ids, rb, feat_emat.rank)
        l2 = l2_sq_rows(u_r, p_r, n_r)
        for i in range(model.n_headers):
            l2 = l2 + (params[f"gat_units.{i}.wq.w"] ** 2).sum() + (params[f"gat_units.{i}.wk.w"] ** 2).sum()
        ub, pb, nb = es.take(reps0, ids, rb, feat_emat.rank)
        sl = es.sl
        fu, fp, fn = frozen_rows((users[sl], n_old_u + pos[sl], n_old_u + neg[sl]))
        lse = torch.logsumexp
        closs = (
            lse(ub @ s_u.T, dim=1) - (ub * fu).sum(1)
            + lse(pb @ s_i.T, dim=1) - (pb * fp).sum(1)
            + lse(nb @ s_i.T, dim=1) - (nb * fn).sum(1)
        )
        loss = bpr_loss(u_r, p_r, n_r) + l2_reg * l2.mean() + contrastive_reg * closs.mean()
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep():
        return es.gather_rep(propagate(representations(False)[0]), feat_emat.n_rows)

    step.eval_rep = eval_rep
    return step


def make_edge_sharded_att_igcn_step(feat_emat, adj_emat, row_sum, mesh, optimizer, params, batch_size, l2_reg, aux_reg,
                                    n_users, user_dim, n_layers, n_heads, temperature):
    """AttIGCN's step (JAX step.py:1673-1878) with the feature matrix, the
    adjacency, the attention softmax and the core table sharded: the query
    q = Wq(feat @ sg(emb)) over the alpha-0 (row_sum^-1) values baked once,
    folded with Wk per head (qk, qb) on each rank's rows, the sharded
    attention (``parallel/attention.py``) aggregating the non-detached
    table through the kernel with the attention as edge values, then the
    adjacency layers. ``IGCNTrainer``'s objective with AttIGCN's L2: BPR +
    L2 (reps, ||Wq||^2 + ||Wk||^2) + the auxiliary BPR; no dropout.

    -> step(users, pos, neg, a_users, a_pos, a_neg) -> loss;
    ``step.eval_rep()``; ``step.attention()``: the shard's attention on
    its edges."""
    from inductive_recommendation_tpu_torch.models.base import l2_sq_rows, linear
    from inductive_recommendation_tpu_torch.parallel.attention import edge_sharded_attention, sharded_attention
    from inductive_recommendation_tpu_torch.train.losses import aux_bpr_rows, bpr_loss

    es = _EdgeStep(mesh, optimizer, params, batch_size)
    ind = _Inductive(es, feat_emat, adj_emat, row_sum, n_layers, 0.0, None)
    feat_q = ind.feat_at(0.0)  # alpha is pinned at 0: row_sum^-1, baked once
    att = values_shard(feat_emat)
    names = ("weight_q.w", "weight_q.b", "weight_k.w", "weight_k.b")

    def folded_query(training):
        emb = params["embedding"]
        w = es.shared(names) if training else params
        d = emb.shape[1]
        q = linear(w, "weight_q", edge_sharded_spmm(feat_q, emb.detach(), es.group, "scatter")).reshape(-1, n_heads, d)
        qk = torch.einsum("nhd,vhd->nhv", q, w["weight_k.w"].reshape(d, n_heads, d))
        qb = torch.einsum("nhd,hd->nh", q, w["weight_k.b"].reshape(n_heads, d))
        return qk, qb

    def rep_local(training):
        qk, qb = folded_query(training)
        return ind.propagate(edge_sharded_attention(att, qk, qb, params["embedding"], temperature, es.group))

    def step(users, pos, neg, a_users, a_pos, a_neg):
        x = params["embedding"]
        reps = ind.batch_reps(rep_local(True), es.batch_ids(users, pos, neg, n_users))
        l2 = l2_sq_rows(*reps) + (params["weight_q.w"] ** 2).sum() + (params["weight_k.w"] ** 2).sum()
        aux = aux_bpr_rows(*ind.aux_rows(x, a_users, a_pos, a_neg, user_dim), params["w"])
        loss = bpr_loss(*reps) + l2_reg * l2.mean() + aux_reg * aux
        return es.update(loss * es.b)

    @torch.no_grad()
    def eval_rep():
        return es.gather_rep(rep_local(False), feat_emat.n_rows)

    @torch.no_grad()
    def attention():
        qk, qb = (all_gather(t.contiguous(), es.group) for t in folded_query(False))
        return sharded_attention(att, qk, qb, params["embedding"], temperature, es.group)

    step.eval_rep = eval_rep
    step.attention = attention
    return step
