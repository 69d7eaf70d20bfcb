"""Sharded training steps (counterpart of
``inductive_recommendation_tpu/parallel/step.py``), around a trainer's own
objective: ``local_loss(params, sl, *global_batch)``, this rank's term of
the global loss from the rows ``sl`` of the batch (``mean_loss_on_slice``
of the trainer's ``batch_loss``).

Every step takes the GLOBAL batch as its arguments: every rank draws the same
batch from the same generator state (the trainer samples it with the
device sampler) and keeps its slice, so the loss is the single-device
trainer's on the same seed. Steps update ``params`` in place through
``optimizer`` and return the global batch loss, the same on every rank.

Data mode (:func:`make_data_step`): the model runs whole on every rank, on
its 1/(D*S) slice of the batch. Its tables are row-sharded over 'model'
(``parallel/mesh.py``), all-gathered before the forward; a table's gradient
is reduce-scattered back over 'model' (the ranks of a 'model' group hold
different slices of the batch), the rest all-reduced over every rank, and
the tables' Adam moments stay sharded. Each rank's loss is its slice's term
of the global loss, so the reductions are plain sums. In-batch InfoNCE
takes the whole batch's view rows as its negatives: a slice gathers them
(:func:`gather_negatives`).

Edge mode (:func:`make_edge_step`): the model's forward runs under the edge
placement (``parallel/placement.py``) on a (D, S) mesh: the graph, the
table and its Adam moments sharded over 'model', the batch split D ways
over 'data', every product and its collectives inside the S ranks of a
'model' group, which compute one loss alike. Each group's loss is its
slice's term of the global loss; one gradient all-reduce over 'data' joins
the groups (JAX step.py:355-357), and InfoNCE's negatives are gathered over
'data' (the placement's ``negatives``). At D = 1 a step's loss is the
single-device trainer's times 1.0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch.parallel.collectives import all_gather, all_reduce, gather_rows_grad, reduce_scatter
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, param_spec


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


def make_edge_step(optimizer, params, batch_size, mesh, local_loss):
    """The edge-mode step around ``local_loss(params, sl, *global_batch)``,
    run under the edge placement: this rank's slice over 'data', the update
    with its one gradient all-reduce over 'data' (the tables and their Adam
    moments stay sharded over 'model'). ``optimizer`` may be a callable that
    returns the current optimizer."""
    n_data = axis_size(mesh, "data")
    data_g = mesh.get_group("data") if n_data > 1 else None
    sl = _slice(batch_size, n_data, mesh.get_local_rank("data"), "ranks of the 'data' axis")

    def step(*batch):
        opt = optimizer() if callable(optimizer) else optimizer
        loss = local_loss(params, sl, *batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if data_g is not None:
            for p in params.values():
                if p.grad is not None:
                    all_reduce(p.grad, data_g)
        opt.step()
        loss = loss.detach()
        return loss if data_g is None else all_reduce(loss, data_g)

    return step
