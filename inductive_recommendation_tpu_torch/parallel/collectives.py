"""The collectives of the multi-GPU layer, counted by kind.

Thin wrappers over ``torch.distributed``: NCCL on the card, gloo for CPU
tensors (the process group's backend decides). Each call adds one to
``counts.launches`` and to ``counts.by_kind[kind]``, beside the SpMM kernel's
``spmm_csr_cuda.launches``; :func:`reset_collective_counts` sets them to 0.
An all-reduce with ``op=MAX`` (the sharded attention's row maxima) counts
under ``all_reduce_max``.

The differentiable wrappers follow torch's convention: a rank's backward
yields the gradient of the one global loss with respect to that rank's own
tensors. Which collective the backward runs depends on how the ranks use
the forward's output:

- replicated (every rank computes the same loss from it): the cotangent is
  already the whole gradient (:func:`replicated_sum`);
- partial (each rank adds its own term of the loss from it): the gradient of
  an input sums every rank's cotangent (:func:`partial_sum`,
  :func:`gather_rows_grad`, :func:`scatter_rows`, :func:`shared`).
``all_gather_single`` / ``reduce_scatter_single`` are taken where this torch
has them, else their older names (same arguments), which newer versions
deprecate.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_reduce_max", "reduce_scatter", "all_gather")

counts = types.SimpleNamespace(launches=0, by_kind=dict.fromkeys(KINDS, 0))


def reset_collective_counts():
    """Set ``counts.launches`` and every kind's count to 0."""
    counts.launches = 0
    counts.by_kind = dict.fromkeys(KINDS, 0)


def _count(kind):
    counts.launches += 1
    counts.by_kind[kind] += 1


def _all_gather_single():
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_single():
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, in place; returns ``t``."""
    dist.all_reduce(t, group=group)
    _count("all_reduce")
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Element-wise maximum of ``t`` over ``group``, in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    _count("all_reduce_max")
    return t


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Rows of the sum of ``t`` over ``group``: rank r of the group gets block
    r of ``t.shape[0] // size`` rows."""
    size = dist.get_world_size(group)
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} rows do not split over a group of {size}")
    out = t.new_empty((t.shape[0] // size, *t.shape[1:]))
    _reduce_scatter_single()(out, t.contiguous(), group=group)
    _count("reduce_scatter")
    return out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` stacked along rows in rank order."""
    size = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] * size, *t.shape[1:]))
    _all_gather_single()(out, t.contiguous(), group=group)
    _count("all_gather")
    return out


class _ReplicatedSum(torch.autograd.Function):
    """Forward: the sum over ``group`` (all-reduce), the same on every rank.
    Backward: the cotangent as it is.

    Torch autograd hands every rank the whole cotangent of its own loss, and
    a replicated output feeds a loss that every rank of the group computes
    alike: the gradient of that one loss with respect to this rank's term of
    the sum is the cotangent itself. (JAX's ``shard_map`` instead hands each
    device 1/S of a replicated cotangent, so its rule all-reduces it: copied
    here, that would count the loss S times.)"""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce for a loss replicated over ``group``."""
    return _ReplicatedSum.apply(t, group)


class _PartialSum(torch.autograd.Function):
    """Forward: the sum over ``group``. Backward: the sum of every rank's
    cotangent: each rank uses the sum for its own term of the loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def partial_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce whose result feeds each rank's own term of
    the loss (the attention's row sums)."""
    return _PartialSum.apply(t, group)


class _Shared(torch.autograd.Function):
    """Forward: the tensors as they are (the same on every rank). Backward:
    the sum of every rank's cotangents, all of them in one all-reduce."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group, ctx.shapes = group, [t.shape for t in ts]
        return tuple(t.clone() for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        flat = all_reduce(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        return (None, *(part.view(shape) for part, shape in zip(flat.split([g.numel() for g in gs]), ctx.shapes)))


def shared(tensors, group) -> list:
    """Replicated parameters entering row-local work (a linear layer on a
    rank's rows): their gradients there sum the group's parts, in one
    all-reduce."""
    return list(_Shared.apply(group, *tensors))


class _GatherRows(torch.autograd.Function):
    """Forward: the group's rows stacked in rank order. Backward: the
    reduce-scatter of the cotangent: each rank reads the rows for its own
    term of the loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


def gather_rows_grad(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of row blocks (the attention's folded
    queries, a data-mode batch's rows for in-batch negatives)."""
    return _GatherRows.apply(t, group)


class _ScatterRows(torch.autograd.Function):
    """Forward: this rank's row block of the group's sum. Backward: the
    all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return reduce_scatter(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group), None


def scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable reduce-scatter of each rank's partial rows."""
    return _ScatterRows.apply(t, group)
