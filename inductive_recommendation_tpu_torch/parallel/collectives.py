"""The collectives of the multi-GPU layer, counted by kind.

Thin wrappers over ``torch.distributed``: NCCL on the card, gloo for CPU
tensors (the process group's backend decides). Each call adds one to
``counts.launches`` and to ``counts.by_kind[kind]``, beside the SpMM kernel's
``spmm_csr_cuda.launches``; :func:`reset_collective_counts` sets them to 0.
``all_gather_single`` / ``reduce_scatter_single`` are taken where this torch
has them, else their older names (same arguments), which newer versions
deprecate.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "reduce_scatter", "all_gather")

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
