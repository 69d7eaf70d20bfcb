"""Tracing (counterpart of ``inductive_recommendation_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activity; on exit the Chrome trace is written to
  ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``);
- ``span(name)``: a named range of the program's own layers, as a context
  manager (``with span("irt.train.step"):``) or a decorator
  (``@span("irt.model.get_rep")``). While a profiler records, it is a
  ``torch.profiler.record_function`` range, on the same clock as the
  kernels it launches, so each idle gap of the device falls under the span
  the host was in. While none records, it costs one check and enters a
  shared null context: no profiler op, no allocation, no device call;
- ``nan_check``: the names of the non-finite floating leaves of a
  ``{name: tensor}`` dict or a nested tree of dicts and lists.

Span names are the layer path, prefixed ``irt.``: ``irt.train.*`` (the
step's sample, forward, backward and optimizer, the epoch end),
``irt.epoch_end.*`` (anneal, selection, view build), ``irt.graph.*``
(``attach_dataset``'s layouts), ``irt.model.get_rep``, ``irt.ops.spmm``
(each sparse product), ``irt.attention.*`` (AttIGCN's query, fold, scores,
softmax and aggregation, and the backward of the last three) and
``irt.eval.*`` (the evaluator's build, each pass,
its refresh, buckets and ground truth, and each batch's score, top-k and
metric sums).
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class NullSpan:
    """What ``span(name)`` returns while no profiler records: a context
    manager that does nothing, made once a name and shared. As a decorator
    it gives a function that checks at every call whether a profiler
    records."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned


class _Recording(torch.profiler.record_function):
    """A ``record_function`` range that decorates as ``NullSpan`` does, so a
    function decorated while a profiler records is not bound to it."""

    def __call__(self, fn):
        return NullSpan(self.name)(fn)


_NULL_SPANS: dict[str, NullSpan] = {}


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else the name's shared ``NullSpan``."""
    if _profiler_enabled():
        return _Recording(name)
    null = _NULL_SPANS.get(name)
    if null is None:
        null = _NULL_SPANS[name] = NullSpan(name)
    return null


def nan_check(tree, name="tree"):
    """Paths (``name.key.0...``) of the floating leaves with a NaN or an
    infinity; empty when all are finite."""
    if isinstance(tree, dict):
        return [bad for k, v in tree.items() for bad in nan_check(v, f"{name}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [bad for k, v in enumerate(tree) for bad in nan_check(v, f"{name}.{k}")]
    t = torch.as_tensor(tree) if not isinstance(tree, torch.Tensor) else tree
    if t.is_floating_point() and not bool(torch.isfinite(t.detach()).all()):
        return [name]
    return []
