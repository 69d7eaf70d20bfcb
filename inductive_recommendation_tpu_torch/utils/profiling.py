"""Tracing and timing (counterpart of
``inductive_recommendation_tpu/utils/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activity; on exit the Chrome trace is written to
  ``logdir/trace.json`` (open it in Perfetto or ``chrome://tracing``);
- ``StepTimer``: host-clock step times that end only once the device has
  finished (``torch.cuda.synchronize`` of the given tensor's device);
- ``nan_check``: the names of the non-finite floating leaves of a
  ``{name: tensor}`` dict or a nested tree of dicts and lists.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


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


class StepTimer:
    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        """Ends a step; with ``sync_value`` (a tensor), once its device has
        finished the work queued so far."""
        if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self):
        return 1e3 * float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50_ms(self):
        return 1e3 * float(np.median(self.times)) if self.times else float("nan")


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
