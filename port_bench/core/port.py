"""The one place where the benchmark meets the program (the PyTorch and CUDA
port): building its dataset object, model, trainer and evaluator, putting
the benchmark's weights into them, and the wrappers that time the calls into
its layers and keep what the check needs. Nothing here computes a result
of the program's; the reference never imports this module."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from inductive_recommendation_tpu_torch.data.dataset import BasicDataset
from inductive_recommendation_tpu_torch.eval import evaluator as evaluator_module
from inductive_recommendation_tpu_torch.eval.evaluator import Evaluator
from inductive_recommendation_tpu_torch.models import get_model
from inductive_recommendation_tpu_torch.ops.csr_spmm import ROUTES, spmm_csr_cuda
from inductive_recommendation_tpu_torch.train import get_trainer
from port_bench.core.data import SPLIT


class WindowClosed(Exception):
    """Raised at a unit boundary once the measured window's time is up."""


def dataset(data, name="PortBench"):
    """The program's dataset object for ``core.data.Interactions``."""
    ds = BasicDataset({"name": name, "split_ratio": list(SPLIT), "neg_ratio": 1})
    ds.n_users, ds.n_items = data.n_users, data.n_items
    ds.train_data, ds.val_data, ds.test_data = data.lists("train"), data.lists("val"), data.lists("test")
    ds.train_array = data.train_array
    return ds


def build_model(config, ds, device):
    return get_model(dict(config["model"]), ds, device=device)


def build_trainer(config, ds, model, trainer_seed):
    return get_trainer(dict(config["trainer"], seed=int(trainer_seed)), ds, model)


def build_evaluator(config, ds, device, topks):
    return Evaluator(ds, topks, config["trainer"].get("test_batch_size", 512), device=device)


@torch.no_grad()
def load_weights(params, weights):
    """Copy the benchmark's weights into the program's parameters."""
    for name, p in params.items():
        p.copy_(weights[name].to(p.dtype))


def route_launches() -> dict:
    return dict(spmm_csr_cuda.route_launches)


def launches_since(before: dict) -> dict:
    now = route_launches()
    return {r: now[r] - before.get(r, 0) for r in ROUTES if now[r] != before.get(r, 0)}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """Wrappers around the program's calls, installed on its objects (an
    instance attribute shadows the method; the evaluator's module-level
    metric sums are rebound in that module). What they record:

    - ``steps``: CUDA events at every step boundary (or host times on the
      CPU), the host time each ``step`` took to return; the deadline check;
    - ``epoch_end_ms``: (call, host ms) of each of the model's epoch-end
      calls (its module's ``EPOCH_END``), synchronised in trace mode, and
      ``calls``, how often each was made;
    - ``passes``: for each ``evaluate`` pass, the users scored, the ids
      ranked and the valid-row masks, batch by batch (the last few passes);
    - ``get_rep``: CUDA-event times of the representation refresh, and the
      last representation made;
    - ``attach``: host ms of each ``attach_dataset``, synchronised in trace
      mode.
    """

    def __init__(self, device, trace: bool):
        self.device = torch.device(device)
        self.trace = trace
        self.cuda = self.device.type == "cuda"
        self.deadline = None
        self.pass_deadline = True  # False: only attach_dataset checks it
        self.step_marks = []  # events (or host times) at step boundaries
        self.step_host_ms = []
        self.steps_done = 0
        self.epoch_end_ms = []
        self.calls = {}
        self.passes = []  # [{"users": [...], "rec": [...], "valid": [...]}]
        self.keep_passes = 1
        self.get_rep_events = []
        self.get_rep_host_ms = []
        self.last_rep = None
        self.attach_ms = []
        self.pass_count = 0
        self._restore = []

    # -- the window -----------------------------------------------------------
    def open_window(self, seconds: float):
        self.deadline = time.perf_counter() + seconds

    def close_window(self):
        self.deadline = None

    def _check_deadline(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowClosed

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.step_marks.append(ev)
        else:
            self.step_marks.append(time.perf_counter())

    def step_intervals_ms(self) -> list:
        """Intervals between consecutive step boundaries (after a sync)."""
        m = self.step_marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]

    # -- trainer --------------------------------------------------------------
    def wrap_trainer(self, trainer, epoch_end=()):
        orig_step = trainer.step

        def step(*batch):
            self._check_deadline()
            if not self.step_marks:
                self._mark()
            t0 = time.perf_counter()
            with self.annotate("step"):
                out = orig_step(*batch)
            self.step_host_ms.append((time.perf_counter() - t0) * 1e3)
            self._mark()
            self.steps_done += 1
            return out

        trainer.step = step
        self.wrap_epoch_end(trainer.model, epoch_end)

    def annotate(self, name):
        """A profiler range named after the benchmark's wrapper, in trace
        mode: it names the device's idle gaps in the breakdown."""
        return torch.profiler.record_function("port_bench." + name) if self.trace else contextlib.nullcontext()

    def wrap_epoch_end(self, model, names):
        """Times and counts each of the model's epoch-end calls ``names``."""
        for name in names:
            fn = getattr(model, name)
            self.calls[name] = 0

            def timed(*args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += 1
                if self.trace:
                    _sync(self.device)
                t0 = time.perf_counter()
                with self.annotate(_name):
                    out = _fn(*args, **kwargs)
                if self.trace:
                    _sync(self.device)
                self.epoch_end_ms.append((_name, (time.perf_counter() - t0) * 1e3))
                return out

            setattr(model, name, timed)

    # -- evaluation -----------------------------------------------------------
    def wrap_model_for_eval(self, model):
        score, get_rep = model.score, model.get_rep

        def wrapped_score(state, users):
            self.passes[-1]["users"].append(users)
            return score(state, users)

        def wrapped_get_rep(params, training=False, generator=None):
            if not training:
                self._start_pass()
            if self.cuda and self.trace and not training:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = get_rep(params, training=training, generator=generator)
                end.record()
                self.get_rep_events.append((start, end))
            else:
                t0 = time.perf_counter()
                out = get_rep(params, training=training, generator=generator)
                if self.trace and not training:
                    self.get_rep_host_ms.append((time.perf_counter() - t0) * 1e3)
            if not training:
                self.last_rep = out
            return out

        model.score, model.get_rep = wrapped_score, wrapped_get_rep
        sums = evaluator_module.batch_metric_sums

        def batch_metric_sums(rec, gt_rows, gt_len, valid, topks, sorted_gt=False):
            self.passes[-1]["rec"].append(rec)
            self.passes[-1]["valid"].append(valid)
            return sums(rec, gt_rows, gt_len, valid, topks, sorted_gt=sorted_gt)

        evaluator_module.batch_metric_sums = batch_metric_sums
        self._restore.append(lambda: setattr(evaluator_module, "batch_metric_sums", sums))

    def _start_pass(self):
        if self.pass_deadline:
            self._check_deadline()
        self.pass_count += 1
        self.passes.append({"users": [], "rec": [], "valid": []})
        del self.passes[: -self.keep_passes]

    def wrap_attach(self, model):
        attach = model.attach_dataset

        def attach_dataset(ds):
            self._check_deadline()
            if self.trace:
                _sync(self.device)
            t0 = time.perf_counter()
            with self.annotate("attach_dataset"):
                out = attach(ds)
            if self.trace:
                _sync(self.device)
            self.attach_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        model.attach_dataset = attach_dataset

    def get_rep_ms(self) -> list:
        if self.get_rep_events:
            return [a.elapsed_time(b) for a, b in self.get_rep_events]
        return list(self.get_rep_host_ms)

    def finished_passes(self) -> list:
        """The kept passes with numpy arrays: users [n], rec [n, K], valid [n]."""
        out = []
        for p in self.passes:
            if not p["rec"] or len(p["rec"]) != len(p["users"]):
                continue
            out.append({
                "users": torch.cat(p["users"]).cpu().numpy().astype(np.int64),
                "rec": torch.cat(p["rec"]).cpu().numpy().astype(np.int64),
                "valid": torch.cat(p["valid"]).cpu().numpy().astype(bool),
            })
        return out

    def remove(self):
        for undo in self._restore:
            undo()
        self._restore = []
