"""Faults planted in the program, to show that the check catches them
(``calibrate.py`` on the card, ``tests/test_port_bench_check.py`` on the
CPU). Each is a context manager that patches the port while a run is set
up and measured:

- ``half_batch``: the mean taken over the first half of each batch only
  (the BPR loss of a training step; the metric sums of an evaluation
  batch);
- ``answer_altered``: one ranked id of every evaluation row replaced where
  the top-k produces it;
- ``state_unchanged``: the optimizer's step returns the parameters
  unchanged (training).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def half_batch(kind: str):
    if kind == "train":
        from inductive_recommendation_tpu_torch.train import trainer as module

        bpr = module.bpr_loss

        def half(u, p, n):
            h = u.shape[0] // 2
            return bpr(u[:h], p[:h], n[:h])

        with _patched(module, "bpr_loss", half):
            yield
    else:
        from inductive_recommendation_tpu_torch.eval import evaluator as module

        sums = module.batch_metric_sums

        def half(rec, gt_rows, gt_len, valid, topks, sorted_gt=False):
            valid = valid.clone()
            valid[valid.shape[0] // 2 :] = False
            return sums(rec, gt_rows, gt_len, valid, topks, sorted_gt=sorted_gt)

        with _patched(module, "batch_metric_sums", half):
            yield


@contextlib.contextmanager
def answer_altered(kind: str):
    from inductive_recommendation_tpu_torch.eval import evaluator as module

    topk = module.masked_topk

    def altered(scores, k, exclude_idx=None, banned_mask=None):
        vals, ids = topk(scores, k, exclude_idx=exclude_idx, banned_mask=banned_mask)
        ids = ids.clone()
        ids[:, -1] = ids[:, 0]
        return vals, ids

    with _patched(module, "masked_topk", altered):
        yield


@contextlib.contextmanager
def state_unchanged(kind: str):
    def step(self, closure=None):
        return None

    with _patched(torch.optim.Adam, "step", step):
        yield


FAULTS = {"half_batch": half_batch, "answer_altered": answer_altered, "state_unchanged": state_unchanged}

# the faults each traffic kind can have
KIND_FAULTS = {
    "train": ("state_unchanged", "half_batch"),
    "eval": ("half_batch", "answer_altered"),
    "inductive": ("half_batch", "answer_altered"),
}
