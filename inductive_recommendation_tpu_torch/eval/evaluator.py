"""Full-catalog retrieval evaluation and the inductive six-slice protocol
(counterpart of ``inductive_recommendation_tpu/eval/evaluator.py``; reference
trainer.py:146-253).

- the model's full representation is computed once per evaluation and reused
  for every user batch (the reference re-propagated the graph per batch);
- each user batch is scored (``users_r @ items_r.T``, a dense ``torch.matmul``),
  masked (-inf at the train/val items, via padded index rows), top-k'd and
  reduced to metric partial sums on the device; only the sums reach the host;
- users are taken in exclusion-width buckets (a geometric ladder over the
  exclusion list lengths), so the -inf scatter is O(E), not
  O(n_users * max_degree). Metric sums are order-invariant, so the bucket
  order needs no undoing;
- under a mesh (``parallel/mesh.py``) every rank holds the scoring state and
  takes its slice of each user batch; the metric partial sums are
  all-reduced once an evaluation, and ``recommend`` scores item-sharded with
  a per-rank top-k and a k-way merge (``parallel/eval.py``);
- its spans (``utils.profiling.span``): ``irt.eval.evaluator_build`` (the
  padded exclusion lists), ``irt.eval.pass`` (one ``evaluate``) holding
  ``irt.eval.refresh`` (the scoring state) and each batch's
  ``irt.eval.score``, ``irt.eval.topk`` (mask and top-k) and
  ``irt.eval.metric_sums``; ``irt.eval.buckets`` and
  ``irt.eval.ground_truth`` only where they are built, not where a cache
  answers, so their count is the caches' misses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch.data.dataset import device_padded_from_lists
from inductive_recommendation_tpu_torch.eval.device_metrics import (
    batch_metric_sums,
    combine_metric_sums,
)
from inductive_recommendation_tpu_torch.ops.topk import masked_topk
from inductive_recommendation_tpu_torch.parallel.collectives import all_reduce
from inductive_recommendation_tpu_torch.parallel.eval import sharded_recommend_all_users
from inductive_recommendation_tpu_torch.utils.device import resolve_device
from inductive_recommendation_tpu_torch.utils.profiling import span


def _format_results(metrics, topks):
    """Exact format of reference trainer.py:175-182."""
    precision = "".join("{:.3f}, ".format(metrics["Precision"][k] * 100.0) for k in topks)
    recall = "".join("{:.3f}, ".format(metrics["Recall"][k] * 100.0) for k in topks)
    ndcg = "".join("{:.3f}, ".format(metrics["NDCG"][k] * 100.0) for k in topks)
    return "Precision: {:s}Recall: {:s}NDCG: {:s}".format(precision, recall, ndcg)


class Evaluator:
    @span("irt.eval.evaluator_build")
    def __init__(self, dataset, topks, test_batch_size=512, device=None, mesh=None):
        """Runs on the CUDA card unless ``device`` says otherwise; raises when
        no device is given and there is no card. ``mesh``: a ('data',
        'model') ``DeviceMesh`` over every rank; each user batch then splits
        over all of them (JAX evaluator.py:44-62)."""
        self.dataset = dataset
        self.topks = list(topks)
        # small catalogs: cannot retrieve more items than exist
        self.k_max = min(max(self.topks), dataset.n_items)
        self.test_batch_size = int(test_batch_size)
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and self.test_batch_size % mesh.size():
            raise ValueError(
                f"test_batch_size {self.test_batch_size} must divide over the mesh ({mesh.size()} ranks)"
            )
        n_items = dataset.n_items
        trainval = [list(t) + list(v) for t, v in zip(dataset.train_data, dataset.val_data)]
        self._train_excl = device_padded_from_lists(dataset.train_data, n_items, device=self.device)
        self._trainval_excl = device_padded_from_lists(trainval, n_items, device=self.device)
        # ground-truth rows of the dataset's own val/test/train lists, made
        # once (inductive slices pass fresh lists and skip the cache)
        self._gt_cache = {}
        self._bucket_cache = {}

    def _banned(self, banned_items):
        if banned_items is None:
            return None
        b = torch.zeros(self.dataset.n_items, dtype=torch.bool, device=self.device)
        b[torch.as_tensor(np.asarray(banned_items, dtype=np.int64), device=self.device)] = True
        return b

    @torch.no_grad()
    def recommend(self, model, params, stage, banned_items=None):
        """Top-k_max recommended items for every user -> [n_users, k_max] numpy."""
        ds = self.dataset
        n_users = ds.n_users
        banned = self._banned(banned_items)
        state = model.make_scoring_state(params)
        B = self.test_batch_size

        if self.mesh is not None and isinstance(state, torch.Tensor) and state.ndim == 2:
            excl = {"test": self._trainval_excl, "val": self._train_excl}.get(stage)
            return sharded_recommend_all_users(
                self.mesh, state, n_users, ds.n_items, self.k_max, exclude_rows=excl,
                banned_items=banned_items, batch_size=B,
            )
        if stage not in ("val", "test") and banned is None:
            rec = []
            for start in range(0, n_users, B):
                users = torch.arange(start, min(start + B, n_users), device=self.device)
                rec.append(torch.topk(model.score(state, users), self.k_max, dim=-1)[1])
            return torch.cat(rec).to(torch.int32).cpu().numpy()

        # the exclusion (and/or ban) path runs over the same width buckets as
        # evaluate; the bucket permutation is undone on the host
        bucket_stage = stage if stage in ("val", "test") else "train"
        out = np.empty((n_users, self.k_max), dtype=np.int32)
        for perm, n_real, excl_rows in self._excl_buckets(bucket_stage):
            items = []
            for i in range(0, perm.shape[0], B):
                scores = model.score(state, perm[i : i + B])
                items.append(
                    masked_topk(scores, self.k_max, exclude_idx=excl_rows[i : i + B], banned_mask=banned)[1]
                )
            items = torch.cat(items).to(torch.int32).cpu().numpy()
            out[perm[:n_real].cpu().numpy()] = items[:n_real]
        return out

    def evaluate(self, model, params, stage, banned_items=None, eval_data=None):
        """-> (results_str, metrics dict), as reference trainer.py:146-210."""
        if eval_data is None:
            eval_data = getattr(self.dataset, stage + "_data")
        metrics = self._evaluate_on_device(model, params, stage, banned_items, eval_data)
        return _format_results(metrics, self.topks), metrics

    def _gt_device(self, eval_data):
        """(gt_rows, gt_len, sorted_gt) on the device. The pad width is the
        next power of two of the longest list; rows wider than 256 are sorted
        for the binary-search membership test."""
        cache_key = None
        for stage in ("val", "test", "train"):
            if eval_data is getattr(self.dataset, stage + "_data", None):
                cache_key = stage
                break
        if cache_key is not None and cache_key in self._gt_cache:
            return self._gt_cache[cache_key]
        with span("irt.eval.ground_truth"):
            out = self._gt_build(eval_data)
        if cache_key is not None:
            self._gt_cache[cache_key] = out
        return out

    def _gt_build(self, eval_data):
        lengths = np.fromiter((len(l) for l in eval_data), dtype=np.int64, count=len(eval_data))
        m = max(1, int(lengths.max(initial=0)))
        pad_to = 1 << (m - 1).bit_length()
        gt_rows = device_padded_from_lists(eval_data, self.dataset.n_items, pad_to=pad_to, device=self.device)
        sorted_gt = pad_to > 256
        if sorted_gt:
            gt_rows = torch.sort(gt_rows, dim=1).values
        return gt_rows, torch.as_tensor(lengths, dtype=torch.int32, device=self.device), sorted_gt

    @span("irt.eval.pass")
    @torch.no_grad()
    def _evaluate_on_device(self, model, params, stage, banned_items, eval_data):
        banned = self._banned(banned_items)
        with span("irt.eval.refresh"):
            state = model.make_scoring_state(params)
        gt_rows, gt_len, sorted_gt = self._gt_device(eval_data)
        topks = tuple(self.topks)
        B = self.test_batch_size
        # this rank's slice of each batch: all of it without a mesh
        b, lo = B, 0
        if self.mesh is not None:
            b = B // self.mesh.size()
            lo = dist.get_rank() * b
        sums, valids = [], []
        for perm, n_real, excl_rows in self._excl_buckets(stage):
            slots = torch.arange(perm.shape[0], device=self.device)
            acc = torch.zeros(len(topks), 3, dtype=torch.float32, device=self.device)
            n_valid = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(lo, perm.shape[0], B):
                users = perm[i : i + b]
                with span("irt.eval.score"):
                    scores = model.score(state, users)
                with span("irt.eval.topk"):
                    rec = masked_topk(scores, self.k_max, exclude_idx=excl_rows[i : i + b], banned_mask=banned)[1]
                with span("irt.eval.metric_sums"):
                    s, v = batch_metric_sums(
                        rec, gt_rows[users], gt_len[users], slots[i : i + b] < n_real, topks, sorted_gt=sorted_gt
                    )
                    acc += s
                    n_valid += v
            sums.append(acc)
            valids.append(n_valid)
        sums, valids = torch.stack(sums), torch.stack(valids)
        if self.mesh is not None:
            both = all_reduce(torch.cat([sums.flatten(), valids]), None)
            sums, valids = both[: sums.numel()].view_as(sums), both[sums.numel() :]
        return combine_metric_sums(list(sums.cpu().numpy()), valids.tolist(), self.topks)

    def _excl_buckets(self, stage):
        """Users grouped by exclusion width: a list of (perm [N_b padded to a
        multiple of the batch], n_real, excl_rows [N_b, w_b]) on the device,
        with geometric cuts 64, 256, 1024, ... over the list lengths."""
        if stage in self._bucket_cache:
            return self._bucket_cache[stage]
        with span("irt.eval.buckets"):
            buckets = self._bucket_build(stage)
        self._bucket_cache[stage] = buckets
        return buckets

    def _bucket_build(self, stage):
        ds = self.dataset
        n_users, n_items = ds.n_users, ds.n_items
        B = self.test_batch_size
        if stage == "test":
            excl_full = self._trainval_excl
            lengths = np.fromiter(
                (len(t) + len(v) for t, v in zip(ds.train_data, ds.val_data)), dtype=np.int64, count=n_users
            )
        elif stage == "val":
            excl_full = self._train_excl
            lengths = np.fromiter((len(t) for t in ds.train_data), dtype=np.int64, count=n_users)
        else:  # 'train': no exclusion (reference trainer.py:155-160 masks only val/test)
            perm = np.arange(n_users, dtype=np.int64)
            perm = np.concatenate([perm, np.zeros((-n_users) % B, dtype=np.int64)])
            return [
                (
                    torch.as_tensor(perm, device=self.device),
                    n_users,
                    torch.full((len(perm), 1), n_items, dtype=torch.int32, device=self.device),
                )
            ]

        buckets = []
        order = np.argsort(lengths, kind="stable").astype(np.int64)
        sorted_len = lengths[order]
        start, cut = 0, 64
        while start < n_users:
            hi = int(np.searchsorted(sorted_len, cut, side="right"))
            cut *= 4
            if hi <= start:
                continue
            members = order[start:hi]
            start = hi
            w = max(8, -(-int(lengths[members].max(initial=1)) // 8) * 8)
            w = min(w, excl_full.shape[1])
            perm = np.concatenate([members, np.zeros((-len(members)) % B, dtype=np.int64)])
            perm_dev = torch.as_tensor(perm, device=self.device)
            buckets.append((perm_dev, len(members), excl_full[perm_dev][:, :w].contiguous()))
        return buckets

    def inductive_eval(self, model, params, n_old_users, n_old_items, verbose=True):
        """The six-slice cold-start protocol (reference trainer.py:212-253)."""
        ds = self.dataset
        test = ds.test_data
        ban_new, ban_old = np.arange(n_old_items, ds.n_items), np.arange(n_old_items)
        with span("irt.eval.ground_truth"):
            slices = [
                ("All users and all items", [list(t) for t in test], None),
                ("Old users and all items", [list(t) if u < n_old_users else [] for u, t in enumerate(test)], None),
                ("New users and all items", [[] if u < n_old_users else list(t) for u, t in enumerate(test)], None),
                ("All users and old items", [[i for i in t if i < n_old_items] for t in test], ban_new),
                ("All users and new items", [[i for i in t if i >= n_old_items] for t in test], ban_old),
                ("Old users and old items",
                 [[i for i in t if i < n_old_items] if u < n_old_users else [] for u, t in enumerate(test)], ban_new),
            ]
        out = {}
        for tag, eval_data, banned in slices:
            results, out[tag] = self.evaluate(model, params, "test", banned_items=banned, eval_data=eval_data)
            if verbose:
                print("{:s} result. {:s}".format(tag, results))
        return out
