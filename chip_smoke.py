#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``inductive_recommendation_tpu_torch``) on one
CUDA card: the IGCN serving and training paths, DOSE training, every grid
model at full width through the port's CUDA kernel, and the front door (a
raw dataset preprocessed and a grid row run by the command line).

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases, each of which raises on failure (the exit code is then not 0):

1. card: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi gives them;
2. build: compiles every CUDA source of the port (``ops/csrc/*.cu``);
3. kernel: the SpMM kernel against its plain PyTorch version on the card (the
   plain version evaluated in float64, so that the error measured is the
   kernel's own fp32 rounding, each entry within the worst-case rounding
   error of the kernel's order of sums, ``check_product``), on
   small edge cases (empty and trailing empty rows, a row over many edge
   chunks, rows cut exactly at chunk boundaries, the 16-byte path and the
   general one) and on the Gowalla-scale adjacency and IGCN feature matrix,
   with its time, the plain version's, ``torch.sparse.mm``'s (each as the
   median of single calls, and as the median of windows of 10 back-to-back
   calls), the byte bound, the device time of each of its two launches and
   the time of the matrix's heaviest row alone; two products on each matrix
   must be bitwise equal;
4. slice: IGCN (d=64, 3 layers, feature_ratio 1) over a Gowalla-scale synthetic
   set (29,858 users x 40,981 items, seed 0): ``evaluate``, ``recommend``, one
   ``feat_mat_anneal`` and ``evaluate`` again, checked against the plain SpMM
   and against the host metric oracle;
5. inductive: ``attach_dataset`` onto the set grown by 1,000 new users and
   1,000 new items, then ``inductive_eval`` over its six slices;
6. times: ``get_rep`` and ``evaluate``, and one ``evaluate`` under
   ``torch.profiler`` (device time by kernel, device busy share);
7. train: IGCN's training path on a fresh model. (a) On the Gowalla-scale
   layouts, the kernel against its plain version: the transpose product, the
   dropout product (p 0.3) forward and transpose, and the gradient of the
   embedding through the autograd Function against autograd through the
   plain version; the edges the kernel keeps are exactly those of
   ``edge_uniform``, the keep rate is within 4 binomial sigma of 0.7, and the
   same seed gives the same bits. (b) ``get_trainer`` on the grid's IGCN
   config for 2 epochs: the loss falls, val NDCG@20 beats the random-init
   model's, and the reloaded best checkpoint has alpha = 0.99^k and the same
   metrics. (c) One step is 16 launches (8 products). (d) Step time (single
   steps and windows of 10), examples/s, epoch seconds, and one step under
   ``torch.profiler``;
8. DOSE: the grid's DOSE_aug (d 64, 3 layers, dropout 0.3, aug_num 500,000)
   with its ``DOSEaugTrainer`` on the same set. (a) The view CSR after one
   selection: its nnz, symmetric (equal to its transpose, values bitwise),
   the kernel against its float64 plain version, two products bitwise
   equal, times against ``torch.sparse.mm`` and the byte bound. (b) The
   selection (the 500,000 lowest-cosine pairs): values sorted, pairs
   distinct, each value its pair's cosine recomputed in float64 within 1e-5,
   and no pair of a random sample of 1,000,000 outside the selection above
   the k-th value by more than 1e-5; its time. (c) 2 epochs of
   ``get_trainer``: the loss falls, val NDCG@20 rises from the first epoch
   to the second (it is logged beside the random-init model's, which the
   contrastive term first pulls it below), the views change between epochs,
   and the reloaded best checkpoint's ``rebuild_views`` gives that epoch's
   view CSR bit for bit.
   (d) One step is 32 launches (16 products, 12 of them on the view). (e)
   Step time, examples/s, epoch seconds, the epoch end's selection and view
   rebuild, and one step under ``torch.profiler``. (f) DOSE_drop3 and
   DOSE_aug_drop2 at their grid configs: one ``update_aug_adj`` and 3 steps
   each;
9. zoo: the Gowalla grid's baselines (``configs/grids.py``) at full width on
   the same set, the dataset swapped for it and the epochs cut. (a) The
   kernel's new uses against their plain versions in float64: NGCF's A + I
   forward and transpose under dropout (the kept edges exactly
   ``edge_uniform``'s), IMCGAE's operand padded to d = 68 (its pad column
   exactly 0 after propagation), IDCF's rectangular 0/1 ``feat``, ItemKNN's
   R^T block product at d = 512 and its whole S^T @ P at d = 512 (the plain
   version block of rows by block of rows); an NGCF gradient stays finite
   when an isolated node's self-loop is dropped.
   (b) MF, NGCF and IMCGAE with ``BPRTrainer``, IDCF_LGCN with
   ``IDCFTrainer`` over a LightGCN trained one epoch and saved with
   ``save_checkpoint``: one epoch (438 steps) and one ``evaluate`` each;
   MultiVAE with ``MLTrainer`` (one epoch of 59 steps); NeuMF with
   ``BCETrainer`` (neg_ratio 4) through its three phases, one epoch each;
   ItemKNN (k 1,000: build, ``evaluate``) and Popularity (``evaluate``).
   Each: the loss finite and falling within the epoch, metrics equal to the
   host oracle's, SpMM launches a step by route (NGCF 12, IMCGAE 12, IDCF 14,
   the others 0), step ms (single and windowed), examples/s, one profiled
   step, epoch s, ``evaluate`` ms and users/s;
10. the last four models on the same set, one epoch each, with the checks,
   counts and times of phase 9 (b) (``STEP_LAUNCHES``). (a) AttIGCN at
   IGCN's grid width (4 heads) with the IGCN row's trainer: the product with
   the model's attention as edge values and its transpose against float64,
   d(values) within 1e-5 of max |float64|, ``get_rep`` against the float64
   plain chain, the step's peak device memory. (b) SGL and HALF at
   LightGCN's grid width (aug_rate 0.8): each view keeps exactly
   int(0.8 * n_pairs) pairs and is symmetric, the views change at the epoch
   end, and a reload's views equal the saved ones bit for bit. (c)
   DOSE_aug2 on DOSE_aug's grid row: the selection (the 500,000
   highest-cosine pairs) against float64 cosines, the augmented feature
   CSR (its transpose the same edges and values, its row sums the base's
   plus the injected entries, the same kept edges both ways, both products
   under dropout against float64), and the epoch end's selection, view and
   augmented-matrix build times.
11. the front door, in a temporary directory. (a) The native graph core
   (``native/graph_core.cpp``) builds and loads. (b) A raw
   Gowalla_totalCheckins.txt at the SNAP loc-Gowalla totals (107,092 users,
   1,280,969 places, 6,442,892 check-ins) is written from the seed. (c)
   ``kcore_masks`` on the whole file's distinct pairs and
   ``parse_gowalla_file`` on its first 200,000 lines equal their plain
   versions. (d) ``python -m inductive_recommendation_tpu_torch --preprocess
   gowalla`` in a subprocess writes ``data/Gowalla/time`` (10-core, split
   0.7/0.1/0.2): users x items equal the 10-core's, ``parse_adjacency_file``
   equals its plain version on train.txt. (e) The command line's ``main``
   runs the Gowalla grid's IGCN row (index 2) for one epoch with
   ``--stage test --inductive`` at 90% of the users and items: its JSON line
   parses and is finite, best val NDCG@20 beats the random-init model's of
   the same seed, the SpMM launches are exactly 16 a step + 8 a ``get_rep``
   (by route), the best checkpoint reloads to the line's test metrics
   within 1e-6; (f) so does the model saved in the reference's ``.pth``
   format and imported with ``import_reference_checkpoint``; (g) a
   ``utils.profiling.trace`` of 10 steps holds ``spmm_chunk_kernel`` events.
   Step median, examples/s, epoch s, ``evaluate`` ms and the six inductive
   NDCG@20 are logged.

The counts of kernel launches are set to 0 just before phases 4-5 drive the
serving path and read just after, and again around the training runs of
phases 7 and 8, each model's run in phases 9 and 10 and the command line's
run of phase 11. The last lines are
one JSON object of kernel numbers and then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch import main as cli
from inductive_recommendation_tpu_torch import native
from inductive_recommendation_tpu_torch.configs import get_gowalla_config
from inductive_recommendation_tpu_torch.data import BasicDataset, get_dataset, quick_synthetic_dataset
from inductive_recommendation_tpu_torch.eval import Evaluator, calculate_metrics
from inductive_recommendation_tpu_torch.graph.views import build_aug_feat_csr
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.ops import (
    CsrSpMM,
    _build,
    blockwise_cosine_topk,
    build_csr_spmm,
    edge_uniform,
    propagate_mean,
    spmm_csr_cuda,
    spmm_csr_dropout,
    spmm_csr_dropout_reference,
    spmm_csr_reference,
    spmm_csr_values,
)
from inductive_recommendation_tpu_torch.ops.attention_spmm import fused_kv_attention
from inductive_recommendation_tpu_torch.ops.csr_spmm import EDGES_PER_CHUNK, dropout_values, reset_launch_counts
from inductive_recommendation_tpu_torch.train import bpr_loss, save_checkpoint
from inductive_recommendation_tpu_torch.train.import_reference import import_reference_checkpoint
from inductive_recommendation_tpu_torch.utils import StepTimer, trace
from inductive_recommendation_tpu_torch.utils.profiles import dense_profiles

SEED = 0
N_USERS, N_ITEMS, N_INTER = 29858, 40981, 1_200_000  # Gowalla-scale synthetic set
IGCN_CONFIG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3, "dropout": 0.3, "feature_ratio": 1}
# the IGCN grid entry's trainer (configs/grids.py:21-35,72-84 of the JAX
# package), cut to 2 epochs with validation after each
TRAINER_CONFIG = {
    "name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 0.0, "aux_reg": 0.01,
    "n_epochs": 2, "val_interval": 1, "batch_size": 2048, "test_batch_size": 512,
    "topks": [1] + list(range(5, 101, 5)),
}
# the grid's DOSE configurations and trainer (configs/grids.py:185-245 of
# the JAX package), DOSE_aug cut to 2 epochs as above
DOSE_CONFIG = dict(IGCN_CONFIG, name="DOSE_aug", aug_num=500_000)
DOSE_TRAINER_CONFIG = dict(TRAINER_CONFIG, name="DOSEaugTrainer", l2_reg=0.0, aux_reg=0.001, contrastive_reg=0.1)
DOSE_MORE = (
    (dict(IGCN_CONFIG, name="DOSE_drop3", aug_num=500_000, aug_rate=0.5), "DOSEdropTrainer"),
    (dict(IGCN_CONFIG, name="DOSE_aug_drop2", aug_num=100_000), "DOSEdropTrainer"),
)
SELECTION_SAMPLE = 1_000_000
# the plain version runs block of rows by block of rows, each block's float64
# gathers within this many bytes (ItemKNN's whole S^T @ P at d 512 in one
# pass would gather about 170 GB)
PLAIN_BLOCK_BYTES = 2**32
# phase 10: AttIGCN at IGCN's grid width with the IGCN row's trainer; SGL
# and HALF at LightGCN's grid width with the LightGCN row's lr and l2 and the
# grid's DOSE contrastive_reg (no grid row has SGL); DOSE_aug2 on DOSE_aug's
# grid row renamed; one epoch each
ATT_CONFIG = dict(IGCN_CONFIG, name="AttIGCN", n_heads=4)
SGL_CONFIG = {"name": "SGL", "embedding_size": 64, "n_layers": 3, "aug_rate": 0.8}
SGL_TRAINER_CONFIG = dict(TRAINER_CONFIG, name="SGLTrainer", l2_reg=1e-4, contrastive_reg=0.1, n_epochs=1)
DOSE_AUG2_CONFIG = dict(DOSE_CONFIG, name="DOSE_aug2")
# SpMM launches a training step, by route, of each phase 9 and 10 model
STEP_LAUNCHES = {
    "MF": {}, "MultiVAE": {}, "NeuMF": {},
    "NGCF": {"forward_dropout": 6, "transpose_dropout": 6},
    "IMCGAE": {"forward": 12},
    "IDCF_LGCN": {"forward": 14},
    # the query's feat product and the adjacency's 3 + 3; the aggregation and its backward
    "AttIGCN": {"forward": 14, "attention": 2, "attention_transpose": 2},
    "SGL": {"forward": 12, "view": 24},
    "HALF": {"forward": 12, "view": 12},
    # DOSE_aug's 32, the view's feature products on the augmented matrix
    "DOSE_aug2": {"forward": 12, "forward_dropout": 2, "transpose_dropout": 2, "view": 12, "aug_feat": 2,
                  "aug_feat_transpose": 2},
}
# phase 11: a raw Gowalla file at the published SNAP loc-Gowalla totals,
# preprocessed and run by the command line (the grid's IGCN row, index 2, its
# relative dataset path, the CLI's default seed), with the native routines
# against their plain versions (the numpy parser on a prefix: loadtxt of the
# whole file takes minutes)
GOWALLA_USERS, GOWALLA_ITEMS, GOWALLA_CHECKINS = 107_092, 1_280_969, 6_442_892
GOWALLA_TIMES = ("2009-02-01T00:00:00", "2010-11-01T00:00:00")
PARSE_PREFIX_LINES = 200_000
CLI_ROW, CLI_SEED, CLI_MIN_INTER, CLI_SPLIT = 2, 2021, 10, (0.7, 0.1, 0.2)
GRID_PATH = "data/Gowalla/time"
TRACE_STEPS = 10
REPO = os.path.dirname(os.path.abspath(__file__))
TOPKS = [20]
TEST_BATCH = 512
N_NEW = 1000
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s, fp32
# flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# integer operations of one edge's Philox4x32-10 draw (10 rounds of 2
# mul.hi, 2 mul.lo, 4 xor and 2 key adds), counted at the fp32 rate: the
# published table has no int32 rate, so this term is a lower bound
PHILOX_OPS_PER_EDGE = 100
REL_TOL = 1e-5
U_FP32 = 2.0**-24  # fp32's unit roundoff


def log(*args):
    print(*args, flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_clocks() -> str:
    """The card's SM and memory clocks (MHz) and power draw now, as
    nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=25, warmup=3) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events: the
    time of one call, the wrapper's host work included when it exceeds the
    device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def windowed_ms(*fns, reps=15, inner=10, warmup=5) -> list[float]:
    """Per-call time of each of ``fns`` in a stream of calls: the median over
    ``reps`` windows of ``inner`` back-to-back calls, each window timed with
    CUDA events. The functions take turns window by window, so a drift of the
    card's clock falls on all of them alike."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / inner)
    return [statistics.median(ts) for ts in times]


def host_ms(fn, reps) -> list[float]:
    """Host-clock times of ``reps`` calls, each ending in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_breakdown(fn, top=8):
    """One call of ``fn`` under ``torch.profiler``: (host ms, device busy ms,
    [(kernel name, ms, launches)] by device time: the ``top`` first and the
    SpMM kernels, device launches in all). Busy is the union of the device's
    kernel and copy intervals (user annotations such as ``Optimizer.step``
    are left out). None when the profiler saw no device activity: the
    breakdown is then not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    )
    if not spans:
        return None
    by_name, busy, run_start, run_end = {}, 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + (end - start) / 1e3, n + 1)
        if start > run_end:
            busy += run_end - run_start
            run_start = start
        run_end = max(run_end, end)
    busy = (busy + run_end - run_start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ranked = ranked[:top] + [kv for kv in ranked[top:] if "spmm" in kv[0]]
    return host, busy, [(name, ms, n) for name, (ms, n) in ranked], len(spans)


def close(out, ref, what) -> float:
    """max |out - ref|; raises unless it is <= REL_TOL * max(1, max |ref|).
    For chains of products and gradients; one product is held entry by entry
    (:func:`check_product`)."""
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    scale = max(1.0, ref.abs().max().item() if ref.numel() else 0.0)
    if not err <= REL_TOL * scale:
        raise AssertionError(f"{what}: max abs err {err} > {REL_TOL} * {scale}")
    return err


def spmm_bound_ms(mat, d, dropout=False) -> tuple[float, str]:
    """Least time for one product: CSR (row_ptr, col, val; eid too under
    dropout), x and out moved once, against 2 * nnz * d fp32 flops (plus the
    Philox draw of every edge under dropout)."""
    n_bytes = 4 * (mat.n_rows + 1) + (12 if dropout else 8) * mat.nnz + 4 * d * (mat.n_cols + mat.n_rows)
    n_ops = (2.0 * d + (PHILOX_OPS_PER_EDGE if dropout else 0)) * mat.nnz
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rows_of_degrees(degrees) -> np.ndarray:
    return np.repeat(np.arange(len(degrees)), degrees)


def row_block(mat, r0, r1) -> CsrSpMM:
    """Rows [r0, r1) of ``mat`` as a CSR of their own; the edge ids go along,
    so a dropout seed drops the same edges there."""
    s, e = (int(v) for v in mat.row_ptr[[r0, r1]].tolist())
    return CsrSpMM(row_ptr=mat.row_ptr[r0 : r1 + 1] - s, col=mat.col[s:e], val=mat.val[s:e], eid=mat.eid[s:e],
                   n_rows=r1 - r0, n_cols=mat.n_cols)


def row_blocks(mat, d) -> list[tuple[int, int, CsrSpMM]]:
    """``mat`` cut into blocks of consecutive rows, [(r0, r1, block)], whose
    float64 gathers at width ``d`` stay within PLAIN_BLOCK_BYTES (a longer
    row is a block of its own)."""
    row_ptr = mat.row_ptr.cpu().numpy().astype(np.int64)
    max_edges = max(1, PLAIN_BLOCK_BYTES // (8 * d))
    bounds = [0]
    while bounds[-1] < mat.n_rows:
        r0 = bounds[-1]
        r1 = int(np.searchsorted(row_ptr, row_ptr[r0] + max_edges, side="right")) - 1
        bounds.append(min(mat.n_rows, max(r0 + 1, r1)))
    return [(r0, r1, row_block(mat, r0, r1)) for r0, r1 in zip(bounds, bounds[1:])]


def plain_product(blocks, x, drop=None, magnitude=False) -> torch.Tensor:
    """The plain version of the product over ``blocks`` (:func:`row_blocks`),
    block by block, under the edge dropout ``drop`` = (seed, p) when given;
    with ``magnitude``, |A| @ |x| under the same mask."""
    xs = x.abs() if magnitude else x
    outs = []
    for _, _, m in blocks:
        val = m.val.abs() if magnitude else m.val
        if drop is not None:
            val = dropout_values(val, m.eid, *drop)
        outs.append(spmm_csr_reference(m.row_ptr, m.col, val, xs))
    return torch.cat(outs)


def check_product(what, blocks, x, out, drop=None, other=None) -> dict:
    """Holds the kernel's ``out`` = A @ ``x`` (under ``drop``) against the
    plain version in float64, block of rows by block of rows, entry by entry:

        |out - plain| <= gamma(h_r) * (|A| @ |x|),  gamma(h) = h u / (1 - h u),  u = 2^-24,

    the worst-case rounding error of a sum whose every term passes through at
    most h_r roundings (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., section 4.2). The kernel rounds a term of row r at
    most min(deg_r, E) times in its chunk's fmas (E = EDGES_PER_CHUNK), 5 in
    the lanes' shuffle adds and deg_r // E + 1 in the carry adds: h_r =
    min(deg_r, E) + deg_r // E + 8, 2 to spare. A row whose only edges have x
    = 0 (IMCGAE's pad column) must come out exactly 0. A wrong or lost edge
    moves an entry by one term, about 1/deg_r of (|A| @ |x|): the check sees
    it while deg_r * gamma(h_r) < 1 (``limit_over_mean_term``). Raises on the
    first block past its limit. -> max abs err and max err / limit of
    ``out`` (and of ``other``, another result of the same product, such as
    ``torch.sparse.mm``'s, which is only reported)."""
    x64 = x.double()
    res = {"max_abs_err": 0.0, "max_err_over_limit": 0.0, "limit_over_mean_term": 0.0}
    if other is not None:
        res.update(other_max_abs_err=0.0, other_max_err_over_limit=0.0)
    for r0, r1, m in blocks:
        ref = plain_product([(r0, r1, m)], x64, drop)
        deg = torch.diff(m.row_ptr).double()[:, None]
        h = torch.clamp(deg, max=EDGES_PER_CHUNK) + torch.div(deg, EDGES_PER_CHUNK, rounding_mode="floor") + 8
        gamma = h * U_FP32 / (1.0 - h * U_FP32)
        limit = gamma * plain_product([(r0, r1, m)], x64, drop, magnitude=True)
        res["limit_over_mean_term"] = max(res["limit_over_mean_term"], (deg * gamma).max().item())
        for key, o in (("", out), ("other_", other)):
            if o is None:
                continue
            err = (o[r0:r1].double() - ref).abs()
            if err.numel():
                ratio = err / limit  # inf for an error where the limit is 0
                ratio[(err == 0) & (limit == 0)] = 0.0
                res[f"{key}max_abs_err"] = max(res[f"{key}max_abs_err"], err.max().item())
                res[f"{key}max_err_over_limit"] = max(res[f"{key}max_err_over_limit"], ratio.max().item())
                if not key and not bool((err <= limit).all()):
                    i = int(torch.argmax(torch.nan_to_num(ratio, nan=torch.inf)))
                    r, j = r0 + i // err.shape[1], i % err.shape[1]
                    raise AssertionError(
                        f"{what}: entry ({r}, {j}) err {err.flatten()[i].item()} > its limit "
                        f"{limit.flatten()[i].item()} (row degree {int(deg[i // err.shape[1]])})"
                    )
    return res


def check_kernel_edge_cases(rng) -> float:
    """Empty rows (between, leading and trailing), one row, no edges, a row over
    many chunks, rows of up to three chunks, rows cut exactly at chunk
    boundaries, rows not a multiple of the block; widths of the 16-byte path
    (d % 4 == 0, up to IMCGAE's 68 and ItemKNN's 512) and of the general one
    (d = 37, and d = 64 with x off 16-byte alignment)."""
    worst = worst_ratio = 0.0
    cases = []
    n_rows, n_cols, nnz = 1003, 517, 6000
    row = rng.integers(0, n_rows // 2, nnz) * 2  # odd rows stay empty
    cases.append(("empty rows", row, rng.integers(0, n_cols, nnz), (n_rows, n_cols)))
    cases.append(("one row", np.zeros(37, np.int64), rng.integers(0, 9, 37), (1, 9)))
    cases.append(("no edges", np.zeros(0, np.int64), np.zeros(0, np.int64), (13, 5)))
    # one row of 12,500 edges (dozens of chunks) among light rows, then 300 empty rows
    degrees = np.concatenate([rng.integers(0, 6, 500), [12_500], rng.integers(0, 6, 1500), np.zeros(300, np.int64)])
    cases.append(("long row, trailing empty rows", rows_of_degrees(degrees), None, (len(degrees), 700)))
    e = EDGES_PER_CHUNK
    # rows of 0 to 3 chunks: most chunks hold a cut row's tail and the next one's head
    cases.append(("rows of up to three chunks", rows_of_degrees(rng.integers(0, 3 * e, 300)), None, (300, 400)))
    # row starts on multiples of the chunk, rows of one chunk and of two, rows
    # one edge short of and past a boundary, empty rows at a boundary
    degrees = np.array([e, e, e // 2, e // 2, 2 * e, 0, 0, e - 1, 1, e + 1, e - 1, 3 * e, 0, 1])
    cases.append(("rows cut at chunk boundaries", rows_of_degrees(degrees), None, (len(degrees), 300)))
    for name, row, col, shape in cases:
        col = rng.integers(0, shape[1], len(row)) if col is None else col
        mat = build_csr_spmm(row, col, rng.standard_normal(len(row)) + 0.1, shape, device="cuda")
        for d, aligned in ((16, True), (48, True), (64, True), (68, True), (100, True), (200, True), (512, True),
                           (37, False), (64, False)):
            x = torch.as_tensor(rng.standard_normal((shape[1], d)), dtype=torch.float32, device="cuda")
            if not aligned:  # the same values 4 bytes past an aligned start
                x = torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x).copy_(x)
            out = spmm_csr_cuda(mat, x)
            torch.cuda.synchronize()
            res = check_product(f"{name} d={d} aligned={aligned}", row_blocks(mat, d), x, out)
            worst = max(worst, res["max_abs_err"])
            worst_ratio = max(worst_ratio, res["max_err_over_limit"])
    log(f"kernel edge cases: ok, max abs err {worst:.3g}, at most {worst_ratio:.3g} of an entry's limit")
    return worst


def kernel_device_ms(fn, calls=20) -> dict[str, float] | None:
    """Device time per call of ``fn`` by kernel (``spmm_chunk_kernel``,
    ``spmm_carry_kernel``), from ``torch.profiler`` over ``calls`` calls after
    one warm-up: what the card spent in each, whatever the host's pace. None
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # the profiler now and then records no device event: try once more
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for kernel in ("spmm_chunk_kernel", "spmm_carry_kernel"):
                    if kernel in e.name:
                        ms = (e.time_range.end - e.time_range.start) / 1e3 / calls
                        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + ms
        if by_kernel:
            return by_kernel
    return None


def measure_spmm(name, mat, x, drop=None) -> dict:
    """The kernel against the plain version on ``mat`` @ ``x`` (with the edge
    dropout ``drop`` = (seed, p) when given), and the times. Under dropout
    the plain version draws the mask itself, while ``torch.sparse.mm`` gets
    it folded into its CSR's values: the mask's cost is outside its time.
    The plain version runs block of rows by block of rows (:func:`row_blocks`),
    and the kernel is held to it entry by entry (:func:`check_product`)."""
    blocks = row_blocks(mat, int(x.shape[1]))

    def kernel():
        return spmm_csr_cuda(mat, x, drop=drop)

    def plain():
        return plain_product(blocks, x, drop)

    lib_val = mat.val if drop is None else dropout_values(mat.val, mat.eid, *drop)
    out = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two products on the same inputs differ")
    lib_mat = torch.sparse_csr_tensor(mat.row_ptr, mat.col, lib_val, size=mat.shape)
    check = check_product(name, blocks, x, out, drop, other=torch.sparse.mm(lib_mat, x))
    err = check["max_abs_err"]
    row = {
        "matrix": name,
        "shape": list(mat.shape),
        "nnz": mat.nnz,
        "d": int(x.shape[1]),
        "dropout_p": None if drop is None else drop[1],
        "max_abs_err": err,
        "max_err_over_limit": check["max_err_over_limit"],
        "limit_over_mean_term": check["limit_over_mean_term"],
        "library_max_abs_err": check["other_max_abs_err"],
        "library_max_err_over_limit": check["other_max_err_over_limit"],
        "plain_blocks": len(blocks),
    }
    fns = {
        "ms": kernel,
        "plain_ms": plain,
        "library_ms": lambda: torch.sparse.mm(lib_mat, x),
    }
    for key, fn in fns.items():
        row[key] = median_ms(fn)
    for key, ms in zip(fns, windowed_ms(*fns.values())):
        row[f"{key}_windowed"] = ms
    row["bound_ms"], row["bound_by"] = spmm_bound_ms(mat, int(x.shape[1]), dropout=drop is not None)
    # device time by kernel: launch 1 (the chunks) and launch 2 (the carries),
    # and the clocks the card ran them at
    row["kernel_device_ms"] = kernel_device_ms(kernel)
    row["clocks_after"] = card_clocks()
    # the heaviest row alone: split over chunks, it should no longer floor
    # the product
    degrees = torch.diff(mat.row_ptr)
    r = int(torch.argmax(degrees).item())
    heavy = row_block(mat, r, r + 1)
    row["max_degree"] = heavy.nnz
    row["heaviest_row_ms"] = median_ms(lambda: spmm_csr_cuda(heavy, x, drop=drop))
    heavy_device = kernel_device_ms(lambda: spmm_csr_cuda(heavy, x, drop=drop))
    row["heaviest_row_device_ms"] = heavy_device
    log(
        f"spmm {name}: shape {mat.shape} nnz {mat.nnz} max row degree {heavy.nnz} d {x.shape[1]} dropout {drop}: "
        f"max abs err {err:.3g}, at most {row['max_err_over_limit']:.3g} of an entry's limit, the limit at most "
        f"{row['limit_over_mean_term']:.3g} of a mean term (torch.sparse.mm {row['library_max_abs_err']:.3g}, "
        f"{row['library_max_err_over_limit']:.3g} of the limit); plain version in {len(blocks)} row blocks; "
        f"single calls: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} ms; windows of 10 calls: "
        f"kernel {row['ms_windowed']:.4f} ms, plain {row['plain_ms_windowed']:.4f} ms, "
        f"torch.sparse.mm {row['library_ms_windowed']:.4f} ms; bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); device ms by kernel {row['kernel_device_ms']} (then SM, memory clocks and power "
        f"{row['clocks_after']}); the heaviest row alone "
        f"{row['heaviest_row_ms']:.4f} ms (single calls), device ms by kernel {heavy_device}; "
        f"gathered nnz*d*4 B = {4 * mat.nnz * int(x.shape[1]) / 1e6:.1f} MB at {EDGES_PER_CHUNK} edges "
        f"per chunk; two products bitwise equal"
    )
    return row


def plain_rep(model, params, x0=None):
    """IGCN get_rep through the plain SpMM, on the same device, in float64;
    ``x0`` (float64) replaces the feature product."""
    if x0 is None:
        emb = params["embedding"][: model.feat_n_cols].double()
        x0 = spmm_csr_reference(model.feat.row_ptr, model.feat.col, model.feat.val, emb)
    x, acc = x0, x0
    for _ in range(model.n_layers):
        x = spmm_csr_reference(model.norm_adj.row_ptr, model.norm_adj.col, model.norm_adj.val, x)
        acc = acc + x
    return acc / float(model.n_layers + 1)


def check_metrics(metrics, what):
    for name, by_k in metrics.items():
        for k, v in by_k.items():
            if not (np.isfinite(v) and 0.0 <= v <= 1.0):
                raise AssertionError(f"{what}: {name}@{k} = {v}")


def check_recommend(ds, rec):
    if rec.shape != (ds.n_users, min(max(TOPKS), ds.n_items)):
        raise AssertionError(f"recommend shape {rec.shape}")
    if rec.min() < 0 or rec.max() >= ds.n_items:
        raise AssertionError("recommend returned an id outside the catalog")
    seen = np.concatenate(
        [np.asarray(t, np.int64) + u * ds.n_items for u, t in enumerate(ds.train_data)]
        + [np.asarray(v, np.int64) + u * ds.n_items for u, v in enumerate(ds.val_data)]
    )
    rec_keys = rec.astype(np.int64) + np.arange(ds.n_users, dtype=np.int64)[:, None] * ds.n_items
    if np.isin(rec_keys.ravel(), seen).any():
        raise AssertionError("recommend returned a train/val item for the test stage")


def grown_dataset(ds, rng):
    """``ds`` plus N_NEW users and N_NEW items: each new user takes 40 distinct
    items of the grown catalog, each new item 20 distinct old users; every new
    user's list is split 80/10/10 and every old user's new pair goes to train
    with probability 0.8, else to test."""
    n_users, n_items = ds.n_users + N_NEW, ds.n_items + N_NEW
    grown = BasicDataset({"name": "GrownSynthetic", "split_ratio": [0.8, 0.1, 0.1]})
    grown.n_users, grown.n_items = n_users, n_items
    grown.train_data = [list(t) for t in ds.train_data]
    grown.val_data = [list(v) for v in ds.val_data]
    grown.test_data = [list(t) for t in ds.test_data]
    for _ in range(N_NEW):
        items = rng.choice(n_items, size=40, replace=False).tolist()
        grown.train_data.append(items[:32])
        grown.val_data.append(items[32:36])
        grown.test_data.append(items[36:])
    for item in range(ds.n_items, n_items):
        for u in rng.choice(ds.n_users, size=20, replace=False).tolist():
            (grown.train_data if rng.random() < 0.8 else grown.test_data)[u].append(item)
    grown.train_array = np.array(
        [(u, i) for u, t in enumerate(grown.train_data) for i in t], dtype=np.int64
    )
    return grown


def kept_by_kernel(eid, seed, p):
    """The kernel's mask for the edge ids ``eid``: a layout of one edge per
    row (column 0, value 1, edge id eid[e]) times x = 1, so row e holds edge
    e's dropout value, 1 / (1 - p) or 0."""
    n, dev = eid.shape[0], eid.device
    per_edge = CsrSpMM(
        row_ptr=torch.arange(n + 1, dtype=torch.int32, device=dev),
        col=torch.zeros(n, dtype=torch.int32, device=dev),
        val=torch.ones(n, device=dev),
        eid=eid,
        n_rows=n,
        n_cols=1,
    )
    return spmm_csr_cuda(per_edge, torch.ones(1, 4, device=dev), drop=(seed, p))[:, 0]


def check_dropout_mask(name, mat, seed, p) -> int:
    """The edges the kernel keeps are exactly those ``edge_uniform`` keeps,
    with the same values; the keep rate is within 4 binomial sigma of 1 - p.
    Returns the kept count."""
    got = kept_by_kernel(mat.eid, seed, p)
    want = dropout_values(torch.ones_like(mat.val), mat.eid, seed, p)
    kept_kernel, kept_plain = int((got != 0).sum()), int((edge_uniform(seed, mat.eid) >= p).sum())
    if kept_kernel != kept_plain or not torch.equal(got, want):
        raise AssertionError(f"{name}: the kernel keeps {kept_kernel} edges, edge_uniform {kept_plain}")
    n = mat.nnz
    sigma = (n * p * (1 - p)) ** 0.5
    if abs(kept_kernel - (1 - p) * n) > 4 * sigma:
        raise AssertionError(f"{name}: {kept_kernel} of {n} edges kept, {(1 - p) * n:.0f} +- {4 * sigma:.0f} expected")
    log(f"dropout mask {name}: kernel and edge_uniform keep the same {kept_kernel} of {n} edges "
        f"({kept_kernel / n:.5f}; 1 - p = {1 - p}, 4 sigma = {4 * sigma / n:.5f})")
    return kept_kernel


def check_training_kernels(model, emb, rng) -> dict:
    """Phase 7 (a): the training uses of the kernel at the Gowalla-scale
    layouts, against the plain version, and their times."""
    feat, adj, d = model.feat, model.norm_adj, int(emb.shape[1])
    p, seed = IGCN_CONFIG["dropout"], int(rng.integers(0, 2**62))
    g = torch.as_tensor(rng.normal(0.0, 0.1, (feat.n_rows, d)), dtype=torch.float32, device=emb.device)
    with torch.no_grad():
        for name, mat in (("feat", feat), ("feat^T", feat.T)):
            check_dropout_mask(name, mat, seed, p)
        a = spmm_csr_cuda(feat, emb, drop=(seed, p))
        if not torch.equal(a, spmm_csr_cuda(feat, emb, drop=(seed, p))):
            raise AssertionError("two dropout products with the same seed differ")
        if torch.equal(a, spmm_csr_cuda(feat, emb, drop=(seed + 1, p))):
            raise AssertionError("dropout products with different seeds are equal")
        rows = {
            "transpose": measure_spmm("feat^T", feat.T, g),
            "transpose_dropout": measure_spmm("feat^T dropout", feat.T, g, drop=(seed, p)),
            "dropout": measure_spmm("feat dropout", feat, emb, drop=(seed, p)),
        }

    # the gradient of the embedding: the autograd Functions (kernel forward,
    # kernel on the transpose layouts backward) against autograd through the
    # plain version in float64, under one dropout mask
    w = torch.as_tensor(rng.normal(0.0, 1.0, (adj.n_rows, d)), dtype=torch.float32, device=emb.device)
    x_kernel = emb.detach().clone().requires_grad_(True)
    rep = propagate_mean(adj, spmm_csr_dropout(feat, x_kernel, seed, p), model.n_layers)
    (rep * w).sum().backward()
    x_plain = emb.detach().double().requires_grad_(True)
    x = spmm_csr_dropout_reference(feat, x_plain, seed, p)
    acc = x
    for _ in range(model.n_layers):
        x = spmm_csr_reference(adj.row_ptr, adj.col, adj.val, x)
        acc = acc + x
    (acc / float(model.n_layers + 1) * w.double()).sum().backward()
    rows["grad_err"] = close(x_kernel.grad, x_plain.grad, "embedding gradient through the kernels vs the plain version")
    log(f"embedding gradient (dropout {p}, {model.n_layers} layers): max abs err {rows['grad_err']:.3g} "
        f"(max |plain| {x_plain.grad.abs().max().item():.3g})")
    return rows


def same_csr(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("row_ptr", "col", "val", "eid"))


def train_and_check(trainer, card, n_products) -> dict:
    """Phases 7 (b)-(d) and 8 (c)-(e): the trainer's model trained for its
    epochs, checked, counted (``n_products`` SpMMs a step) and timed. A DOSE
    model's views must change between epochs, and the reloaded checkpoint's
    must be its epoch's, bit for bit."""
    model = trainer.model
    dose = hasattr(model, "views")
    _, init_metrics = trainer.eval("val")
    losses, epoch_s, val_metrics, views = [], [], [], []
    train_one_epoch, evaluate = trainer.train_one_epoch, trainer.eval

    def recorded_epoch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_one_epoch()
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if dose:
            views.append(dict(model.views))
        return loss

    def recorded_eval(stage, banned_items=None):
        results, metrics = evaluate(stage, banned_items)
        val_metrics.append(metrics)
        return results, metrics

    trainer.train_one_epoch, trainer.eval = recorded_epoch, recorded_eval
    reset_launch_counts()  # the training path starts here
    trainer.train(verbose=True)
    launches, route_launches = spmm_csr_cuda.launches, dict(spmm_csr_cuda.route_launches)  # and ends here
    trainer.train_one_epoch, trainer.eval = train_one_epoch, evaluate
    routes = ("forward", "forward_dropout", "transpose_dropout") + (("view",) if dose else ())
    if min(route_launches[r] for r in routes) == 0:
        raise AssertionError(f"a route of the kernel was not launched in training: {route_launches}")

    ndcg = [m["NDCG"][20] for m in val_metrics]
    if not losses[1] < losses[0]:
        raise AssertionError(f"epoch losses {losses}: the second is not below the first")
    best = ndcg.index(max(ndcg)) + 1  # epochs up to and including the best one
    alpha = 1.0
    for _ in range(best):
        alpha *= model.delta
    if model.alpha != alpha:
        raise AssertionError(f"reloaded alpha {model.alpha}, expected {model.delta}^{best} = {alpha}")
    _, final = trainer.eval("val")
    if dose:
        # InfoNCE first pulls the reps away from the random-init model's
        # ranking, which IGCN's template rows make a strong one on this set
        # (PERF.md): DOSE's training shows as NDCG rising epoch on epoch
        if not ndcg[1] > ndcg[0]:
            raise AssertionError(f"val NDCG@20 by epoch {ndcg}: the second is not above the first")
    elif not final["NDCG"][20] > init_metrics["NDCG"][20]:
        raise AssertionError(f"val NDCG@20 {final['NDCG'][20]} after training, {init_metrics['NDCG'][20]} at init")
    for name in ("Precision", "Recall", "NDCG"):
        if abs(final[name][20] - val_metrics[best - 1][name][20]) > 1e-6:
            raise AssertionError(f"the reloaded checkpoint's val {name}@20 {final[name][20]} != {val_metrics[best - 1][name][20]}")
    check_metrics(final, "val after training")
    if dose:
        if all(same_csr(views[0][k], views[1][k]) for k in model.views):
            raise AssertionError("the views did not change between the epochs")
        for k, view in model.views.items():
            if not same_csr(view, views[best - 1][k]):
                raise AssertionError(f"view {k} rebuilt after the reload differs from epoch {best}'s")
        log(f"views: changed between the epochs; rebuilt after the reload equal to epoch {best}'s bit for bit "
            f"(nnz by epoch {[{k: v.nnz for k, v in e.items()} for e in views]})")
    log(
        f"train: epoch losses {losses}; val NDCG@20 {init_metrics['NDCG'][20]:.6f} at init, {ndcg} by epoch, "
        f"{final['NDCG'][20]:.6f} after reloading epoch {best} (alpha {model.alpha}); epoch s {epoch_s}; "
        f"{trainer.steps_per_epoch} steps an epoch; launches {launches} {route_launches}"
    )
    os.remove(trainer.save_path)

    # (c) one step: every sparse product of the forward and the backward
    reset_launch_counts()
    trainer.step()
    torch.cuda.synchronize()
    per_step = dict(spmm_csr_cuda.route_launches)
    if spmm_csr_cuda.launches != 2 * n_products or per_step["transpose"] != 0:
        raise AssertionError(f"one step launched {spmm_csr_cuda.launches} ({per_step}), expected {2 * n_products}")
    log(f"one step: {spmm_csr_cuda.launches} launches for {n_products} products: {per_step}")

    # (d) times
    step_ms = median_ms(trainer.step, reps=30)
    (step_windowed_ms,) = windowed_ms(trainer.step)
    out = {
        "card": card,
        "batch_size": trainer.batch_size,
        "steps_per_epoch": trainer.steps_per_epoch,
        "step_ms": step_ms,
        "step_ms_windowed": step_windowed_ms,
        "examples_per_s": trainer.batch_size / step_ms * 1e3,
        "examples_per_s_windowed": trainer.batch_size / step_windowed_ms * 1e3,
        "epoch_s": epoch_s,
        "epoch_losses": losses,
        "val_ndcg20_init": init_metrics["NDCG"][20],
        "val_ndcg20_by_epoch": ndcg,
        "launches_train_run": launches,
        "route_launches_train_run": route_launches,
        "launches_per_step": per_step,
    }
    breakdown = device_breakdown(trainer.step, top=12)
    if breakdown is None:
        log("one step under torch.profiler: no device activity recorded; breakdown not measured")
    else:
        host, busy, kernels, n_spans = breakdown
        out["profiled_step"] = {"host_ms": host, "device_busy_ms": busy, "device_launches": n_spans, "kernels": kernels}
        log(f"one step under torch.profiler: host {host:.3f} ms, device busy {busy:.3f} ms "
            f"({100.0 * busy / host:.1f}%), {n_spans} device launches, by device time:")
        for name, ms, n in kernels:
            log(f"  {ms:9.4f} ms {n:5d}x  {name[:100]}")
    log(
        f"train step on {card}: {step_ms:.3f} ms (median of 30 single steps), {step_windowed_ms:.3f} ms "
        f"(windows of 10 steps); {out['examples_per_s']:.0f} / {out['examples_per_s_windowed']:.0f} examples/s; "
        f"epoch {epoch_s} s"
    )
    return out


def check_symmetric(view):
    """The view CSR equals its transpose: the same (row, col) pairs both ways
    round, with bitwise equal values."""
    n = view.n_rows
    rows, cols = view.edge_rows().long(), view.col.long()
    key, key_t = rows * n + cols, cols * n + rows
    order, order_t = torch.argsort(key), torch.argsort(key_t)
    if not (torch.equal(key[order], key_t[order_t]) and torch.equal(view.val[order], view.val[order_t])):
        raise AssertionError("the view CSR is not symmetric")


def check_selection(model, params, rng, negate=True) -> dict:
    """Phases 8 (b) and 10 (c): DOSE_aug's selection (the lowest cosines,
    items negated) or DOSE_aug2's (the highest, ``negate`` False) on the card
    against float64 cosines, and its time."""
    k = model.aug_num
    with torch.no_grad():
        rep = model.get_rep(params, training=False)
    users_r, items_r = rep[: model.n_users], rep[model.n_users :]
    vals, uid, iid = blockwise_cosine_topk(users_r, items_r, k, negate_items=negate)
    uid, iid = uid.long(), iid.long()
    if vals.shape != (k,) or not torch.isfinite(vals).all() or (torch.diff(vals) > 0).any():
        raise AssertionError("the selected values are not k finite values in descending order")
    keys = uid * model.n_items + iid
    if torch.unique(keys).numel() != k:
        raise AssertionError("the selection holds a pair twice")
    un = users_r.double() / users_r.double().norm(dim=1, keepdim=True).clamp_min(1e-12)
    itn = (-1.0 if negate else 1.0) * items_r.double() / items_r.double().norm(dim=1, keepdim=True).clamp_min(1e-12)
    cos_err = ((un[uid] * itn[iid]).sum(1) - vals.double()).abs().max().item()
    if cos_err > 1e-5:
        raise AssertionError(f"a selected value is {cos_err} from its pair's float64 cosine")
    g = torch.Generator(device=rep.device).manual_seed(int(rng.integers(0, 2**62)))
    su = torch.randint(0, model.n_users, (SELECTION_SAMPLE,), generator=g, device=rep.device)
    si = torch.randint(0, model.n_items, (SELECTION_SAMPLE,), generator=g, device=rep.device)
    outside = ~torch.isin(su * model.n_items + si, keys)
    sample_max = (un[su[outside]] * itn[si[outside]]).sum(1).max().item()
    kth = vals[-1].item()
    if sample_max > kth + 1e-5:
        raise AssertionError(f"a pair outside the selection has cos {sample_max} above the k-th value {kth}")
    ms = host_ms(lambda: blockwise_cosine_topk(users_r, items_r, k, negate_items=negate), 3)
    out = {"k": k, "kth_value": kth, "max_cos_err_float64": cos_err, "sample_max_outside": sample_max,
           "sample_outside": int(outside.sum()), "selection_ms": ms, "panels": -(-model.n_users // 512)}
    which = "lowest" if negate else "highest"
    log(f"selection: {k} {which}-cosine pairs of {model.n_users} x {model.n_items}, sorted and distinct; k-th value "
        f"{kth:.6f}; max |value - float64 cos| {cos_err:.3g}; max over {out['sample_outside']} sampled pairs outside "
        f"it {sample_max:.6f}; {ms} ms ({out['panels']} panels of 512 users)")
    return out


def dose_phase(ds, card, rng) -> dict:
    """Phase 8: DOSE_aug's view CSR, selection and training, then DOSE_drop3
    and DOSE_aug_drop2."""
    trainer = get_trainer(DOSE_TRAINER_CONFIG, ds, get_model(DOSE_CONFIG, ds))
    model, params = trainer.model, trainer.params

    # (b) the selection, then (a) the view it makes; the model keeps its
    # initial view, so that the training run below is a fresh one
    selection = check_selection(model, params, rng)
    view = model.view_engine.make_view_on_device(add_pairs=model._cos_pairs(params, model.aug_num, True))
    check_symmetric(view)
    with torch.no_grad():
        x = model.inductive_rep_layer(params)
        view_row = measure_spmm("view", view, x)
    log(f"view CSR: {view.shape} nnz {view.nnz} (adjacency {model.norm_adj.nnz} + 2 x "
        f"{(view.nnz - model.norm_adj.nnz) // 2} injected), symmetric, values bitwise equal both ways")

    # (c)-(e) training, launches a step, times
    n_products = 2 * (2 + 2 * model.n_layers)
    train = train_and_check(trainer, card, n_products=n_products)
    if train["launches_per_step"]["view"] != 4 * model.n_layers:
        raise AssertionError(f"one step launched {train['launches_per_step']} on the view, expected {4 * model.n_layers}")
    params = trainer.params
    pairs = model._cos_pairs(params, model.aug_num, True)
    epoch_end = {
        "anneal_ms": host_ms(model.feat_mat_anneal, 1),
        "selection_ms": host_ms(lambda: model._cos_pairs(params, model.aug_num, True), 3),
        "view_build_ms": host_ms(lambda: model.view_engine.make_view_on_device(add_pairs=pairs), 3),
        "update_aug_adj_ms": host_ms(lambda: model.update_aug_adj(params), 3),
    }
    log(f"epoch end on {card}: {json.dumps(epoch_end)}")

    # (f) the other grid variants: one update and 3 steps each
    more = {}
    for config, trainer_name in DOSE_MORE:
        t = get_trainer(dict(DOSE_TRAINER_CONFIG, name=trainer_name), ds, get_model(config, ds))
        update_ms = host_ms(lambda: t.model.update_aug_adj(t.params), 1)[0]
        step_losses = [t.step().item() for _ in range(3)]
        if not np.isfinite(step_losses).all():
            raise AssertionError(f"{config['name']}: step losses {step_losses}")
        nnz = {k: v.nnz for k, v in t.model.views.items()}
        more[config["name"]] = {"update_aug_adj_ms": update_ms, "step_losses": step_losses, "view_nnz": nnz}
        log(f"{config['name']}: update_aug_adj {update_ms:.1f} ms, views nnz {nnz} (adjacency "
            f"{t.model.norm_adj.nnz}), 3 steps, losses {step_losses}")
        del t
    return {"train": train, "selection": selection, "view_row": view_row, "epoch_end": epoch_end, "more": more}


def grid_row(name):
    """Copies of the Gowalla grid's (dataset, model, trainer) configs of the
    model ``name``."""
    for dataset_cfg, model_cfg, trainer_cfg in get_gowalla_config():
        if model_cfg["name"] == name:
            return dict(dataset_cfg), dict(model_cfg), dict(trainer_cfg)
    raise KeyError(name)


def evaluate_and_check(ds, ev, model, params, name):
    """``evaluate('test')`` on the card, timed, its metrics against the host
    oracle over ``recommend``'s lists; -> (metrics, evaluate ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = ev.evaluate(model, params, "test")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check_metrics(metrics, f"{name} evaluate")
    rec = ev.recommend(model, params, "test")
    check_recommend(ds, rec)
    oracle = calculate_metrics(ds.test_data, rec, TOPKS)
    for m in ("Precision", "Recall", "NDCG"):
        if abs(oracle[m][20] - metrics[m][20]) > 1e-6:
            raise AssertionError(f"{name} {m}@20: device {metrics[m][20]} vs host oracle {oracle[m][20]}")
    return metrics, ms


def train_recorded(trainer, run):
    """``run()`` (epochs of ``trainer``) with every step's loss kept; raises
    unless the losses are finite and the last tenth of each epoch's steps
    averages below its first tenth. -> (per-epoch step losses, epoch s)."""
    real_step, steps, epoch_s = trainer.step, [], []
    real_epoch = trainer.train_one_epoch

    def step(*batch):
        loss = real_step(*batch)
        steps.append(loss)
        return loss

    def epoch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_epoch()
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return out

    trainer.step, trainer.train_one_epoch = step, epoch
    run()
    trainer.step, trainer.train_one_epoch = real_step, real_epoch
    losses = torch.stack(steps).double().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{trainer.model.name}: a step loss is not finite")
    by_epoch = np.split(losses, len(epoch_s))
    for e, ls in enumerate(by_epoch):
        k = max(1, len(ls) // 10)
        if not ls[-k:].mean() < ls[:k].mean():
            raise AssertionError(f"{trainer.model.name} epoch {e}: loss {ls[:k].mean()} -> {ls[-k:].mean()}, no fall")
    return by_epoch, epoch_s


def zoo_model_run(name, trainer, ds, ev, card, examples_per_step, run=None) -> dict:
    """Phases 9 (b) and 10 for one trainable model: ``run`` trains it
    (default: one epoch), ``evaluate`` follows; the launches of both by
    route, one step's launches by route against ``STEP_LAUNCHES``, the
    step's times and one profiled step."""
    model = trainer.model
    run = run or (lambda: trainer.train_one_epoch())
    reset_launch_counts()  # the model's run starts here
    by_epoch, epoch_s = train_recorded(trainer, run)
    metrics, eval_ms = evaluate_and_check(ds, ev, model, trainer.params, name)
    run_launches = dict(spmm_csr_cuda.route_launches)  # and ends here
    expected = STEP_LAUNCHES[name]
    if expected and min(run_launches[r] for r in expected) == 0:
        raise AssertionError(f"{name}: a route of the kernel was not launched in its run: {run_launches}")
    # a trainer that takes its batches as arguments (MLTrainer) gets one
    # batch of its epoch, built once outside the timed steps
    batch = trainer.batches(trainer.epoch)[0][:2] if hasattr(trainer, "batches") else ()

    def step():
        return trainer.step(*batch)

    reset_launch_counts()
    step()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in spmm_csr_cuda.route_launches.items() if v}
    if per_step != expected:
        raise AssertionError(f"{name}: one step launched {per_step}, expected {expected}")
    step_ms = median_ms(step, reps=30)
    (step_windowed_ms,) = windowed_ms(step)
    out = {
        "card": card,
        "steps_per_epoch": trainer.steps_per_epoch,
        "examples_per_step": examples_per_step,
        "step_ms": step_ms,
        "step_ms_windowed": step_windowed_ms,
        "examples_per_s": examples_per_step / step_ms * 1e3,
        "examples_per_s_windowed": examples_per_step / step_windowed_ms * 1e3,
        "epoch_s": epoch_s,
        "epoch_loss_first_last": [[float(ls[0]), float(ls[-1])] for ls in by_epoch],
        "test_ndcg20": metrics["NDCG"][20],
        "test_recall20": metrics["Recall"][20],
        "evaluate_ms": eval_ms,
        "evaluate_users_per_s": ds.n_users / eval_ms * 1e3,
        "route_launches_run": run_launches,
        "launches_per_step": per_step,
    }
    breakdown = device_breakdown(step, top=6)
    busy = "not measured"
    if breakdown is not None:
        host, busy_ms, kernels, n_spans = breakdown
        out["profiled_step"] = {"host_ms": host, "device_busy_ms": busy_ms, "device_launches": n_spans,
                                "kernels": kernels}
        busy = f"{busy_ms:.3f} of {host:.3f} ms ({100.0 * busy_ms / host:.1f}%), {n_spans} device launches"
    log(
        f"{name} on {card}: step {step_ms:.3f} ms single, {step_windowed_ms:.3f} ms windowed; "
        f"{out['examples_per_s']:.0f} / {out['examples_per_s_windowed']:.0f} examples/s ({examples_per_step} a step); "
        f"profiled step: device busy {busy}; SpMM launches a step {per_step}; epoch s {epoch_s}; "
        f"losses {out['epoch_loss_first_last']} (first and last step of each epoch); evaluate {eval_ms:.1f} ms "
        f"({out['evaluate_users_per_s']:.0f} users/s), test NDCG@20 {metrics['NDCG'][20]:.6f} = host oracle's; "
        f"run launches {run_launches}"
    )
    return out


def check_ngcf_isolated_node():
    """An NGCF gradient on the card stays finite when an isolated item's
    self-loop, its row's only edge, is dropped (p 0.95): the row of h is
    exactly 0, and the clamp inside the square root keeps the backward
    finite (JAX ``ngcf.py:102-113``)."""
    tiny = BasicDataset({"name": "Isolated"})
    tiny.n_users, tiny.n_items = 3, 5  # items 3 and 4 have no interaction
    tiny.train_array = np.array([[0, 0], [0, 1], [1, 0], [1, 2], [2, 1], [2, 2]])
    model = get_model({"name": "NGCF", "embedding_size": 8, "layer_sizes": [8, 8], "dropout": 0.95}, tiny)
    params = model.params()
    ids = [torch.tensor(v, device=model.device) for v in ([0, 1], [0, 1], [2, 0])]
    dropped = 0
    for seed in range(8):
        out = model.bpr_forward(params, *ids, generator=torch.Generator().manual_seed(seed))
        loss = bpr_loss(*out[:3]) + 1e-3 * out[3].mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            raise AssertionError(f"NGCF seed {seed}: a loss or gradient is not finite")
        with torch.no_grad():
            rep = model.get_rep(params, training=True, generator=torch.Generator().manual_seed(seed))
        dropped += int((rep[tiny.n_users + 3, 8:] == 0).all())
    if dropped == 0:
        raise AssertionError("NGCF: no seed dropped the isolated item's self-loop")
    log(f"NGCF isolated node: gradients finite over 8 steps, the self-loop dropped in {dropped}")


def zoo_phase(ds, card, rng) -> dict:
    """Phase 9: the Gowalla grid's baselines, each at the grid's width, one
    epoch (NeuMF one per phase), its kernel uses against the plain version."""
    rows, models, evs = {}, {}, {}
    # NeuMF's grid row sets the dataset's neg_ratio to 4
    neumf_ds = copy.copy(ds)
    neumf_ds.negative_sample_ratio = grid_row("NeuMF")[0]["neg_ratio"]

    def evaluator(batch):
        if batch not in evs:
            evs[batch] = Evaluator(ds, topks=TOPKS, test_batch_size=batch)
        return evs[batch]

    def trainer_of(name, **cut):
        """The grid row's model and trainer, the trainer cut to one epoch
        (or as ``cut`` says) and the model config updated by ``model``."""
        _, model_cfg, trainer_cfg = grid_row(name)
        model_cfg.update(cut.pop("model", {}))
        data = neumf_ds if name == "NeuMF" else ds
        return get_trainer(dict(trainer_cfg, **{"n_epochs": 1, **cut}), data, get_model(model_cfg, data))

    # MF
    t = trainer_of("MF")
    models["MF"] = zoo_model_run("MF", t, ds, evaluator(512), card, t.batch_size)
    del t

    # NGCF: its kernel uses, the isolated node, then the run
    t = trainer_of("NGCF")
    adj, p = t.model.norm_adj, t.model.dropout
    seed = int(rng.integers(0, 2**62))
    with torch.no_grad():
        for what, mat in (("NGCF A+I", adj), ("NGCF (A+I)^T", adj.T)):
            check_dropout_mask(what, mat, seed, p)
        emb = t.params["embedding"].detach()
        g = torch.as_tensor(rng.normal(0.0, 0.1, tuple(emb.shape)), dtype=torch.float32, device=emb.device)
        rows["ngcf_dropout"] = measure_spmm("NGCF A+I dropout", adj, emb, drop=(seed, p))
        rows["ngcf_transpose_dropout"] = measure_spmm("NGCF (A+I)^T dropout", adj.T, g, drop=(seed, p))
    check_ngcf_isolated_node()
    models["NGCF"] = zoo_model_run("NGCF", t, ds, evaluator(512), card, t.batch_size)
    del t

    # IMCGAE: the padded operand
    t = trainer_of("IMCGAE")
    model = t.model
    with torch.no_grad():
        x = model.operand(t.params)
        rows["imcgae"] = measure_spmm(f"IMCGAE adj d{x.shape[1]}", model.norm_adj, x)
        unpadded = x[:, : model.embedding_size + 3].contiguous()
        rows["imcgae"]["ms_unpadded"] = median_ms(lambda: spmm_csr_cuda(model.norm_adj, unpadded))
        rows["imcgae"]["d_unpadded"] = int(unpadded.shape[1])
        for training in (False, True):
            padded, _ = model.compact_rep(t.params, training, torch.Generator().manual_seed(1), padded=True)
            if torch.count_nonzero(padded[:, model.embedding_size + 3 :]) != 0:
                raise AssertionError(f"IMCGAE: the operand's pad column is not 0 after propagation (training {training})")
    log(f"IMCGAE: pad column exactly 0 after {model.n_layers} layers, with and without node dropout; "
        f"d {x.shape[1]} {rows['imcgae']['ms']:.4f} ms against d {unpadded.shape[1]} "
        f"{rows['imcgae']['ms_unpadded']:.4f} ms (single calls)")
    models["IMCGAE"] = zoo_model_run("IMCGAE", t, ds, evaluator(512), card, t.batch_size)
    del t, model

    # IDCF_LGCN over a LightGCN trained one epoch and saved
    lgcn = trainer_of("LightGCN")
    lgcn.train_one_epoch()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lgcn.pt")
        save_checkpoint(path, lgcn.params)
        t = trainer_of("IDCF_LGCN", model={"lgcn_path": path})
    del lgcn
    with torch.no_grad():
        rows["idcf_feat"] = measure_spmm("IDCF feat", t.model.feat, t.model.frozen_embedding)
    models["IDCF_LGCN"] = zoo_model_run("IDCF_LGCN", t, ds, evaluator(512), card, t.batch_size)
    del t

    # MultiVAE
    t = trainer_of("MultiVAE")
    models["MultiVAE"] = zoo_model_run("MultiVAE", t, ds, evaluator(512), card, t.batch_size)
    del t

    # NeuMF: its three phases, one epoch each, through train()
    t = trainer_of("NeuMF", n_epochs=3, mf_pretrain_epochs=1, mlp_pretrain_epochs=1, val_interval=1)
    archs = []
    real_loss = t.loss
    t.loss = lambda: (archs.append(t.model.arch), real_loss())[1]
    models["NeuMF"] = zoo_model_run(
        "NeuMF", t, ds, evaluator(t.evaluator.test_batch_size), card, t.batch_size * (1 + t.neg_ratio),
        run=lambda: t.train(verbose=False),
    )
    n = t.steps_per_epoch
    if archs[: 3 * n] != ["gmf"] * n + ["mlp"] * n + ["neumf"] * n:
        raise AssertionError(f"NeuMF's phases: {sorted(set(archs[:3 * n]))} in {len(archs)} steps")
    models["NeuMF"]["archs"] = ["gmf", "mlp", "neumf"]
    os.remove(t.save_path)
    del t

    # ItemKNN: the build, its kernel uses, evaluate
    _, knn_cfg, _ = grid_row("ItemKNN")
    reset_launch_counts()  # the build starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knn = get_model(knn_cfg, ds)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = spmm_csr_cuda.launches  # and ends here
    sim_t, k = knn.sim_t, min(knn.k, ds.n_items)
    if build_launches == 0 or int(torch.bincount(sim_t.col.long(), minlength=ds.n_items).max()) > k:
        raise AssertionError(f"ItemKNN: {build_launches} build launches, or an item with more than {k} neighbours")
    rt, _ = knn.similarity_inputs(ds)
    users = torch.arange(512, device=knn.device)
    with torch.no_grad():
        rows["itemknn_rt"] = measure_spmm("ItemKNN R^T block", rt, knn.block_columns(rt, 0, knn.block))
        profiles_t = dense_profiles(knn.train_padded, users, ds.n_items).T.contiguous()
        rows["itemknn_sim_t"] = measure_spmm("ItemKNN S^T", sim_t, profiles_t)
    sim_row = rows["itemknn_sim_t"]
    ev = evaluator(512)
    reset_launch_counts()  # ItemKNN's evaluate starts here
    metrics, eval_ms = evaluate_and_check(ds, ev, knn, {}, "ItemKNN")
    eval_launches = spmm_csr_cuda.launches  # and ends here
    models["ItemKNN"] = {
        "card": card, "k": k, "similarity_build_s": build_s, "build_launches": build_launches,
        "sim_t_nnz": sim_t.nnz, "evaluate_ms": eval_ms, "evaluate_users_per_s": ds.n_users / eval_ms * 1e3,
        "evaluate_launches": eval_launches, "test_ndcg20": metrics["NDCG"][20],
    }
    log(f"ItemKNN on {card}: similarity build {build_s:.2f} s ({build_launches} launches, "
        f"{-(-ds.n_items // knn.block)} blocks of {knn.block}); S^T {sim_t.shape} nnz {sim_t.nnz}; "
        f"the whole S^T @ P (d 512) {sim_row['ms']:.3f} ms, torch.sparse.mm {sim_row['library_ms']:.3f} ms, "
        f"bound {sim_row['bound_ms']:.3f} ms; evaluate {eval_ms:.1f} ms ({models['ItemKNN']['evaluate_users_per_s']:.0f} "
        f"users/s, {eval_launches} launches), test NDCG@20 {metrics['NDCG'][20]:.6f} = host oracle's")
    del knn, rt, sim_t, profiles_t

    # Popularity
    pop = get_model({"name": "Popularity"}, ds)  # in no grid row; it has no parameter
    metrics, eval_ms = evaluate_and_check(ds, evaluator(512), pop, {}, "Popularity")
    models["Popularity"] = {"card": card, "evaluate_ms": eval_ms, "evaluate_users_per_s": ds.n_users / eval_ms * 1e3,
                            "test_ndcg20": metrics["NDCG"][20]}
    log(f"Popularity on {card}: evaluate {eval_ms:.1f} ms, test NDCG@20 {metrics['NDCG'][20]:.6f} = host oracle's")
    return {"rows": rows, "models": models}


def plain_att_rep(model, params):
    """AttIGCN get_rep in float64: the query and the adjacency through the
    plain SpMM, the attention through its torch ops, the aggregation through
    the plain SpMM with the attention as values."""
    p = {k: v.detach().double() for k, v in params.items()}
    emb = p["embedding"][: model.feat_n_cols]
    feat, att = model.feat, model.att_feat
    x_q = spmm_csr_reference(feat.row_ptr, feat.col, feat.val.double(), emb)
    q = (x_q @ p["weight_q.w"] + p["weight_q.b"]).reshape(-1, model.n_heads, model.embedding_size)
    attn = fused_kv_attention(att, q, p["weight_k.w"], p["weight_k.b"], emb, model.temperature)
    return plain_rep(model, params, spmm_csr_reference(att.row_ptr, att.col, attn, emb))


def check_attention_kernels(model, params, rng) -> dict:
    """Phase 10 (a): the product with the model's attention as edge values and
    its transpose (the attention gathered into the transpose's edge order)
    against float64; d(values) through the autograd Function against
    float64, within 1e-5 of max |float64|; ``get_rep`` against the float64
    plain chain."""
    att, d = model.att_feat, model.embedding_size
    emb = params["embedding"][: model.feat_n_cols].detach()
    g = torch.as_tensor(rng.normal(0.0, 0.1, (att.n_rows, d)), dtype=torch.float32, device=emb.device)
    with torch.no_grad():
        attn = model.attention(params)
        rows = {
            "attention": measure_spmm("attention", dataclasses.replace(att, val=attn), emb),
            "attention_transpose": measure_spmm(
                "attention^T", dataclasses.replace(att.T, val=attn[att.t_pos].contiguous()), g
            ),
        }
    values = attn.clone().requires_grad_(True)
    (spmm_csr_values(att, emb, values) * g).sum().backward()
    with torch.no_grad():
        plain = (g.double()[att.edge_rows().long()] * emb.double()[att.col.long()]).sum(-1)
        err = (values.grad.double() - plain).abs().max().item()
        scale = plain.abs().max().item()
    if not err <= 1e-5 * scale:
        raise AssertionError(f"d(values): max abs err {err} > 1e-5 * {scale}")
    rows["d_values_max_abs_err"], rows["d_values_max_abs_plain"] = err, scale
    with torch.no_grad():
        rep = model.get_rep(params)
        rows["rep_max_abs_err"] = close(rep, plain_att_rep(model, params), "AttIGCN get_rep vs the plain chain")
    if rep.shape != (model.n_users + model.n_items, d) or not torch.isfinite(rep).all():
        raise AssertionError(f"AttIGCN get_rep: shape {tuple(rep.shape)} or non-finite values")
    log(f"AttIGCN: attention over {att.nnz} edges ({model.n_heads} heads, T {model.temperature}); d(values) max abs "
        f"err {err:.3g} (max |float64| {scale:.3g}); get_rep vs the float64 plain chain {rows['rep_max_abs_err']:.3g}")
    return rows


def step_peak_bytes(trainer) -> int:
    """Peak device memory allocated over one training step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def check_sgl_views(model):
    """Each view keeps exactly int(aug_rate * n_pairs) train pairs, both
    directions, and is symmetric."""
    n_keep = int(model.aug_rate * model.view_engine.n_pairs)
    for key, view in model.views.items():
        if view.nnz != 2 * n_keep:
            raise AssertionError(f"{model.name} view {key}: nnz {view.nnz}, expected 2 x {n_keep}")
        check_symmetric(view)
    return n_keep


def check_aug_feat(model, params, rng) -> dict:
    """Phase 10 (c): DOSE_aug2's augmented feature CSR after an update: the
    transpose holds the same edges with the same values; the row sums are
    the base's plus the injected entries; the kernel keeps the same edges
    both ways; both products under dropout against float64."""
    aug, base, n = model.aug_feat, model._aug_base, model.n_users + model.n_items
    fo, to = torch.argsort(aug.eid), torch.argsort(aug.T.eid)
    same = (torch.equal(aug.eid[fo], aug.T.eid[to]) and torch.equal(aug.edge_rows()[fo], aug.T.col[to])
            and torch.equal(aug.col[fo], aug.T.edge_rows()[to]) and torch.equal(aug.val[fo], aug.T.val[to]))
    if not same:
        raise AssertionError("the augmented feature CSR's transpose does not hold its edges and values")
    # every base entry counts 1 (deduplicated pairs), every injected one 1
    injected = model.aug_row_sum - base["row_sum"]
    n_new = (model.views["aug_adj"].nnz - model.norm_adj.nnz) // 2  # selected pairs not in train
    if not (torch.equal(base["row_sum"], torch.bincount(base["rows"], minlength=n).float())
            and torch.equal(model.aug_row_sum, torch.diff(aug.row_ptr).float())
            and int(injected.sum()) == aug.nnz - base["rows"].shape[0] == 2 * n_new):
        raise AssertionError(f"row sums: {int(injected.sum())} injected, {aug.nnz - base['rows'].shape[0]} new "
                             f"edges, {n_new} new pairs")
    p, seed = model.dropout, int(rng.integers(0, 2**62))
    kept = {name: check_dropout_mask(name, mat, seed, p) for name, mat in (("aug_feat", aug), ("aug_feat^T", aug.T))}
    emb = params["embedding"][: model.feat_n_cols].detach()
    g = torch.as_tensor(rng.normal(0.0, 0.1, (aug.n_rows, emb.shape[1])), dtype=torch.float32, device=emb.device)
    with torch.no_grad():
        rows = {
            "aug_feat_dropout": measure_spmm("aug_feat dropout", aug, emb, drop=(seed, p)),
            "aug_feat_transpose_dropout": measure_spmm("aug_feat^T dropout", aug.T, g, drop=(seed, p)),
        }
    log(f"DOSE_aug2 augmented feature CSR: {aug.shape} nnz {aug.nnz} ({base['rows'].shape[0]} train entries + "
        f"{int(injected.sum())} from {n_new} selected pairs not in train); transpose the same edges and values; "
        f"row sums base + injected; kept edges {kept}")
    return rows


def last_models_phase(ds, card, rng) -> dict:
    """Phase 10: AttIGCN, SGL, HALF and DOSE_aug2, one epoch each, their new
    kernel uses against the plain version."""
    rows, models = {}, {}
    ev = Evaluator(ds, topks=TOPKS, test_batch_size=TEST_BATCH)

    # (a) AttIGCN
    t = get_trainer(dict(TRAINER_CONFIG, n_epochs=1), ds, get_model(ATT_CONFIG, ds))
    rows.update(check_attention_kernels(t.model, t.params, rng))
    models["AttIGCN"] = zoo_model_run("AttIGCN", t, ds, ev, card, t.batch_size)
    models["AttIGCN"]["step_peak_bytes"] = step_peak_bytes(t)
    log(f"AttIGCN step peak device memory {models['AttIGCN']['step_peak_bytes'] / 2**30:.3f} GiB")
    del t

    # (b) SGL and HALF
    for name, trainer_name in (("SGL", "SGLTrainer"), ("HALF", "HALFTrainer")):
        t = get_trainer(dict(SGL_TRAINER_CONFIG, name=trainer_name), ds, get_model(dict(SGL_CONFIG, name=name), ds))
        model = t.model
        n_keep = check_sgl_views(model)
        if name == "SGL":
            with torch.no_grad():
                emb = t.params["embedding"][: model.n_users + model.n_items].detach()
                rows["sgl_view"] = measure_spmm("SGL drop view", model.views["aug_adj1"], emb)
        before = dict(model.views)
        models[name] = zoo_model_run(name, t, ds, ev, card, t.batch_size)
        check_sgl_views(model)
        if any(same_csr(before[k], model.views[k]) for k in before):
            raise AssertionError(f"{name}: a view did not change at the epoch end")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}.pt")
            t._save_model(path)
            saved = dict(model.views)
            model.update_aug_adj(t.params)  # views of other draws
            t._load_model(path)
        if not all(same_csr(saved[k], model.views[k]) for k in saved):
            raise AssertionError(f"{name}: the views rebuilt after the reload differ from the saved ones")
        models[name]["view_pairs_kept"] = n_keep
        log(f"{name}: {len(saved)} views of {n_keep} of {model.view_engine.n_pairs} pairs, symmetric; changed at the "
            f"epoch end; rebuilt after a reload bit for bit")
        del t, model

    # (c) DOSE_aug2
    t = get_trainer(dict(DOSE_TRAINER_CONFIG, n_epochs=1), ds, get_model(DOSE_AUG2_CONFIG, ds))
    model, params = t.model, t.params
    selection = check_selection(model, params, rng, negate=False)
    first_update_ms = host_ms(lambda: model.update_aug_adj(params), 1)[0]
    rows.update(check_aug_feat(model, params, rng))
    models["DOSE_aug2"] = zoo_model_run("DOSE_aug2", t, ds, ev, card, t.batch_size)
    params = t.params
    pairs = model._cos_pairs(params, model.aug_num, False)
    build = dict(n_users=model.n_users, n_items=model.n_items, user_dim=model.user_dim, n_cols=model.feat_n_cols)
    epoch_end = {
        "first_update_aug_adj_ms": first_update_ms,
        "anneal_ms": host_ms(model.feat_mat_anneal, 1),
        "selection_ms": host_ms(lambda: model._cos_pairs(params, model.aug_num, False), 3),
        "view_build_ms": host_ms(lambda: model.view_engine.make_view_on_device(add_pairs=pairs), 3),
        "aug_feat_build_ms": host_ms(
            lambda: build_aug_feat_csr(model._aug_base, model.view_engine.train_keys, pairs, model.alpha, **build), 3
        ),
        "update_aug_adj_ms": host_ms(lambda: model.update_aug_adj(params), 3),
    }
    models["DOSE_aug2"].update(selection=selection, epoch_end=epoch_end)
    log(f"DOSE_aug2 epoch end on {card}: {json.dumps(epoch_end)}")
    del t, model
    return {"rows": rows, "models": models}


def write_gowalla_tsv(path, rng, n_users, n_items, n_checkins, chunk=500_000):
    """A Gowalla_totalCheckins.txt (``user\\tISO-8601 time\\tlat\\tlon\\titem``)
    of ``n_checkins`` lines: users drawn ∝ u^-0.6 and items ∝ i^-0.8 (as
    ``SyntheticDataset``), times uniform over ``GOWALLA_TIMES``, one place per
    item; a (user, item) pair may repeat, and the parser keeps its earliest
    time."""
    u_w = np.arange(1, n_users + 1, dtype=np.float64) ** -0.6
    i_w = np.arange(1, n_items + 1, dtype=np.float64) ** -0.8
    users = rng.choice(n_users, size=n_checkins, p=u_w / u_w.sum())
    items = rng.choice(n_items, size=n_checkins, p=i_w / i_w.sum())
    t0, t1 = (np.datetime64(t, "s").astype(np.int64) for t in GOWALLA_TIMES)
    times = rng.integers(t0, t1, size=n_checkins).astype("datetime64[s]")
    lat = [f"{x:.6f}" for x in rng.uniform(-60.0, 70.0, n_items)]
    lon = [f"{x:.6f}" for x in rng.uniform(-180.0, 180.0, n_items)]
    with open(path, "w") as f:
        for s in range(0, n_checkins, chunk):
            u, i = users[s : s + chunk].tolist(), items[s : s + chunk].tolist()
            t = np.datetime_as_string(times[s : s + chunk]).tolist()
            f.write("".join(f"{a}\t{b}Z\t{lat[c]}\t{lon[c]}\t{c}\n" for a, b, c in zip(u, t, i)))


class Tee(io.TextIOBase):
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def check_equal_arrays(what, got, want):
    for g, w in zip(got, want):
        if not np.array_equal(g, w):
            raise AssertionError(f"{what}: the native routine and its plain version differ")


def split_counts(out_path):
    """(users, items, {split: pairs}) of written train/val/test.txt files."""
    pairs, n_users, n_items = {}, None, 0
    for split in ("train", "val", "test"):
        flat, offs = native.parse_adjacency_file(os.path.join(out_path, f"{split}.txt"))
        pairs[split] = len(flat)
        n_users = len(offs) - 1
        n_items = max(n_items, int(flat.max()) + 1)
    return n_users, n_items, pairs


def run_cli(argv, n_layers):
    """``main(argv)`` of the command line, in this process, with its trainer's
    steps (``StepTimer``), epochs and evaluations timed and its inductive
    slices kept; the SpMM launch counts are set to 0 just before and read
    just after. -> dict of what the run printed and measured."""
    made, timer, epoch_s, eval_ms, slices = {}, StepTimer(), [], [], {}
    real_get_trainer = cli.get_trainer

    def instrumented(config, dataset, model):
        trainer = real_get_trainer(config, dataset, model)
        real_step, real_epoch, real_eval = trainer.step, trainer.train_one_epoch, trainer.evaluator.evaluate
        real_inductive = trainer.inductive_eval

        def step(*batch):
            timer.start()
            loss = real_step(*batch)
            timer.stop(loss)
            return loss

        def epoch():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = real_epoch()
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
            return loss

        def evaluate(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_eval(*args, **kwargs)
            torch.cuda.synchronize()
            eval_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def inductive(*args, **kwargs):
            slices.update(real_inductive(*args, **kwargs))
            return slices

        trainer.step, trainer.train_one_epoch, trainer.evaluator.evaluate = step, epoch, evaluate
        trainer.inductive_eval = inductive
        made["trainer"] = trainer
        return trainer

    printed = io.StringIO()
    cli.get_trainer = instrumented
    try:
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            t0 = time.perf_counter()
            reset_launch_counts()  # the command line's run starts here
            result = cli.main(argv)
            torch.cuda.synchronize()
            launches, routes = spmm_csr_cuda.launches, dict(spmm_csr_cuda.route_launches)  # and ends here
            run_s = time.perf_counter() - t0
    finally:
        cli.get_trainer = real_get_trainer
    trainer = made["trainer"]
    for name in ("step", "train_one_epoch", "inductive_eval"):
        delattr(trainer, name)
    del trainer.evaluator.evaluate
    return {
        "trainer": trainer, "result": result, "line": printed.getvalue().strip().splitlines()[-1],
        "launches": launches, "routes": {k: v for k, v in routes.items() if v}, "run_s": run_s,
        "step_s": list(timer.times), "step_p50_ms": timer.p50_ms, "epoch_s": epoch_s, "evaluate_ms": eval_ms,
        "inductive_ndcg20": {tag: m["NDCG"][20] for tag, m in slices.items()},
        "products_per_get_rep": 1 + n_layers,
    }


def reloaded_test_metrics(trainer, checkpoint):
    trainer._load_model(checkpoint)
    return trainer.eval("test")[1]


def front_door_phase(card, per_step, rng) -> dict:
    """Phase 11: the native graph core, the preprocessing of a raw Gowalla file
    at the published size through the command line, and the Gowalla grid's
    IGCN row run by the command line, its checkpoint reloaded and re-imported
    from the reference's format, and a trace of its steps. ``per_step``: an
    IGCN step's SpMM launches by route (phase 7)."""
    out = {"card": card}
    # (a) the library, built from the port's own copy of the source
    if not native.native_available() or not native.library_path().exists():
        raise AssertionError(f"the native graph core did not build or load ({native.library_path()})")
    log(f"native graph core: {native.library_path().relative_to(REPO)}")
    _, model_cfg, trainer_cfg = grid_row("IGCN")
    with tempfile.TemporaryDirectory(prefix="front_door_") as work:
        # (b) the raw file
        raw_dir = os.path.join(work, "raw")
        os.makedirs(raw_dir)
        raw = os.path.join(raw_dir, "Gowalla_totalCheckins.txt")
        t0 = time.perf_counter()
        write_gowalla_tsv(raw, rng, GOWALLA_USERS, GOWALLA_ITEMS, GOWALLA_CHECKINS)
        out["write_s"], out["raw_bytes"] = time.perf_counter() - t0, os.path.getsize(raw)
        log(f"raw Gowalla file: {GOWALLA_CHECKINS} check-ins of {GOWALLA_USERS} users x {GOWALLA_ITEMS} places, "
            f"{out['raw_bytes']} bytes, written in {out['write_s']:.2f} s")

        # (c) native against plain: the k-core on the whole file's distinct
        # pairs, the parser on a prefix
        t0 = time.perf_counter()
        users, items, ts = native.parse_gowalla_file(raw)
        out["parse_s"] = time.perf_counter() - t0
        if len(users) != GOWALLA_CHECKINS:
            raise AssertionError(f"parsed {len(users)} check-ins of {GOWALLA_CHECKINS}")
        _, u = np.unique(users, return_inverse=True)
        _, i = np.unique(items, return_inverse=True)
        n_u, n_i = int(u.max()) + 1, int(i.max()) + 1
        pairs = np.unique(u * n_i + i)
        t0 = time.perf_counter()
        core = native.kcore_masks(pairs // n_i, pairs % n_i, n_u, n_i, CLI_MIN_INTER)
        out["kcore_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check_equal_arrays("kcore_masks", core, native.kcore_masks_reference(pairs // n_i, pairs % n_i, n_u, n_i,
                                                                             CLI_MIN_INTER))
        out["kcore_plain_s"] = time.perf_counter() - t0
        prefix = os.path.join(work, "prefix.txt")
        with open(raw) as f, open(prefix, "w") as g:
            g.writelines(itertools.islice(f, PARSE_PREFIX_LINES))
        got = native.parse_gowalla_file(prefix)
        check_equal_arrays("parse_gowalla_file", got, native.parse_gowalla_reference(prefix))
        check_equal_arrays("parse_gowalla_file prefix", got, (a[:PARSE_PREFIX_LINES] for a in (users, items, ts)))
        log(f"native = plain: kcore_masks over {len(pairs)} distinct pairs ({int(core[0].sum())} x "
            f"{int(core[1].sum())} kept; native {out['kcore_native_s']:.3f} s, plain {out['kcore_plain_s']:.3f} s); "
            f"parse_gowalla_file on the first {PARSE_PREFIX_LINES} lines (whole file natively in "
            f"{out['parse_s']:.2f} s)")
        del users, items, ts, u, i, pairs

        # (d) the preprocessing, as a user runs it
        out_path = os.path.join(work, *GRID_PATH.split("/"))
        cmd = [sys.executable, "-m", "inductive_recommendation_tpu_torch", "--preprocess", "gowalla", "--data-path",
               raw_dir, "--out-path", out_path, "--min-inter", str(CLI_MIN_INTER), "--split", *map(str, CLI_SPLIT)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=900)
        out["preprocess_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"--preprocess exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        n_users, n_items, split_pairs = split_counts(out_path)
        if (n_users, n_items) != (int(core[0].sum()), int(core[1].sum())):
            raise AssertionError(f"the written split has {n_users} x {n_items}, the {CLI_MIN_INTER}-core "
                                 f"{int(core[0].sum())} x {int(core[1].sum())}")
        train_txt = os.path.join(out_path, "train.txt")
        check_equal_arrays("parse_adjacency_file", native.parse_adjacency_file(train_txt),
                           native.parse_adjacency_reference(train_txt))
        out.update(n_users=n_users, n_items=n_items, split_pairs=split_pairs)
        log(f"--preprocess: {out['preprocess_s']:.2f} s; {proc.stdout.strip()}; {n_users} users x {n_items} items "
            f"after the {CLI_MIN_INTER}-core; pairs {split_pairs}; parse_adjacency_file = plain on train.txt")

        # (e) the grid's IGCN row through the command line, from the work dir
        n_old = (int(0.9 * n_users), int(0.9 * n_items))
        argv = ["--grid", "gowalla", "--index", str(CLI_ROW), "--n-epochs", "1", "--stage", "test",
                "--inductive", *map(str, n_old)]
        cwd = os.getcwd()
        os.chdir(work)
        try:
            run = run_cli(argv, model_cfg["n_layers"])
            cli_check(run, model_cfg, trainer_cfg, per_step, n_users, n_items, work, out)
        finally:
            os.chdir(cwd)
        trainer = run["trainer"]

        # (g) a trace of 10 steps of the run's trainer
        timer, logdir = StepTimer(), os.path.join(work, "trace")
        with trace(logdir):
            for _ in range(TRACE_STEPS):
                timer.start()
                timer.stop(trainer.step())
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        chunks = [e for e in events if e.get("cat") == "kernel" and "spmm_chunk_kernel" in e.get("name", "")]
        if not chunks:
            raise AssertionError("the trace holds no spmm_chunk_kernel launch (spmm_csr_chunks)")
        out["trace"] = {"steps": TRACE_STEPS, "spmm_chunk_kernel_events": len(chunks), "kernel_events":
                        sum(e.get("cat") == "kernel" for e in events), "step_p50_ms": timer.p50_ms}
        log(f"trace of {TRACE_STEPS} steps: {len(chunks)} spmm_chunk_kernel events (launched by spmm_csr_chunks; "
            f"{sum(per_step.values()) // 2 * TRACE_STEPS} expected), {out['trace']['kernel_events']} kernel events; "
            f"StepTimer p50 {timer.p50_ms:.3f} ms")
    return out


def cli_check(run, model_cfg, trainer_cfg, per_step, n_users, n_items, work, out):
    """Phase 11 (e)-(f): the command line's line, launches, training and
    checkpoint, and the checkpoint re-imported from the reference's format."""
    result = run["result"]
    if json.loads(run["line"]) != result:
        raise AssertionError(f"the last printed line {run['line']!r} is not the run's result {result}")
    values = [result[k] for k in ("best_val_ndcg", "test_ndcg@20", "test_recall@20")]
    if not all(isinstance(v, float) and math.isfinite(v) for v in values):
        raise AssertionError(f"the JSON line's values are not finite: {result}")
    trainer = run["trainer"]
    n_steps, n_evals = len(run["step_s"]), len(run["evaluate_ms"])
    if n_steps != trainer.steps_per_epoch:
        raise AssertionError(f"{n_steps} steps ran, one epoch is {trainer.steps_per_epoch}")
    expected = {r: n_steps * k for r, k in per_step.items() if k}
    expected["forward"] = expected.get("forward", 0) + 2 * run["products_per_get_rep"] * n_evals
    if run["routes"] != expected:
        raise AssertionError(f"the run's launches {run['routes']}, expected {expected} ({n_steps} steps x {per_step} "
                             f"+ {2 * run['products_per_get_rep']} a get_rep x {n_evals} evaluations)")
    if not (trainer.save_path and os.path.exists(trainer.save_path)):
        raise AssertionError(f"the best checkpoint {trainer.save_path} does not exist")

    # a fresh model of the same seed: its NDCG at init, then the checkpoint
    dataset = get_dataset({"name": "ProcessedDataset", "path": GRID_PATH})
    config = dict(trainer_cfg, seed=CLI_SEED, n_epochs=1)
    fresh = get_trainer(config, dataset, get_model(model_cfg, dataset))
    init_ndcg = fresh.eval("val")[1]["NDCG"][20]
    if not result["best_val_ndcg"] > init_ndcg:
        raise AssertionError(f"best val NDCG@20 {result['best_val_ndcg']} does not beat the random-init {init_ndcg}")

    def same_test_metrics(metrics, what):
        for key, name in (("test_ndcg@20", "NDCG"), ("test_recall@20", "Recall")):
            if abs(metrics[name][20] - result[key]) > 1e-6:
                raise AssertionError(f"{what}: test {name}@20 {metrics[name][20]} != the run's {result[key]}")

    same_test_metrics(reloaded_test_metrics(fresh, trainer.save_path), "the reloaded best checkpoint")

    # (f) the model in the reference's format (model.py:4208-4220), imported
    model, params = trainer.model, trainer.params
    pth, ckpt = os.path.join(work, "igcn_reference.pth"), os.path.join(work, "igcn_imported.ckpt")
    torch.save({
        "sate_dict": {"embedding.weight": params["embedding"].detach().cpu(), "w": params["w"].detach().cpu()},
        "user_map": {int(u): int(c) for u, c in enumerate(model.user_map) if c >= 0},
        "item_map": {int(i): int(c) for i, c in enumerate(model.item_map) if c >= 0},
        "alpha": float(model.alpha),
    }, pth)
    import_reference_checkpoint(pth, ckpt, n_users=model.n_users, n_items=model.n_items)
    imported = get_trainer(config, dataset, get_model(model_cfg, dataset))
    same_test_metrics(reloaded_test_metrics(imported, ckpt), "the reference-format checkpoint imported")

    p50 = statistics.median(run["step_s"]) * 1e3
    out["cli"] = {
        "argv_inductive": [int(0.9 * n_users), int(0.9 * n_items)], "line": result, "run_s": run["run_s"],
        "epoch_s": run["epoch_s"], "steps": n_steps, "step_ms_median": p50,
        "examples_per_s": trainer.batch_size / p50 * 1e3, "evaluate_ms": run["evaluate_ms"],
        "val_ndcg20_init": init_ndcg, "inductive_ndcg20": run["inductive_ndcg20"], "launches": run["launches"],
        "route_launches": run["routes"],
    }
    log(f"command line, {CLI_ROW}: {result['model']} + {result['trainer']} on {n_users} x {n_items}: run "
        f"{run['run_s']:.2f} s; epoch {run['epoch_s']} s, {n_steps} steps, step median {p50:.3f} ms "
        f"({out['cli']['examples_per_s']:.0f} examples/s); evaluate ms {[round(t, 1) for t in run['evaluate_ms']]}; "
        f"val NDCG@20 {init_ndcg:.6f} at init -> best {result['best_val_ndcg']:.6f}; launches {run['launches']} "
        f"{run['routes']}; the reloaded checkpoint and the reference-format import give the test metrics "
        f"{result['test_ndcg@20']:.6f} / {result['test_recall@20']:.6f}")
    for tag, ndcg in run["inductive_ndcg20"].items():
        log(f"  inductive NDCG@20 {tag}: {ndcg:.6f}")


def main():
    # 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false")
    card = nvidia_smi_name_power()
    log(card)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}; "
        f"fp32 matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )
    rng = np.random.default_rng(SEED)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # the Gowalla-scale set and the model: graph layouts and random weights
    t0 = time.perf_counter()
    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=SEED)
    model = get_model(IGCN_CONFIG, ds)
    d = IGCN_CONFIG["embedding_size"]
    params = params_from_jax(
        model,
        {
            "embedding": rng.normal(0.0, 0.1, (model.feat_n_cols, d)).astype(np.float32),
            "w": np.ones(d, np.float32),
        },
    )
    log(
        f"set-up: {time.perf_counter() - t0:.2f} s; {len(ds.train_array)} train pairs; "
        f"adjacency {model.norm_adj.shape} nnz {model.norm_adj.nnz}; "
        f"feature matrix {model.feat.shape} nnz {model.feat.nnz}"
    )

    # 3. kernel against its plain version, at the shapes the serving path gives it
    max_err = check_kernel_edge_cases(rng)
    with torch.no_grad():
        emb = params["embedding"][: model.feat_n_cols]
        feat_row = measure_spmm("feat", model.feat, emb)
        adj_row = measure_spmm("adj", model.norm_adj, spmm_csr_cuda(model.feat, emb))
    max_err = max(max_err, feat_row["max_abs_err"], adj_row["max_abs_err"])

    # 4. the slice: get_rep against the plain SpMM chain, and its times
    rep = model.make_scoring_state(params)
    with torch.no_grad():
        rep_err = close(rep, plain_rep(model, params), "get_rep vs the plain SpMM chain")
    if rep.shape != (ds.n_users + ds.n_items, d) or not torch.isfinite(rep).all():
        raise AssertionError(f"get_rep: shape {tuple(rep.shape)} or non-finite values")
    log(f"get_rep vs the plain SpMM chain: max abs err {rep_err:.3g}")
    get_rep_ms = median_ms(lambda: model.make_scoring_state(params), reps=20)
    (get_rep_windowed_ms,) = windowed_ms(lambda: model.make_scoring_state(params))
    ev = Evaluator(ds, topks=TOPKS, test_batch_size=TEST_BATCH)

    spmm_csr_cuda.launches = 0  # the serving path starts here
    per_call = []

    def counted(fn):
        before = spmm_csr_cuda.launches
        out = fn()
        per_call.append(spmm_csr_cuda.launches - before)
        return out

    eval_first_ms = host_ms(lambda: counted(lambda: ev.evaluate(model, params, "test")), 1)[0]
    results, metrics = counted(lambda: ev.evaluate(model, params, "test"))
    check_metrics(metrics, "evaluate")
    log(f"evaluate test: {results}")
    rec = counted(lambda: ev.recommend(model, params, "test"))
    check_recommend(ds, rec)
    log(f"recommend test: shape {rec.shape}; users 0-2: {rec[:3, :10].tolist()}")
    oracle = calculate_metrics(ds.test_data, rec, TOPKS)
    for name in ("Precision", "Recall", "NDCG"):
        if abs(oracle[name][20] - metrics[name][20]) > 1e-6:
            raise AssertionError(f"{name}@20: device {metrics[name][20]} vs host oracle {oracle[name][20]}")
    model.feat_mat_anneal()
    results_annealed, metrics_annealed = counted(lambda: ev.evaluate(model, params, "test"))
    check_metrics(metrics_annealed, "evaluate after anneal")
    log(f"evaluate test after one anneal (alpha {model.alpha}): {results_annealed}")

    # 5. inductive: new users and items get representations without retraining
    n_old_users, n_old_items = ds.n_users, ds.n_items
    grown = grown_dataset(ds, rng)
    model.attach_dataset(grown)
    ev_grown = Evaluator(grown, topks=TOPKS, test_batch_size=TEST_BATCH)
    slices = ev_grown.inductive_eval(model, params, n_old_users, n_old_items, verbose=False)
    launches = spmm_csr_cuda.launches  # the serving path ends here
    n_get_rep = len(per_call) + len(slices)
    for tag, m in slices.items():
        check_metrics(m, tag)
        log(f"inductive NDCG@20 {tag}: {m['NDCG'][20]:.6f}")
    # each get_rep is 1 feat + n_layers adj products, each the same count of launches
    n_products = n_get_rep * (1 + IGCN_CONFIG["n_layers"])
    per_rep, launches_per_product = launches // n_get_rep, launches // n_products
    if launches == 0 or launches != launches_per_product * n_products or per_call != [per_rep] * len(per_call):
        raise AssertionError(f"spmm_csr launches: {per_call} per call, {launches} for {n_get_rep} get_rep")
    log(
        f"spmm_csr launches on the serving path: {launches} over {n_get_rep} get_rep ({per_rep} each, "
        f"{launches_per_product} per product)"
    )

    # 6. times, after the counted run: the model now serves the grown set
    eval_ms = host_ms(lambda: ev_grown.evaluate(model, params, "test"), 3)
    log(
        f"times on {card}: get_rep {get_rep_ms:.3f} ms (median of 20 single calls; {get_rep_windowed_ms:.3f} ms "
        f"in windows of 10 calls), {ds.n_users} users x {ds.n_items} items; "
        f"evaluate test {eval_first_ms:.1f} ms (first call, same set); evaluate test on the grown set "
        f"({grown.n_users} x {grown.n_items}), warm: {[round(t, 1) for t in eval_ms]} ms"
    )
    breakdown = device_breakdown(lambda: ev_grown.evaluate(model, params, "test"))
    if breakdown is None:
        log("evaluate under torch.profiler: no device activity recorded; breakdown not measured")
    else:
        host, busy, kernels, n_spans = breakdown
        log(
            f"evaluate test on the grown set under torch.profiler: host {host:.1f} ms, "
            f"device busy {busy:.1f} ms ({100.0 * busy / host:.1f}%), {n_spans} device launches, by device time:"
        )
        for name, ms, n in kernels:
            log(f"  {ms:9.3f} ms {n:5d}x  {name[:100]}")

    # 7. train, on a fresh model of the Gowalla-scale set: the kernel's
    # training uses at its layouts, then IGCNTrainer
    trainer = get_trainer(TRAINER_CONFIG, ds, get_model(IGCN_CONFIG, ds))
    train_rows = check_training_kernels(
        trainer.model, trainer.params["embedding"][: trainer.model.feat_n_cols].detach(), rng
    )
    max_err = max(max_err, *(train_rows[k]["max_abs_err"] for k in ("transpose", "transpose_dropout", "dropout")))
    train = train_and_check(trainer, card, n_products=2 * (1 + IGCN_CONFIG["n_layers"]))
    log("train: " + json.dumps(train))

    # one get_rep = 1 product with the feature matrix + n_layers with the adjacency
    n_layers = IGCN_CONFIG["n_layers"]

    def per_get_rep(key):
        return feat_row[key] + n_layers * adj_row[key]

    kernel = {
        "name": "spmm_csr",
        "route": "cuda",
        "source": "inductive_recommendation_tpu_torch/ops/csrc/spmm_csr.cu",
        "replaces": "inductive_recommendation_tpu/ops/pallas_spmm.py:35",
        "launches": launches,
        "launches_per_product": launches_per_product,
        "max_abs_err": max_err,
        "ms": per_get_rep("ms"),
        "plain_ms": per_get_rep("plain_ms"),
        "bound_ms": per_get_rep("bound_ms"),
        "bound_by": "bytes" if feat_row["bound_by"] == adj_row["bound_by"] == "bytes" else "operations",
        "library_ms": per_get_rep("library_ms"),
        "ms_windowed": per_get_rep("ms_windowed"),
        "plain_ms_windowed": per_get_rep("plain_ms_windowed"),
        "library_ms_windowed": per_get_rep("library_ms_windowed"),
        "per": f"one get_rep: 1 feat + {n_layers} adj products; *_ms: median of single calls, "
        "*_ms_windowed: median of windows of 10 back-to-back calls",
        "launches_per_step": train["launches_per_step"]["forward"],
        "detail": [feat_row, adj_row],
    }
    routes = train["route_launches_train_run"]

    def entry(name, row, launches, per_step, per, detail):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_windowed", "plain_ms_windowed",
                "library_ms_windowed", "max_abs_err")
        return {
            "name": name,
            "route": "cuda",
            "source": "inductive_recommendation_tpu_torch/ops/csrc/spmm_csr.cu",
            "replaces": "inductive_recommendation_tpu/ops/pallas_spmm.py:35",
            "launches": launches,
            "launches_per_step": per_step,
            **{k: row[k] for k in keys},
            "per": per,
            "detail": detail,
        }

    transpose = entry(
        "spmm_csr_transpose", train_rows["transpose_dropout"],
        routes["transpose"] + routes["transpose_dropout"],
        train["launches_per_step"]["transpose"] + train["launches_per_step"]["transpose_dropout"],
        "the backward of the feature product: feat^T @ g on the transpose CSR under the step's dropout "
        f"(p {IGCN_CONFIG['dropout']}); library_ms: torch.sparse.mm on the transpose CSR with the mask in its values",
        [train_rows["transpose_dropout"], train_rows["transpose"]],
    )
    dropout = entry(
        "spmm_csr_dropout", train_rows["dropout"], routes["forward_dropout"],
        train["launches_per_step"]["forward_dropout"],
        f"the forward feature product with in-kernel edge dropout (p {IGCN_CONFIG['dropout']}); library_ms: "
        "torch.sparse.mm on a CSR with the mask folded into its values (the mask's cost is outside it)",
        [train_rows["dropout"]],
    )
    transpose["grad_max_abs_err"] = train_rows["grad_err"]

    # 8. DOSE on the same set
    dose = dose_phase(ds, card, rng)
    log("dose: " + json.dumps({k: v for k, v in dose.items() if k != "view_row"}))
    max_err = max(max_err, dose["view_row"]["max_abs_err"])
    dose_routes = dose["train"]["route_launches_train_run"]
    view = entry(
        "spmm_csr_view", dose["view_row"], dose_routes["view"], dose["train"]["launches_per_step"]["view"],
        f"one product with a DOSE_aug view CSR (the train graph plus the {DOSE_CONFIG['aug_num']} selected pairs, "
        "symmetric: forward and backward on the same layout); launches: DOSE_aug's training run, on the view",
        [dose["view_row"]],
    )

    # 9. the grid's baselines on the same set
    zoo = zoo_phase(ds, card, rng)
    log("zoo: " + json.dumps(zoo["models"]))
    zrows, zmodels = zoo["rows"], zoo["models"]
    max_err = max(max_err, *(row["max_abs_err"] for row in zrows.values()))
    ngcf_run, knn = zmodels["NGCF"]["route_launches_run"], zmodels["ItemKNN"]
    zoo_entries = [
        entry("spmm_csr_ngcf_dropout", zrows["ngcf_dropout"], ngcf_run["forward_dropout"],
              zmodels["NGCF"]["launches_per_step"]["forward_dropout"],
              "one NGCF layer's product: the self-loop row-L1 A + I under edge dropout (p 0.1, one mask a step); "
              "launches: NGCF's epoch and evaluate", [zrows["ngcf_dropout"]]),
        entry("spmm_csr_ngcf_transpose_dropout", zrows["ngcf_transpose_dropout"], ngcf_run["transpose_dropout"],
              zmodels["NGCF"]["launches_per_step"]["transpose_dropout"],
              "its backward: (A + I)^T @ g on the transpose CSR under the same mask", [zrows["ngcf_transpose_dropout"]]),
        entry("spmm_csr_imcgae_padded", zrows["imcgae"], zmodels["IMCGAE"]["route_launches_run"]["forward"],
              zmodels["IMCGAE"]["launches_per_step"]["forward"],
              "one IMCGAE layer's product: the sym-normalized adjacency on the compact operand padded from "
              "d + 3 = 67 to 68 columns (ms_unpadded: the same at 67, the kernel's scalar path); launches: "
              "IMCGAE's epoch and evaluate, forward and backward", [zrows["imcgae"]]),
        entry("spmm_csr_idcf_feat", zrows["idcf_feat"], zmodels["IDCF_LGCN"]["route_launches_run"]["forward"],
              zmodels["IDCF_LGCN"]["launches_per_step"]["forward"],
              "IDCF's rectangular 0/1 feat @ the frozen table (no gradient); launches: IDCF's epoch and evaluate, "
              "feat (2 a step) and the adjacency (12 a step) alike", [zrows["idcf_feat"]]),
        entry("spmm_csr_itemknn_rt_block", zrows["itemknn_rt"], knn["build_launches"], None,
              "one block of ItemKNN's similarity build: R^T (items x users) @ the block's 512 user columns; "
              "launches: the build", [zrows["itemknn_rt"]]),
        entry("spmm_csr_itemknn_sim_t", zrows["itemknn_sim_t"], knn["evaluate_launches"], None,
              "ItemKNN's scoring S^T @ profiles^T at d 512, the whole S^T (the plain version and the float64 "
              "check block of rows by block of rows); launches: ItemKNN's evaluate",
              [zrows["itemknn_sim_t"]]),
    ]

    # 10. the last four models on the same set
    last = last_models_phase(ds, card, rng)
    log("last models: " + json.dumps(last["models"]))
    lrows, lmodels = last["rows"], last["models"]
    max_err = max(max_err, *(lrows[k]["max_abs_err"] for k in (
        "attention", "attention_transpose", "sgl_view", "aug_feat_dropout", "aug_feat_transpose_dropout")))
    att_run, aug2_run = lmodels["AttIGCN"]["route_launches_run"], lmodels["DOSE_aug2"]["route_launches_run"]
    last_entries = [
        entry("spmm_csr_attention", lrows["attention"], att_run["attention"],
              lmodels["AttIGCN"]["launches_per_step"]["attention"],
              f"AttIGCN's aggregation: the feature matrix's structure with the {ATT_CONFIG['n_heads']}-head attention "
              "as edge values @ the table (spmm_csr_values); library_ms: torch.sparse.mm with the attention folded "
              "into its values; launches: AttIGCN's epoch and evaluate", [lrows["attention"]]),
        entry("spmm_csr_attention_transpose", lrows["attention_transpose"], att_run["attention_transpose"],
              lmodels["AttIGCN"]["launches_per_step"]["attention_transpose"],
              "its backward d(table): the transpose CSR with the attention gathered into its edge order",
              [lrows["attention_transpose"]]),
        entry("spmm_csr_aug_feat_dropout", lrows["aug_feat_dropout"], aug2_run["aug_feat"],
              lmodels["DOSE_aug2"]["launches_per_step"]["aug_feat"],
              f"DOSE_aug2's view input: the augmented feature matrix (train + the {DOSE_AUG2_CONFIG['aug_num']} "
              f"selected pairs, rebuilt each epoch) under in-kernel dropout (p {DOSE_AUG2_CONFIG['dropout']}); "
              "launches: DOSE_aug2's epoch and evaluate", [lrows["aug_feat_dropout"]]),
        entry("spmm_csr_aug_feat_transpose_dropout", lrows["aug_feat_transpose_dropout"],
              aug2_run["aug_feat_transpose"], lmodels["DOSE_aug2"]["launches_per_step"]["aug_feat_transpose"],
              "its backward on the transpose CSR under the same mask", [lrows["aug_feat_transpose_dropout"]]),
    ]
    last_entries[0].update(d_values_max_abs_err=lrows["d_values_max_abs_err"],
                           step_peak_bytes=lmodels["AttIGCN"]["step_peak_bytes"])
    view["detail"].append(lrows["sgl_view"])

    # 11. the front door: the raw file, the preprocessing and the grid's IGCN
    # row through the command line
    front = front_door_phase(card, {r: k for r, k in train["launches_per_step"].items() if k}, rng)
    log("front door: " + json.dumps(front))
    kernel.update(launches_cli=front["cli"]["launches"], route_launches_cli=front["cli"]["route_launches"])
    print(json.dumps({"kernels": [kernel, transpose, dropout, view, *zoo_entries, *last_entries]}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
