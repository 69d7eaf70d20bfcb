#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``inductive_recommendation_tpu_torch``) on one
CUDA card: the IGCN serving and training paths, DOSE training, every grid
model at full width through the port's CUDA kernel, the front door (a raw
dataset preprocessed and a grid row run by the command line) and the
multi-GPU layer at world 1 (``chip_mesh.py`` runs it across cards).

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
   ``torch.profiler`` (device time by kernel, device busy share).
   Then the evaluation's metric-sums kernel (``ops/csrc/metric_sums.cu``,
   ``metric_sums_phase``) at the eval's shape (512 users, top 100, 21
   cutoffs; ground-truth rows of 512 sorted, the binary search, and of 256
   unsorted, the staged compare) and on edge cases (a batch not a multiple
   of a block's users, cutoffs over K, one cutoff, 64 cutoffs over K 300):
   its sums against the plain version on the card (within 1e-5 of max(1,
   |sum|)) and on the CPU (within 1e-6), the valid count exactly, two
   launches bitwise; no synchronisation in the call
   (``torch.cuda.set_sync_debug_mode("error")``), the wrapper's count two
   launches a call; its time (single, windowed, device) beside the plain
   version's and the byte bound; and its launches in an ``evaluate``.
   Then the evaluation's masked top-k kernel (``ops/csrc/masked_topk.cu``,
   ``masked_topk_phase``) on edge cases (k 1 and 128, k = n_items, an odd
   n_items, ties at the k-th place few and over 2,048, fewer
   eligible items than k, a row of -inf, rows cut in chunks) and at the
   eval's shape (512 rows x 40,981 items, k 100, exclusion widths 64, 256
   and 1,024, a banned range) and Amazon-Book's 91,599 items (two
   launches): values equal to the plain path's (``mask_scores`` +
   ``torch.topk``), ids to a stable descending sort's, two calls bitwise;
   no synchronisation, the wrapper's count, its time (single, windowed,
   device) beside the plain path's and the byte bound; one launch a batch
   in an ``evaluate``;
7. train: IGCN's training path on a fresh model. First its trainer's two
   samplers through the BPR draw's kernel (``ops/csrc/bpr_sample.cu``,
   ``sampler_phase``): each draw bitwise the plain torch ops' on the card
   from a clone of the same generator state (B 2,048 at neg_ratio 1 and 4,
   B 1 and 333, three seeds), no synchronisation in a draw, one launch
   counted a draw, and the draw's time (single, windowed, the host's
   enqueue) beside the plain version's and the wrapper's device switch
   alone, with the kernel's device time and its byte bound. (a) On the
   Gowalla-scale
   layouts, the kernel against its plain version: the transpose product, the
   dropout product (p 0.3) forward and transpose, and the gradient of the
   embedding through the autograd Function against autograd through the
   plain version; the edges the kernel keeps are exactly those of
   ``edge_uniform``, the keep rate is within 4 binomial sigma of 0.7, and the
   same seed gives the same bits. (b) ``get_trainer`` on the grid's IGCN
   config for 2 epochs: the loss falls, val NDCG@20 beats the random-init
   model's, and the reloaded best checkpoint has alpha = 0.99^k and the same
   metrics; the run draws 2 batches a step through the sampler's kernel
   (``STEP_DRAWS``). (c) One step is 16 launches (8 products) and those 2
   draws: the eager step after the reload, the captured one and a replay,
   each counted alone. (d) Step time (single
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
   the others 0), draws through the sampler's kernel a step in the run and
   in one step (``STEP_DRAWS``: MultiVAE 0, the others 1), step ms (single and windowed), examples/s, one profiled
   step, epoch s, ``evaluate`` ms and users/s;
10. the last four models on the same set, one epoch each, with the checks,
   counts and times of phase 9 (b) (``STEP_LAUNCHES``; AttIGCN's step
   counted as an eager, a captured and a replayed one). (a) AttIGCN at
   IGCN's grid width (4 heads) with the IGCN row's trainer: the attention
   kernels of ``ops/csrc/attention_csr.cu`` on small edge cases (runs of
   empty rows, rows cut across many chunks, the 12,745-edge row, rows cut
   exactly at chunk ends, a run of one-edge rows, a row of -inf scores, 1-8
   heads, the 16-byte and the scalar widths and alignments) and on its
   feature matrix, each against its float64 plain version and bitwise
   repeatable, timed beside the plain version and the library call
   (``sddmm_csr`` with 4 heads, the scores, entry by entry within
   ``check_sddmm``'s rounding bound, beside ``torch.sparse.sampled_addmm``
   batched over the heads; with one head, d(values), beside the same call
   unbatched; ``sddmm_csr_backward``, the scores' gradient, entry by entry
   within ``check_product``'s bound at its chunking, beside
   ``torch.sparse.mm`` once a head and the path it replaced, one SpMM a
   head on [table | 1 | 0 0 0] with a cat and a stack; the softmax passes
   ``softmax_stats`` (m exactly, s within 1e-5 of max(1, s) a row),
   ``softmax_apply`` (within 1e-5 * max(1, max |float64|)) and their
   backward modes (c likewise, g_s within 1e-5 of max |float64|), each
   timed alone; ``segment_softmax_csr``, the two passes, beside
   ``segment_softmax``, and its backward beside autograd's), the
   product with the model's attention as edge values and its transpose
   against float64, d(values) within 1e-5 of max |float64|, ``get_rep``
   against the float64 plain chain; the attention's device time alone with
   the kernels and with the plain torch ops; the epoch, then the same epoch
   on the same batches with the plain torch-ops attention (losses within
   1e-5, step times, one profiled step, peak memory of a step for both).
   (b) SGL and HALF at
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
   ``utils.profiling.trace`` of 10 steps holds ``spmm_chunk_kernel`` events
   and one ``irt.train.step`` span a step.
   Step median, examples/s, epoch s, ``evaluate`` ms and the six inductive
   NDCG@20 are logged.
12. the multi-GPU layer (``parallel/``) over NCCL on the same set. (a) The
   process joins an NCCL group of one rank (one process holds one card;
   NCCL refuses two ranks on one card)
   over a file store in phase 11's directory, and a ('data', 'model') mesh
   of (1, world). (b) A 4-way column split of the adjacency and of the
   feature matrix (``build_edge_sharded_spmm``): every shard's CSR (over
   the rows its edges span) and transpose through the kernel, the forward
   partials placed at those rows and summed in shard order
   against the float64 plain product (``check_product``'s bound plus 3
   roundings), the transposes' rows against the whole transpose, both
   also under dropout 0.3, where the shards' kept edges together are
   exactly ``edge_uniform``'s on the whole matrix; each shard product's
   time, byte bound and ``torch.sparse.mm`` on the same shard. (c)
   ``IGCNTrainer`` in edge mode trains IGCN (the grid width, batch 2,048)
   for one epoch at mesh (1, world): its first 20 losses equal a single-device
   ``IGCNTrainer`` of the same seed within 1e-5 (same batches, same dropout
   masks), val NDCG@20 beats the random-init model's, its launches are all
   on the ``edge_shard`` routes and one step is 16 launches and 4
   reduce-scatters, 4 all-gathers and 2 all-reduces; (d) the best
   checkpoint, loaded by a single-device trainer, gives the mesh
   evaluator's test metrics within 1e-6, and ``recommend`` and
   ``sharded_recommend_all_users`` equal the single-device lists up to
   ties; then the step's times, examples/s and one profiled step with the
   NCCL kernels' device time. (e) A data-mode ``IGCNTrainer`` runs 50 steps
   with the single-device trainer's losses within 1e-5. (f) ``torchrun
   --standalone --nproc_per_node <cards> -m inductive_recommendation_tpu_torch
   --grid gowalla --index 2 --mesh 1,<cards> --mesh-mode edge --n-epochs 1
   --stage test`` in a subprocess in phase 11's directory: its JSON line is
   finite and its launches by route (printed by rank 0) are exactly 16 a
   step + 8 a ``get_rep`` on the ``edge_shard`` routes.
13. the rest of the multi-GPU layer over phase 12's group, on the same set,
   each family at its grid width. (a) DOSE_aug, DOSE_aug2, SGL, HALF, NGCF,
   IMCGAE, IDCF_LGCN (over a frozen table drawn from the seed) and AttIGCN
   (4 heads): 20 steps of the single-device trainer, then of a data-mode and
   of an edge-mode trainer of the same seed on the same model, each loss
   within 1e-5 of the single-device one (dropout on: the same batches,
   masks and views), and the edge run's first step's gradients of every
   parameter within 1e-5 of the parameter's largest single-device one (the
   key biases, whose gradient is 0 in exact arithmetic, below 1e-6 of the
   largest gradient); the edge run's launches all on ``edge_shard`` routes,
   by route and its collectives by kind, one step's, the step's time; the
   edge trainer's ``evaluate`` equal to the host oracle on its ``recommend``
   within 1e-6. For DOSE_aug, DOSE_aug2, SGL and HALF the epoch end (the
   anneal, the views' regeneration and their re-shard on the device) timed,
   the shards holding the new views' edges, DOSE_aug2's augmented feature
   shard made, and 2 more steps. (b) 20 data-mode steps of DOSEdropTrainer
   (DOSE_drop3), DOSEtestTrainer (DOSE_test), BCETrainer (NeuMF) and
   MLTrainer (MultiVAE) against the single-device trainer. (c) On one card,
   a 4-way split of the selected DOSE_aug view and of DOSE_aug2's augmented
   feature matrix (under dropout 0.3) cut on the device, the partials summed
   against the whole product (``check_product``'s bound plus 3 roundings)
   and the shards' transposes against the whole transpose; AttIGCN's
   attention over a 4-way split of the feature matrix, the shards'
   statistics passes combined (the maxima, the sums rescaled to them and
   added) and their apply passes, edge by edge within 1e-5 of the
   single-device attention, and the partial products with it as edge values
   against the whole one; shard 0's times for each. AttIGCN's edge losses
   are the single-device trainer's bit for bit where the shard's CSR is the
   whole attention layout (world 1), else within 6e-8, and its edge run
   launches every softmax pass on the ``edge_shard_attention`` route.
14. the training step replayed as one CUDA graph (``train/step_graph.py``)
   against the same steps run eagerly: IGCN, DOSE_aug and AttIGCN (4 heads)
   at their grid widths on the Gowalla-scale set, and IMF and every other
   DOSE variant on a 3,000 x 4,000 set of 40,000 interactions (batch 256),
   each trained twice for an epoch and a half from its seed (an anneal and
   a view rebuild inside), once replayed and once with its graph taken
   away: the step losses and the parameters equal bit for bit, the launches
   by route and the sampler's draws equal, the peak device memory of each;
   for the first three, the step's time both ways (median of single steps
   and of windows of 10) and one profiled step each, in which the profiler
   must record as many ``spmm_chunk_kernel`` launches for the replay as for
   the eager step.

The counts of kernel launches are set to 0 just before phases 4-5 drive the
serving path and read just after, and again around the training runs of
phases 7 and 8, each model's run in phases 9 and 10, the command line's
run of phase 11, the edge-mode epoch of phase 12 and each edge-mode run of
phase 13. The last lines are
one JSON object of kernel numbers and then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
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
import torch.distributed as dist

from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch import main as cli
from inductive_recommendation_tpu_torch import native
from inductive_recommendation_tpu_torch.configs import get_gowalla_config
from inductive_recommendation_tpu_torch.data import (
    AuxiliaryDataset,
    BasicDataset,
    build_sampler_state,
    get_dataset,
    quick_synthetic_dataset,
    sampling,
)
from inductive_recommendation_tpu_torch.eval import Evaluator, calculate_metrics
from inductive_recommendation_tpu_torch.eval import device_metrics
from inductive_recommendation_tpu_torch.graph import build_feat_matrix, sym_normalized_adjacency
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
from inductive_recommendation_tpu_torch.models import att_igcn
from inductive_recommendation_tpu_torch.models.base import linear
from inductive_recommendation_tpu_torch.ops import attention_csr
from inductive_recommendation_tpu_torch.ops import topk as topk_ops
from inductive_recommendation_tpu_torch.ops.attention_spmm import folded_query, fused_kv_attention_reference
from inductive_recommendation_tpu_torch.ops.csr_spmm import EDGES_PER_CHUNK, dropout_values
from inductive_recommendation_tpu_torch.ops.csr_spmm import reset_launch_counts as reset_spmm_counts
from inductive_recommendation_tpu_torch.ops.spmm import segment_softmax
from inductive_recommendation_tpu_torch.parallel import (
    build_edge_sharded_spmm,
    init_distributed,
    make_mesh,
    reset_collective_counts,
    sharded_recommend_all_users,
)
from inductive_recommendation_tpu_torch.parallel.attention import shard_apply, shard_scores, shard_stats
from inductive_recommendation_tpu_torch.parallel.collectives import counts as collective_counts
from inductive_recommendation_tpu_torch.parallel.spmm import place_rows, shard_csr, values_shard
from inductive_recommendation_tpu_torch.train import bpr_loss, save_checkpoint
from inductive_recommendation_tpu_torch.train.import_reference import import_reference_checkpoint
from inductive_recommendation_tpu_torch.utils import trace
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
    # the adjacency's 3 + 3; the query's feat product; the aggregation and
    # its backward; the attention kernels: the scores, their gradient (chunks
    # and cut rows), d(values), the softmax's statistics (chunks and cut
    # rows) and apply passes, forward and backward
    "AttIGCN": {"forward": 12, "attention_query": 2, "attention": 2, "attention_transpose": 2,
                "sddmm_csr/attention": 1, "sddmm_csr_backward/attention": 2, "sddmm_csr/attention_d_values": 1,
                "softmax_stats/attention": 2, "softmax_apply/attention": 1, "softmax_stats_backward/attention": 2,
                "softmax_apply_backward/attention": 1},
    "SGL": {"forward": 12, "view": 24},
    "HALF": {"forward": 12, "view": 12},
    # DOSE_aug's 32, the view's feature products on the augmented matrix
    "DOSE_aug2": {"forward": 12, "forward_dropout": 2, "transpose_dropout": 2, "view": 12, "aug_feat": 2,
                  "aug_feat_transpose": 2},
}
# BPR draws through the sampler's kernel a training step
# (``sample_bpr_batch_cuda.launches``): the IGCN family draws the main batch
# and the auxiliary one, MultiVAE's MLTrainer takes its batches from the host
STEP_DRAWS = {
    "IGCN": 2, "DOSE_aug": 2, "DOSE_aug2": 2, "AttIGCN": 2,
    "MF": 1, "NGCF": 1, "IMCGAE": 1, "IDCF_LGCN": 1, "NeuMF": 1, "SGL": 1, "HALF": 1,
    "MultiVAE": 0,
}
# phase 14: the training step replayed as one CUDA graph against the same
# steps run eagerly, from the same weights, batches and seeds: an epoch and
# a half (an epoch end inside) of each train cell's model on the
# Gowalla-scale set, and of the IGCN family's other models on a small set
GRAPH_MODELS = (("IGCN", IGCN_CONFIG, TRAINER_CONFIG), ("DOSE_aug", DOSE_CONFIG, DOSE_TRAINER_CONFIG),
                ("AttIGCN", ATT_CONFIG, TRAINER_CONFIG))
GRAPH_FAMILY = ("IMF", "DOSE_aug2", "DOSE_aug3", "DOSE_aug4", "DOSE_drop", "DOSE_drop2", "DOSE_drop3", "TEST",
                "TEST2", "DOSE_aug_drop", "DOSE_aug_drop2", "DOSE_aug_drop3", "DOSE_test")
GRAPH_SMALL_SET = (3000, 4000, 40_000)  # users, items, interactions
GRAPH_SMALL_BATCH = 256
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
# phase 12: the multi-GPU layer; a 4-way split of the Gowalla-scale layouts
# held against the whole product, the edge-mode losses compared with the
# single-device trainer's for 20 steps, data mode's for 50
SHARDS = 4
MESH_STEPS_COMPARED = 20
DATA_MODE_STEPS = 50
# phase 13: the families in edge mode (the first four also through an epoch
# end), the trainers in data mode, steps held to the single-device trainer
EDGE_FAMILIES = ("DOSE_aug", "DOSE_aug2", "SGL", "HALF", "NGCF", "IMCGAE", "IDCF_LGCN", "AttIGCN")
EPOCH_END_FAMILIES = ("DOSE_aug", "DOSE_aug2", "SGL", "HALF")
DATA_ONLY_FAMILIES = ("DOSE_drop3", "DOSE_test", "NeuMF", "MultiVAE")
FAMILY_STEPS = 20
# parameters whose gradient is 0 in exact arithmetic (AttIGCN's and IDCF's
# key biases add one score to every key of a row, which the softmax does
# not see): fp32 noise on both sides, held below 1e-6 of the largest
# gradient instead of to each other
ZERO_GRADS = ("weight_k.b", ".wk.b")
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
# operations of one (edge, head) entry of the row softmax (a compare, two
# subtractions, divisions and exponentials, an add, the division by the sum
# and the head mean's add), each counted as one at the fp32 rate; its
# backward's (two multiply-adds, a subtraction, a division) likewise. The
# statistics pass takes the compare, a subtraction, a division, an
# exponential and an add of them, the apply pass the rest; backward a
# multiply-add and the rest
SOFTMAX_OPS_PER_ENTRY = 10
SOFTMAX_BACKWARD_OPS_PER_ENTRY = 5
SOFTMAX_STATS_OPS_PER_ENTRY, SOFTMAX_APPLY_OPS_PER_ENTRY = 5, 5
SOFTMAX_STATS_BACKWARD_OPS_PER_ENTRY, SOFTMAX_APPLY_BACKWARD_OPS_PER_ENTRY = 2, 3
# the kernels of the softmax passes and of the scores and their gradient, by
# the names the profiler gives them
SOFTMAX_KERNEL_NAMES = ("softmax_stats_chunk_kernel", "softmax_stats_carry_kernel", "softmax_apply_kernel")
SDDMM_KERNEL_NAMES = ("sddmm_vec_kernel", "sddmm_scalar_kernel", "sddmm_bwd_chunk_kernel", "sddmm_bwd_carry_kernel")
# phase 13: AttIGCN's edge losses at world 1 are the single-device trainer's
# bit for bit where the shard's CSR is the whole layout, else within this
# (the largest difference any family's edge run has shown)
ATT_EDGE_LOSS_TOL = 6e-8
REL_TOL = 1e-5
# the port's own kernels, by the names the profiler gives them
OWN_KERNELS = ("spmm", "sddmm", "softmax")
U_FP32 = 2.0**-24  # fp32's unit roundoff


def log(*args):
    print(*args, flush=True)


def reset_launch_counts():
    """Every kernel's launch counts to 0: the SpMM's, the attention kernels',
    the metric sums', the masked top-k's and the BPR draw's."""
    reset_spmm_counts()
    attention_csr.reset_launch_counts()
    device_metrics.batch_metric_sums_cuda.launches = 0
    topk_ops.masked_topk_cuda.launches = 0
    sampling.sample_bpr_batch_cuda.launches = 0


def launches_by_route() -> dict:
    """The launches since the last reset, by route: the SpMM's
    (``route_key``) and the attention kernels' (``"<kernel>/<route>"``)."""
    return {**spmm_csr_cuda.route_launches, **attention_csr.route_launches}


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
    ranked = ranked[:top] + [kv for kv in ranked[top:] if any(k in kv[0] for k in OWN_KERNELS)]
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


def check_product(what, blocks, x, out, drop=None, other=None, extra_roundings=0, chunk=EDGES_PER_CHUNK) -> dict:
    """Holds the kernel's ``out`` = A @ ``x`` (under ``drop``) against the
    plain version in float64, block of rows by block of rows, entry by entry:

        |out - plain| <= gamma(h_r) * (|A| @ |x|),  gamma(h) = h u / (1 - h u),  u = 2^-24,

    the worst-case rounding error of a sum whose every term passes through at
    most h_r roundings (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., section 4.2). The kernel rounds a term of row r at
    most min(deg_r, E) times in its chunk's fmas (E = ``chunk``, the SpMM's
    EDGES_PER_CHUNK by default), 5 in the lanes' shuffle adds and deg_r // E
    + 1 in the carry adds: h_r = min(deg_r, E) + deg_r // E + 8, 2 to spare. A row whose only edges have x
    = 0 (IMCGAE's pad column) must come out exactly 0. A wrong or lost edge
    moves an entry by one term, about 1/deg_r of (|A| @ |x|): the check sees
    it while deg_r * gamma(h_r) < 1 (``limit_over_mean_term``). A sum of
    partial products (the shards of phase 12) passes through
    ``extra_roundings`` more. Raises on the first block past its limit. -> max abs err and max err / limit of
    ``out`` (and of ``other``, another result of the same product, such as
    ``torch.sparse.mm``'s, which is only reported)."""
    x64 = x.double()
    res = {"max_abs_err": 0.0, "max_err_over_limit": 0.0, "limit_over_mean_term": 0.0}
    if other is not None:
        res.update(other_max_abs_err=0.0, other_max_err_over_limit=0.0)
    for r0, r1, m in blocks:
        ref = plain_product([(r0, r1, m)], x64, drop)
        deg = torch.diff(m.row_ptr).double()[:, None]
        h = torch.clamp(deg, max=chunk) + torch.div(deg, chunk, rounding_mode="floor") + 8
        h = h + extra_roundings
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


def kernel_device_ms(fn, calls=20, kernels=("spmm_chunk_kernel", "spmm_carry_kernel")) -> dict[str, float] | None:
    """Device time of one launch of each kernel of ``fn`` (default
    ``spmm_chunk_kernel``, ``spmm_carry_kernel``; each launched once a
    call), from ``torch.profiler`` over ``calls`` calls after one warm-up:
    what the card spent in each, whatever the host's pace. The mean over the
    launches the profiler recorded, which may be fewer than ``calls`` (it
    has dropped device events). None when it saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # the profiler now and then records no device event: try once more
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, seen = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for kernel in kernels:
                    if kernel in e.name:
                        total[kernel] = total.get(kernel, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
                        seen[kernel] = seen.get(kernel, 0) + 1
        if total:
            return {k: total[k] / seen[k] for k in total}
    return None


def device_ms_per_call(fn, calls=20) -> tuple[float, float] | None:
    """(device ms, device launches) of one call of ``fn``, every kernel it
    launches summed, from ``torch.profiler`` over ``calls`` calls after one
    warm-up; measured again once when the launches a call come out
    fractional (the profiler dropped events); None when it saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    res = None
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events() if e.device_type == DeviceType.CUDA]
        res = (sum(spans) / 1e3 / calls, len(spans) / calls) if spans else None
        if res is not None and len(spans) % calls == 0:
            break
    return res


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
    draws = sampling.sample_bpr_batch_cuda.launches
    trainer.train_one_epoch, trainer.eval = train_one_epoch, evaluate
    routes = ("forward", "forward_dropout", "transpose_dropout") + (("view",) if dose else ())
    if min(route_launches[r] for r in routes) == 0:
        raise AssertionError(f"a route of the kernel was not launched in training: {route_launches}")
    step_draws = STEP_DRAWS[model.name]
    if draws != step_draws * trainer.steps_per_epoch * len(losses):
        raise AssertionError(f"training drew {draws} batches through the sampler's kernel in {len(losses)} epochs of "
                             f"{trainer.steps_per_epoch} steps, expected {step_draws} a step")

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
        f"{trainer.steps_per_epoch} steps an epoch; launches {launches} {route_launches}; sampler kernel {draws}"
    )
    os.remove(trainer.save_path)

    # (c) one step: every sparse product of the forward and the backward;
    # three steps after the reload, each counted alone: the eager warm-up,
    # the captured step and a replay of its graph
    for kind in ("eager", "captured", "replayed"):
        reset_launch_counts()
        trainer.step()
        torch.cuda.synchronize()
        per_step = dict(spmm_csr_cuda.route_launches)
        if spmm_csr_cuda.launches != 2 * n_products or per_step["transpose"] != 0:
            raise AssertionError(f"one {kind} step launched {spmm_csr_cuda.launches} ({per_step}), expected "
                                 f"{2 * n_products}")
        if sampling.sample_bpr_batch_cuda.launches != step_draws:
            raise AssertionError(f"one {kind} step drew {sampling.sample_bpr_batch_cuda.launches} batches through "
                                 f"the sampler's kernel, expected {step_draws}")
    log(f"one step (eager, captured and replayed alike): {spmm_csr_cuda.launches} launches for {n_products} "
        f"products: {per_step}; {step_draws} through the sampler's kernel")

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


def zoo_model_run(name, trainer, ds, ev, card, examples_per_step, run=None, keep_losses=False) -> dict:
    """Phases 9 (b) and 10 for one trainable model: ``run`` trains it
    (default: one epoch), ``evaluate`` follows; the launches of both by
    route, one step's launches by route against ``STEP_LAUNCHES``, the
    step's times and one profiled step; with ``keep_losses``, every step's
    loss by epoch under ``"step_losses"`` (not for the JSON line)."""
    model = trainer.model
    run = run or (lambda: trainer.train_one_epoch())
    reset_launch_counts()  # the model's run starts here
    by_epoch, epoch_s = train_recorded(trainer, run)
    metrics, eval_ms = evaluate_and_check(ds, ev, model, trainer.params, name)
    run_launches = launches_by_route()  # and ends here
    run_draws = sampling.sample_bpr_batch_cuda.launches
    expected, step_draws = STEP_LAUNCHES[name], STEP_DRAWS[name]
    if expected and min(run_launches[r] for r in expected) == 0:
        raise AssertionError(f"{name}: a route of the kernel was not launched in its run: {run_launches}")
    n_steps = sum(len(ls) for ls in by_epoch)
    if run_draws != step_draws * n_steps:
        raise AssertionError(f"{name}: its run drew {run_draws} batches through the sampler's kernel in {n_steps} "
                             f"steps, expected {step_draws} a step")
    # a trainer that takes its batches as arguments (MLTrainer) gets one
    # batch of its epoch, built once outside the timed steps
    batch = trainer.batches(trainer.epoch)[0][:2] if hasattr(trainer, "batches") else ()

    def step():
        return trainer.step(*batch)

    # after the epoch end: an eager step, and where the trainer replays its
    # step, the captured one and a replay, each counted alone
    for kind in ("eager", "captured", "replayed") if trainer.step_graph is not None else ("eager",):
        reset_launch_counts()
        step()
        torch.cuda.synchronize()
        per_step = {k: v for k, v in launches_by_route().items() if v}
        if per_step != expected:
            raise AssertionError(f"{name}: one {kind} step launched {per_step}, expected {expected}")
        if sampling.sample_bpr_batch_cuda.launches != step_draws:
            raise AssertionError(f"{name}: one {kind} step drew {sampling.sample_bpr_batch_cuda.launches} batches "
                                 f"through the sampler's kernel, expected {step_draws}")
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
    if keep_losses:
        out["step_losses"] = by_epoch
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
    real_loss = t.batch_loss  # one call a step
    t.batch_loss = lambda *batch, **kw: (archs.append(t.model.arch), real_loss(*batch, **kw))[1]
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


METRIC_TOPKS = (1, *range(5, 101, 5))  # the eval cell's 21 cutoffs
METRIC_KERNEL_NAMES = ("metric_rows_kernel", "metric_sums_kernel")


def metric_case(rng, B, K, width, sorted_gt):
    """A batch for the metric sums on the card: distinct ranked ids, ground
    truth of every length up to ``width`` (half of it from the user's own
    ranking, so that every rank can hit) padded with the sentinel, 15% of
    the users padding."""
    rec = np.stack([rng.choice(N_ITEMS, size=K, replace=False) for _ in range(B)])
    lens = rng.integers(0, width + 1, B)
    lens[0], lens[-1] = 0, width
    rows = np.full((B, width), N_ITEMS, dtype=np.int32)
    for u, n in enumerate(lens):
        own = rng.choice(rec[u], size=min(n // 2, K), replace=False)
        rest = np.setdiff1d(np.arange(N_ITEMS), own)[rng.choice(N_ITEMS - own.size, size=n - own.size, replace=False)]
        rows[u, :n] = np.concatenate([own, rest])
    if sorted_gt:
        rows.sort(axis=1)
    valid = rng.random(B) < 0.85
    return (torch.as_tensor(rec, device="cuda"), torch.as_tensor(rows, device="cuda"),
            torch.as_tensor(lens.astype(np.int32), device="cuda"), torch.as_tensor(valid, device="cuda"))


def check_metric_sums(what, case, topks, sorted_gt) -> dict:
    """The kernel on one batch: two launches bitwise equal, the sums within
    REL_TOL * max(1, max |sum|) of the plain version on the card and within
    1e-6 (relative and absolute) of it on the CPU, the valid count exactly."""
    got = twice(what, lambda: device_metrics.batch_metric_sums_cuda(*case, topks, sorted_gt))
    want = device_metrics.batch_metric_sums_reference(*case, topks, sorted_gt)
    err = close(got[0], want[0], f"{what}: sums vs the plain version on the card")
    want_cpu = device_metrics.batch_metric_sums_reference(*(t.cpu() for t in case), topks, sorted_gt)
    np.testing.assert_allclose(got[0].cpu().numpy(), want_cpu[0].numpy(), rtol=1e-6, atol=1e-6, err_msg=what)
    if not (float(got[1]) == float(want[1]) == float(want_cpu[1])):
        raise AssertionError(f"{what}: valid count {float(got[1])}, plain {float(want[1])} / {float(want_cpu[1])}")
    return {"max_abs_err": err, "max_abs_err_cpu": float((got[0].cpu() - want_cpu[0]).abs().max())}


def metric_sums_phase(card, rng) -> dict:
    """The evaluation's metric-sums kernel (``ops/csrc/metric_sums.cu``) on
    the card: edge cases, then the eval cell's shape by both membership
    routes, each checked (``check_metric_sums``); no synchronisation left in
    the call; the wrapper's count; times beside the plain version's and the
    bound. Returns the shape's numbers by route."""
    rng = np.random.default_rng(SEED) if rng is None else rng
    edge_cases = {
        "37 users, K 25, cutoffs over K, sorted": (37, 25, (1, 5, 20, 30), 300, True),
        "37 users, K 25, cutoffs over K, staged": (37, 25, (1, 5, 20, 30), 64, False),
        "one cutoff": (9, 40, (20,), 128, False),
        "rows over one staged tile": (6, 50, (1, 10, 50), 600, False),
        "64 cutoffs, K 300": (7, 300, tuple(range(1, 257, 4)), 512, True),
    }
    for what, (B, K, topks, width, sorted_gt) in edge_cases.items():
        check_metric_sums(what, metric_case(rng, B, K, width, sorted_gt), topks, sorted_gt)
    log(f"metric sums: {len(edge_cases)} edge cases against the plain version (card and CPU), bitwise repeatable")
    rows = {}
    for route, width, sorted_gt in (("binary_search", 512, True), ("staged_compare", 256, False)):
        case = metric_case(rng, TEST_BATCH, 100, width, sorted_gt)
        row = {"route": route, "B": TEST_BATCH, "K": 100, "gt_width": width, "cutoffs": len(METRIC_TOPKS),
               **check_metric_sums(route, case, METRIC_TOPKS, sorted_gt)}

        def kernel():
            return device_metrics.batch_metric_sums_cuda(*case, METRIC_TOPKS, sorted_gt)

        def plain():
            return device_metrics.batch_metric_sums_reference(*case, METRIC_TOPKS, sorted_gt)

        kernel()
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")  # any synchronising call raises
        try:
            for _ in range(3):
                device_metrics.batch_metric_sums(*case, METRIC_TOPKS, sorted_gt)
            row["launches_per_call"] = device_metrics.batch_metric_sums_cuda.launches / 3
            try:
                plain()
                row["plain_synchronises"] = False
            except RuntimeError:
                row["plain_synchronises"] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if row["launches_per_call"] != 2:
            raise AssertionError(f"{route}: {row['launches_per_call']} launches a call counted, not 2")
        row["ms"], row["plain_ms"] = median_ms(kernel), median_ms(plain)
        row["ms_windowed"], row["plain_ms_windowed"] = windowed_ms(kernel, plain)
        n_bytes = sum(t.numel() * t.element_size() for t in case) + 4 * (3 * len(METRIC_TOPKS) + 1)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 0.0)
        row["kernel_device_ms"] = kernel_device_ms(kernel, kernels=METRIC_KERNEL_NAMES)
        row["plain_device_ms_and_launches"] = device_ms_per_call(plain)
        row["clocks_after"] = card_clocks()
        log(f"metric sums, {route} (B {TEST_BATCH}, K 100, rows of {width}, {len(METRIC_TOPKS)} cutoffs) on {card}: "
            f"max abs err {row['max_abs_err']:.3g} (card plain), {row['max_abs_err_cpu']:.3g} (CPU plain); no "
            f"synchronisation (the plain version synchronises: {row['plain_synchronises']}); single calls: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; windows of 10: kernel {row['ms_windowed']:.4f} ms, "
            f"plain {row['plain_ms_windowed']:.4f} ms; device ms {row['kernel_device_ms']}; plain device ms and "
            f"launches a call {row['plain_device_ms_and_launches']}; bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}); then {row['clocks_after']}")
        rows[route] = row
    return rows


TOPK_KERNEL_NAMES = ("masked_topk_kernel<false>", "masked_topk_kernel<true>")
AMAZON_BOOK_ITEMS = 91_599  # Amazon-Book's published item count: rows the top-k kernel cuts in two


def topk_scores(rng, rows, n_items, d=64) -> torch.Tensor:
    """[rows, n_items] fp32 scores on the card as the evaluation makes them:
    the product of d-wide user and item rows drawn N(0, 0.1^2)."""
    u = torch.as_tensor(rng.normal(0.0, 0.1, (rows, d)), dtype=torch.float32, device="cuda")
    i = torch.as_tensor(rng.normal(0.0, 0.1, (n_items, d)), dtype=torch.float32, device="cuda")
    return u @ i.T


def topk_exclusions(rng, rows, n_items, width) -> torch.Tensor:
    """[rows, width] int32 on the card, as an evaluator's bucket of that width
    holds them: each row a quarter to all of the width in distinct ids (one
    repeated), then the sentinel n_items."""
    excl = np.full((rows, width), n_items, dtype=np.int32)
    for r, n in enumerate(rng.integers(width // 4, width + 1, rows)):
        excl[r, :n] = rng.choice(n_items, size=n, replace=False)
        excl[r, 0] = excl[r, n - 1]
    return torch.as_tensor(excl, device="cuda")


def check_masked_topk(what, scores, k, excl, banned) -> dict:
    """The kernel on one block of rows: two calls bitwise equal; its values
    exactly the plain path's (``mask_scores`` + ``torch.topk`` on the card);
    its ids exactly those of a stable descending sort of the masked rows
    (ties by the lower id, as JAX's ``lax.top_k``). Returns how many ids
    differ from the plain path's, all at tied values."""
    got_v, got_i = twice(what, lambda: topk_ops.masked_topk_cuda(scores, k, excl, banned))
    masked = topk_ops.mask_scores(scores, excl, banned)
    plain_v, plain_i = torch.topk(masked, k, dim=1)
    if not torch.equal(got_v, plain_v):
        raise AssertionError(f"{what}: values differ from the plain path's")
    want_v, want_i = torch.sort(masked, dim=1, descending=True, stable=True)
    if not (torch.equal(got_i, want_i[:, :k]) and torch.equal(got_v, want_v[:, :k])):
        bad = int((got_i != want_i[:, :k]).sum())
        raise AssertionError(f"{what}: {bad} ids differ from the stable sort's (value desc, id asc)")
    # the values are equal, so an id that differs from the plain path's ties with it
    return {"ids_differing_from_plain_at_ties": int((got_i != plain_i).sum())}


def masked_topk_phase(card, rng) -> dict:
    """The evaluation's masked top-k kernel (``ops/csrc/masked_topk.cu``) on
    the card: edge cases (k 1 and 128, k = n_items, an odd n_items with a
    banned tenth, few and over 2,048 ties at the k-th place, fewer
    eligible items than k, a row of -inf, rows cut in chunks), each checked
    (``check_masked_topk``); then the eval's shape (512 rows x 40,981 items,
    k 100; exclusion widths 64, 256 and 1,024 as the buckets give them; a
    banned range at width 64, as the inductive slices ban) and Amazon-Book's
    91,599 items (two launches): checked, no synchronisation in the call, the
    wrapper's count, the host's enqueue, single and windowed times beside the
    plain path's, the device time a launch, and the bound (the scores read
    once). Returns the shapes' numbers."""
    n = N_ITEMS
    edge = {
        "k 1": (topk_scores(rng, 37, n), 1, topk_exclusions(rng, 37, n, 64), None),
        "k 128 (MAX_K)": (topk_scores(rng, 37, n), topk_ops.MAX_K, topk_exclusions(rng, 37, n, 256), None),
        "k = n_items 41": (topk_scores(rng, 9, 41), 41, topk_exclusions(rng, 9, 41, 8), None),
        "odd n_items 997, a banned tenth": (topk_scores(rng, 33, 997), 100, topk_exclusions(rng, 33, 997, 64),
                                            torch.as_tensor(rng.random(997) < 0.1, device="cuda")),
    }
    ties = torch.round(topk_scores(rng, 8, n) * 20.0) / 20.0  # a few hundred levels
    ties[0] = 0.25  # every item ties
    ties[1, torch.as_tensor(rng.permutation(n)[:5000], device="cuda")] = 7.0  # 5,000 tie at the top
    edge["ties, few and over 2,048"] = (ties, 100, topk_exclusions(rng, 8, n, 256), None)
    few = topk_scores(rng, 4, 300)
    few[3] = -math.inf
    excl = topk_exclusions(rng, 4, 300, 300)
    excl[0, :250] = torch.as_tensor(rng.permutation(300)[:250], dtype=torch.int32, device="cuda")
    excl[1] = torch.arange(300, dtype=torch.int32, device="cuda")
    edge["fewer eligible than k, all -inf"] = (few, 100, excl, None)
    edge["cut rows, Amazon-Book width"] = (topk_scores(rng, 16, AMAZON_BOOK_ITEMS), 100,
                                           topk_exclusions(rng, 16, AMAZON_BOOK_ITEMS, 1024), None)
    differing = 0
    for what, (scores, k, ex, banned) in edge.items():
        differing += check_masked_topk(what, scores, k, ex, banned)["ids_differing_from_plain_at_ties"]
    log(f"masked top-k: {len(edge)} edge cases, values equal to the plain path's, ids to the stable sort's, bitwise "
        f"repeatable; {differing} ids differ from the plain path's, all at ties")
    rows = {}
    banned_range = torch.zeros(n, dtype=torch.bool, device="cuda")
    banned_range[n - n // 10 :] = True  # the newest tenth of the items, as an inductive slice bans a range
    shapes = {
        "eval, exclusions 64": (n, 64, None),
        "eval, exclusions 256": (n, 256, None),
        "eval, exclusions 1024": (n, 1024, None),
        "eval, exclusions 64, banned tenth": (n, 64, banned_range),
        "Amazon-Book items, exclusions 256": (AMAZON_BOOK_ITEMS, 256, None),
    }
    for what, (n_items, width, banned) in shapes.items():
        scores, k = topk_scores(rng, TEST_BATCH, n_items), 100
        ex = topk_exclusions(rng, TEST_BATCH, n_items, width)
        row = {"rows": TEST_BATCH, "n_items": n_items, "k": k, "exclusion_width": width, "banned": banned is not None,
               **check_masked_topk(what, scores, k, ex, banned)}

        def kernel():
            return topk_ops.masked_topk_cuda(scores, k, ex, banned)

        def plain():
            return torch.topk(topk_ops.mask_scores(scores, ex, banned), k, dim=1)

        kernel()
        torch.cuda.synchronize()
        before = topk_ops.masked_topk_cuda.launches
        torch.cuda.set_sync_debug_mode("error")  # any synchronising call raises
        try:
            for _ in range(3):
                topk_ops.masked_topk(scores, k, ex, banned)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row["launches_per_call"] = (topk_ops.masked_topk_cuda.launches - before) / 3
        if row["launches_per_call"] != 1 + (topk_ops.n_chunks(n_items) > 1):
            raise AssertionError(f"{what}: {row['launches_per_call']} launches a call counted")
        for key, fn in (("host_us", lambda: topk_ops.masked_topk(scores, k, ex, banned)), ("plain_host_us", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(40):  # the enqueue alone: 40 calls queue without waiting for the device
                fn()
            row[key] = (time.perf_counter() - t0) / 40 * 1e6
            torch.cuda.synchronize()
        row["ms"], row["plain_ms"] = median_ms(kernel), median_ms(plain)
        row["ms_windowed"], row["plain_ms_windowed"] = windowed_ms(kernel, plain)
        n_bytes = (scores.numel() * 4 + ex.numel() * 4 + (n_items if banned is not None else 0)
                   + TEST_BATCH * k * 12)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 0.0)
        row["kernel_device_ms"] = kernel_device_ms(kernel, kernels=TOPK_KERNEL_NAMES)
        row["device_ms_and_launches"] = device_ms_per_call(kernel)
        row["plain_device_ms_and_launches"] = device_ms_per_call(plain)
        row["clocks_after"] = card_clocks()
        log(f"masked top-k, {what} ({TEST_BATCH} x {n_items}, k {k}) on {card}: {row['launches_per_call']:g} "
            f"launches a call, no synchronisation; host enqueue {row['host_us']:.1f} us a call (plain "
            f"{row['plain_host_us']:.1f}); single calls: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms; windows of 10: kernel {row['ms_windowed']:.4f} ms, plain "
            f"{row['plain_ms_windowed']:.4f} ms; device ms a launch {row['kernel_device_ms']}, a call (ms, launches) "
            f"{row['device_ms_and_launches']}; plain {row['plain_device_ms_and_launches']}; bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}); {row['ids_differing_from_plain_at_ties']} ids differ "
            f"from the plain path's at ties; then {row['clocks_after']}")
        rows[what] = row
    return rows


SAMPLER_SEEDS = (3_000_000_019, 2**31 + 11, 7)
SAMPLER_KERNEL_NAMES = ("bpr_sample_kernel",)


def twin_generators(seed) -> tuple:
    """Two CUDA generators in the same state."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    twin = torch.Generator(device="cuda")
    twin.set_state(gen.get_state())
    return gen, twin


def sampler_phase(card, samplers=None) -> dict:
    """The BPR draw's kernel (``ops/csrc/bpr_sample.cu``) on the card, on
    IGCN's two samplers at the Gowalla size (built here when not given):
    each draw bitwise the plain torch ops' on the card from a clone of the
    same generator state, the generators left alike (the step's shape and
    neg_ratio 4, B 1 and 333, three seeds); no synchronisation in a draw
    (``torch.cuda.set_sync_debug_mode("error")``), one launch counted a draw;
    at the step's shape the draw's time (single, windowed, host clock of the
    enqueue) beside the plain version's and the host time of the wrapper's
    ``torch.cuda.device`` context alone, the device time and launches of a
    draw, the kernel's device time and its byte bound. Returns the rows by
    sampler."""
    if samplers is None:  # as IGCNTrainer builds them: over the train set and over the core ids
        ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=SEED)
        model = get_model(IGCN_CONFIG, ds)
        aux = AuxiliaryDataset(ds, model.user_map, model.item_map)
        samplers = {"main": build_sampler_state(ds.train_data, ds.n_items, "cuda"),
                    "aux": build_sampler_state(aux.train_data, aux.n_items, "cuda")}
    batch = TRAINER_CONFIG["batch_size"]
    rows = {}
    for name, state in samplers.items():
        for B, neg_ratio in ((batch, 1), (batch, 4), (1, 1), (333, 3)):
            for seed in SAMPLER_SEEDS:
                gen, twin = twin_generators(seed)
                got = sampling.sample_bpr_batch(state, gen, B, neg_ratio)
                want = sampling.sample_bpr_batch_reference(state, twin, B, neg_ratio)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"sampler {name}, B {B}, neg_ratio {neg_ratio}, seed {seed}: the kernel's "
                                         "batch is not the plain version's")
                if not torch.equal(gen.get_state(), twin.get_state()):
                    raise AssertionError(f"sampler {name}: the two routes left the generator in other states")
        gen, plain_gen = twin_generators(SAMPLER_SEEDS[0])
        sampling.sample_bpr_batch(state, gen, batch)
        torch.cuda.synchronize()
        sampling.sample_bpr_batch_cuda.launches = 0
        torch.cuda.set_sync_debug_mode("error")  # any synchronising call raises
        try:
            for _ in range(3):
                sampling.sample_bpr_batch(state, gen, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        per_draw = sampling.sample_bpr_batch_cuda.launches / 3
        if per_draw != 1:
            raise AssertionError(f"sampler {name}: {per_draw} kernel launches counted a draw, not 1")

        def kernel():
            return sampling.sample_bpr_batch_cuda(state, gen, batch)

        def plain():
            return sampling.sample_bpr_batch_reference(state, plain_gen, batch)

        def device_switch():  # the context the wrapper skips when the state is on the current card
            with torch.cuda.device(state.deg.device):
                pass

        row = {"sampler": name, "B": batch, "neg_ratio": 1, "n_valid_users": int(state.valid_users.shape[0]),
               "n_items": state.n_items, "max_degree": state.max_degree, "launches_per_draw_counted": per_draw}
        for key, fn in (("host_us", kernel), ("plain_host_us", plain), ("device_switch_host_us", device_switch)):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(400):
                fn()
            row[key] = (time.perf_counter() - t0) / 400 * 1e6  # the enqueue alone: the device keeps up
            torch.cuda.synchronize()
        row["ms"], row["plain_ms"] = median_ms(kernel), median_ms(plain)
        row["ms_windowed"], row["plain_ms_windowed"] = windowed_ms(kernel, plain)
        row["kernel_device_ms"] = kernel_device_ms(kernel, kernels=SAMPLER_KERNEL_NAMES)
        row["draw_device_ms_and_launches"] = device_ms_per_call(kernel)
        row["plain_device_ms_and_launches"] = device_ms_per_call(plain)
        # bytes: the draws read and the batch written once; a pair's user, offset, degree and positive; each
        # negative's search, ceil(log2(deg + 1)) of the user's items
        users, _, _ = kernel()
        deg = state.deg[users].double()
        n_bytes = 8 * (2 * (2 * batch + batch) + 4 * batch) + 8 * float(torch.ceil(torch.log2(deg + 1)).sum())
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 0.0)
        row["clocks_after"] = card_clocks()
        log(f"sampler {name} (B {batch}, {row['n_valid_users']} users with a train item, max degree "
            f"{state.max_degree}) on {card}: {len(SAMPLER_SEEDS) * 4} draws bitwise the plain version's, no "
            f"synchronisation, one launch counted a draw; host enqueue: kernel {row['host_us']:.1f} us, plain "
            f"{row['plain_host_us']:.1f} us a draw, of the kernel's the device switch {row['device_switch_host_us']:.2f} "
            f"us; single: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms; windows of 10: kernel {row['ms_windowed']:.4f} ms, plain {row['plain_ms_windowed']:.4f} ms; "
            f"kernel device ms {row['kernel_device_ms']}; a draw's device ms and launches: kernel route "
            f"{row['draw_device_ms_and_launches']}, plain {row['plain_device_ms_and_launches']}; bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}); then {row['clocks_after']}")
        rows[name] = row
    return rows


def plain_att_rep(model, params):
    """AttIGCN get_rep in float64: the query and the adjacency through the
    plain SpMM, the attention through the plain versions of its kernels, the
    aggregation through the plain SpMM with the attention as values."""
    p = {k: v.detach().double() for k, v in params.items()}
    emb = p["embedding"][: model.feat_n_cols]
    feat, att = model.feat, model.att_feat
    x_q = spmm_csr_reference(feat.row_ptr, feat.col, feat.val.double(), emb)
    q = (x_q @ p["weight_q.w"] + p["weight_q.b"]).reshape(-1, model.n_heads, model.embedding_size)
    attn = fused_kv_attention_reference(att, q, p["weight_k.w"], p["weight_k.b"], emb, model.temperature)
    return plain_rep(model, params, spmm_csr_reference(att.row_ptr, att.col, attn, emb))


def bound_ms(n_bytes, n_ops) -> tuple[float, str]:
    """The least time for ``n_bytes`` moved at the HBM rate and ``n_ops``
    fp32 operations at the peak rate, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sddmm_bound_ms(mat, h, dv, bias) -> tuple[float, str]:
    """K1: the CSR's row_ptr and col, a [n_rows, h, dv], x [n_cols, dv] and
    b [n_rows, h] read once, out [nnz, h] written once; 2 h dv operations an
    edge."""
    n_bytes = 4 * (mat.n_rows + 1 + mat.nnz + mat.n_rows * h * dv + mat.n_cols * dv + mat.nnz * h
                   + (mat.n_rows * h if bias else 0))
    return bound_ms(n_bytes, 2.0 * h * dv * mat.nnz)


def check_sddmm(what, mat, a, x, b, out) -> dict:
    """Holds K1's ``out`` to its float64 plain version entry by entry:
    |out - plain| <= gamma(dv + 8) (|a| . |x| + |b|), the worst case of a
    sum whose every term passes through at most dv + 8 roundings (a lane's
    chain of at most dv multiply-adds, 5 shuffle adds, the bias, 2 to
    spare; ``check_product``'s bound for a dot product)."""
    ref = attention_csr.sddmm_csr_reference(mat.row_ptr, mat.col, a.double(), x.double(),
                                            None if b is None else b.double())
    mag = attention_csr.sddmm_csr_reference(mat.row_ptr, mat.col, a.double().abs(), x.double().abs(),
                                            None if b is None else b.double().abs())
    h = x.shape[1] + 8
    limit = h * U_FP32 / (1.0 - h * U_FP32) * mag
    err = (out.double() - ref).abs()
    ratio = err / limit
    ratio[(err == 0) & (limit == 0)] = 0.0
    if not bool((err <= limit).all()):
        i = int(torch.argmax(torch.nan_to_num(ratio, nan=torch.inf)))
        raise AssertionError(f"{what}: entry {divmod(i, out.shape[1])} err {err.flatten()[i].item()} > its limit "
                             f"{limit.flatten()[i].item()}")
    return {"max_abs_err": err.max().item(), "max_err_over_limit": ratio.max().item()}


def sddmm_backward_bound_ms(mat, h, dv) -> tuple[float, str]:
    """The scores' gradient: the CSR's row_ptr and col, g [nnz, h] and x
    [n_cols, dv] read once, d_a [n_rows, h, dv] and d_b [n_rows, h] written
    once; 2 h dv + h operations an edge."""
    n_bytes = 4 * (mat.n_rows + 1 + mat.nnz + mat.nnz * h + mat.n_cols * dv + mat.n_rows * h * dv + mat.n_rows * h)
    return bound_ms(n_bytes, (2.0 * dv + 1.0) * h * mat.nnz)


def check_sddmm_backward(what, mat, g, x, out) -> dict:
    """Holds the scores' gradient ``out`` = (d_a, d_b) to its float64 plain
    version entry by entry, head by head: d_a[:, j] as the product of the CSR
    with g[:, j] as edge values and x, d_b[:, j] as its product with a
    column of ones, each within ``check_product``'s bound at the kernel's
    chunking (h_r = min(deg_r, 256) + deg_r // 256 + 8: chunks of
    SOFTMAX_CHUNK edges)."""
    d_a, d_b = out
    ones = x.new_ones(x.shape[0], 1)
    res = {"max_abs_err": 0.0, "max_err_over_limit": 0.0}
    for j in range(g.shape[1]):
        mj = dataclasses.replace(mat, val=g[:, j].contiguous())
        for name, xs, o in (("d_a", x, d_a[:, j]), ("d_b", ones, d_b[:, j : j + 1])):
            r = check_product(f"{what} {name} head {j}", row_blocks(mj, int(xs.shape[1])), xs, o,
                              chunk=attention_csr.SOFTMAX_CHUNK)
            res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
            res["max_err_over_limit"] = max(res["max_err_over_limit"], r["max_err_over_limit"])
    return res


def measure_attention_kernel(name, kernel, plain, library, check, bound) -> dict:
    """One attention kernel on the card: two launches bitwise equal, held to
    its float64 plain version by ``check(out)``; its time, the plain
    version's (fp32, same inputs) and the library call's (None where there is
    none), each as the median of single calls and of windows of 10; the
    bound; the device time of its kernel by name."""
    out, again = kernel(), kernel()
    torch.cuda.synchronize()
    same = (torch.equal(out, again) if isinstance(out, torch.Tensor)
            else all(torch.equal(a, b) for a, b in zip(out, again)))
    if not same:
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    row = {"kernel": name, **check(out)}
    fns = {"ms": kernel, "plain_ms": plain, **({} if library is None else {"library_ms": library})}
    for key, fn in fns.items():
        row[key] = median_ms(fn)
    for key, ms in zip(fns, windowed_ms(*fns.values())):
        row[f"{key}_windowed"] = ms
    if library is None:
        row["library_ms"] = row["library_ms_windowed"] = None
    row["bound_ms"], row["bound_by"] = bound
    device = kernel_device_ms(kernel, kernels=SDDMM_KERNEL_NAMES + SOFTMAX_KERNEL_NAMES)
    row["kernel_device_ms"] = device
    row["kernel_device_ms_total"] = None if device is None else sum(device.values())
    row["clocks_after"] = card_clocks()
    log(f"{name}: max abs err {row['max_abs_err']:.3g} (bitwise repeatable); single calls: kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']}; windows of 10: kernel "
        f"{row['ms_windowed']:.4f} ms, plain {row['plain_ms_windowed']:.4f} ms, library "
        f"{row['library_ms_windowed']}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); device ms "
        f"{row['kernel_device_ms']} (then SM, memory clocks and power {row['clocks_after']})")
    return row


def twice(what, fn):
    """``fn()`` twice: raises unless the two results are bitwise equal."""
    out, again = fn(), fn()
    torch.cuda.synchronize()
    pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    return out


def check_softmax_passes(what, rp, scores, g, temp) -> dict:
    """The softmax passes' kernels on one CSR against their float64 plain
    versions, each launched twice and bitwise repeatable: the statistics m
    exactly (a max of the same fp32 values) and s within REL_TOL * max(1, s)
    row by row; p and attn from the kernel's statistics (``close``); the
    backward's c within REL_TOL * max(1, max |float64|) and g_s within REL_TOL
    of max |float64|, from the kernel's p; the whole softmax and its backward
    (the passes chained) equal to the passes. ``scores`` / ``g`` may be off
    16-byte alignment (the scalar path). -> max abs errors by pass."""
    m, s_ = twice(f"{what} softmax_stats", lambda: attention_csr.softmax_stats_cuda(rp, scores, temp))
    ref_m, ref_s = attention_csr.softmax_stats_reference(rp, scores.double(), temp)
    if not torch.equal(m.double(), ref_m):
        raise AssertionError(f"{what} softmax_stats: m differs from the float64 max")
    err_s = ((s_.double() - ref_s).abs() / ref_s.clamp(min=1.0)).max().item() if ref_s.numel() else 0.0
    if not err_s <= REL_TOL:
        raise AssertionError(f"{what} softmax_stats: s off by {err_s} of max(1, s)")
    p, attn = twice(f"{what} softmax_apply", lambda: attention_csr.softmax_apply_cuda(rp, scores, m, s_, temp))
    ref_p, ref_attn = attention_csr.softmax_apply_reference(rp, scores.double(), m.double(), s_.double(), temp)
    err_p = max(close(p, ref_p, f"{what} softmax_apply p"), close(attn, ref_attn, f"{what} softmax_apply attn"))
    c = twice(f"{what} softmax_stats_backward", lambda: attention_csr.softmax_stats_backward_cuda(rp, p, g))
    ref_c = attention_csr.softmax_stats_backward_reference(rp, p.double(), g.double())
    err_c = close(c, ref_c, f"{what} softmax_stats_backward c")
    g_s = twice(f"{what} softmax_apply_backward",
                lambda: attention_csr.softmax_apply_backward_cuda(rp, p, g, c, temp))
    ref_gs = attention_csr.softmax_apply_backward_reference(rp, p.double(), g.double(), c.double(), temp)
    err_gs = (g_s.double() - ref_gs).abs().max().item() if ref_gs.numel() else 0.0
    if not err_gs <= REL_TOL * ref_gs.abs().max().item():
        raise AssertionError(f"{what} softmax_apply_backward: max abs err {err_gs}")
    whole = attention_csr.segment_softmax_csr(rp, scores, temp)
    if not (torch.equal(whole[0], p) and torch.equal(whole[1], attn)
            and torch.equal(attention_csr.segment_softmax_csr_backward(rp, p, g, temp), g_s)):
        raise AssertionError(f"{what}: the whole softmax is not its two passes")
    return {"softmax_stats": err_s, "softmax_apply": err_p, "softmax_stats_backward": err_c,
            "softmax_apply_backward": err_gs}


def misaligned(t):
    """The same values 4 bytes past a 16-byte aligned start."""
    return torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)[1:].view_as(t).copy_(t)


def check_attention_edge_cases(rng) -> float:
    """The attention kernels on small CSRs: a run of 3,000 empty rows, rows
    cut across many softmax chunks (5,000 and 1,100 edges), one row, the
    feature matrix's 12,745-edge row, rows cut exactly at the chunk ends
    (the softmax passes' and ``sddmm_csr``'s), a run of one-edge rows, each
    with one row of -inf scores. ``sddmm_csr`` (within ``check_sddmm``'s
    bound) and ``sddmm_csr_backward`` (``check_sddmm_backward``) on all at h
    in {1, 2, 3, 4, 8} and widths of the 16-byte paths (8, 16, 64, 128) and of the scalar
    ones (37, 200, and 64 with every operand off 16-byte alignment), twice
    bitwise equal; the softmax passes on all at h 1-8, aligned and not (the
    scalar path), against their float64 plain versions
    (:func:`check_softmax_passes`)."""
    worst = 0.0
    chunk = attention_csr.SOFTMAX_CHUNK
    cases = [
        ("empty runs and long rows", np.concatenate([np.zeros(3000, np.int64), rng.integers(0, 5, 500), [5000],
                                                      np.zeros(100, np.int64), [1100], rng.integers(0, 40, 300),
                                                      np.zeros(50, np.int64)]), 900),
        ("one row", np.array([3]), 5),
        ("a 12,745-edge row", np.concatenate([[12745], rng.integers(0, 30, 200)]), 13000),
        ("rows cut at chunk ends", np.array([chunk, chunk, 2 * chunk, 1, chunk - 1, 0, 0, chunk // 2, chunk // 2,
                                             chunk, 3, 5]), 600),
        ("a run of one-edge rows", np.concatenate([[7], np.ones(3 * chunk, np.int64), [chunk + 3], np.ones(100, np.int64)]),
         700),
    ]
    for name, degrees, n_cols in cases:
        row = rows_of_degrees(degrees)
        mat = build_csr_spmm(row, rng.integers(0, n_cols, len(row)), np.ones(len(row)), (len(degrees), n_cols),
                             device="cuda")
        rp, col = mat.row_ptr, mat.col
        for h in (1, 2, 3, 4, 8):
            for dv, aligned in ((8, True), (16, True), (64, True), (128, True), (37, True), (200, True), (64, False)):
                a = torch.randn(mat.n_rows, h, dv, device="cuda")
                x = torch.randn(n_cols, dv, device="cuda")
                b = torch.randn(mat.n_rows, h, device="cuda")
                g = torch.randn(mat.nnz, h, device="cuda")
                if not aligned:
                    a, x, b, g = (misaligned(t) for t in (a, x, b, g))
                what = f"{name}: h {h} dv {dv} aligned {aligned}"
                out = twice(f"{what} sddmm_csr", lambda: attention_csr.sddmm_csr_cuda(rp, col, a, x, b))
                worst = max(worst, check_sddmm(f"{what} sddmm_csr", mat, a, x, b, out)["max_abs_err"])
                out = twice(f"{what} sddmm_csr_backward", lambda: attention_csr.sddmm_csr_backward_cuda(rp, col, g, x))
                worst = max(worst, check_sddmm_backward(f"{what} sddmm_csr_backward", mat, g, x, out)["max_abs_err"])
        # the last row of more than one edge gets -inf scores
        neg = len(degrees) - 1 - int(np.argmax(degrees[::-1] > 1)) if len(degrees) > 1 else None
        for h in range(1, attention_csr.MAX_HEADS + 1):
            scores = torch.randn(mat.nnz, h, device="cuda") * 30.0
            if neg is not None:
                scores[int(rp[neg]) : int(rp[neg + 1])] = -torch.inf
            g = torch.randn(mat.nnz, device="cuda")
            for aligned in (True, False):
                sc, gg = (scores, g) if aligned else (misaligned(scores), misaligned(g))
                errs = check_softmax_passes(f"{name}, h {h}, aligned {aligned}", rp, sc, gg, 80.0)
                worst = max(worst, errs["softmax_apply"], errs["softmax_stats_backward"])
    log(f"attention kernel edge cases: ok, max abs err {worst:.3g}, two launches bitwise equal")
    return worst


def check_attention_kernels(model, params, rng) -> dict:
    """Phase 10 (a): the attention kernels on small edge cases
    (:func:`check_attention_edge_cases`), then on the model's feature matrix
    at its heads and width, each against its float64 plain version, bitwise
    repeatable, timed beside the plain version and the library call: K1 with
    4 heads (the scores: qk, qb and the table, ``check_sddmm``; library
    ``torch.sparse.sampled_addmm`` batched over the heads) and with one
    (d(values): a cotangent and the table; library ``torch.sparse.
    sampled_addmm``), K2 (p and attn within 1e-5 * max(1, max |float64|))
    and K3 (within 1e-5 of max |float64|; library: autograd's backward
    through ``segment_softmax``), the scores' gradient (within
    ``check_sddmm_backward``'s bound; library: ``torch.sparse.mm`` once a
    head; beside it the path it replaced, one SpMM a head on [table | 1 |
    0 0 0] with a cat and a stack). Then the product with the attention as
    edge values and its transpose against float64, d(values) through the
    autograd Function against float64, and ``get_rep`` against the float64
    plain chain."""
    att, d, h, temp = model.att_feat, model.embedding_size, model.n_heads, model.temperature
    rp, col = att.row_ptr, att.col
    emb = params["embedding"][: model.feat_n_cols].detach()
    g = torch.as_tensor(rng.normal(0.0, 0.1, (att.n_rows, d)), dtype=torch.float32, device=emb.device)
    rows = {"edge_cases_max_abs_err": check_attention_edge_cases(rng)}
    with torch.no_grad():
        q = linear(params, "weight_q", spmm_csr_cuda(model.feat, emb)).reshape(-1, h, d)
        qk, qb = (t.contiguous() for t in folded_query(q, params["weight_k.w"], params["weight_k.b"], d))
        edge_rows, cols = att.edge_rows().long(), col.long()
        # the library call: sampled_addmm batched over the heads, qb[row] as
        # the sampled input's values (beta 1)
        heads = torch.sparse_csr_tensor(rp.expand(h, -1).contiguous(), col.expand(h, -1).contiguous(),
                                        qb.index_select(0, edge_rows).t().contiguous(), size=(h, *att.shape))
        qk_h, emb_t = qk.transpose(0, 1).contiguous(), emb.t().expand(h, -1, -1)
        rows["sddmm_scores"] = measure_attention_kernel(
            f"sddmm_csr h {h} (the scores)",
            lambda: attention_csr.sddmm_csr_cuda(rp, col, qk, emb, qb),
            lambda: attention_csr.sddmm_csr_reference(rp, col, qk, emb, qb),
            lambda: torch.sparse.sampled_addmm(heads, qk_h, emb_t),
            lambda out: check_sddmm("sddmm_csr scores", att, qk, emb, qb, out),
            sddmm_bound_ms(att, h, d, True),
        )
        lib = torch.sparse.sampled_addmm(heads, qk_h, emb_t).values().t()
        rows["sddmm_scores"]["library_max_abs_err"] = (
            lib.double() - attention_csr.sddmm_csr_reference(rp, col, qk.double(), emb.double(), qb.double())
        ).abs().max().item()
        del heads, lib
        g3 = g[:, None, :]
        ones = torch.sparse_csr_tensor(rp, col, torch.ones(att.nnz, device=emb.device), size=att.shape)
        rows["sddmm_d_values"] = measure_attention_kernel(
            "sddmm_csr h 1 (d(values))",
            lambda: attention_csr.sddmm_csr_cuda(rp, col, g3, emb, route="attention_d_values"),
            lambda: attention_csr.sddmm_csr_reference(rp, col, g3, emb),
            lambda: torch.sparse.sampled_addmm(ones, g, emb.t(), beta=0.0),
            lambda out: check_sddmm("sddmm_csr d(values)", att, g3, emb, None, out),
            sddmm_bound_ms(att, 1, d, False),
        )
        lib = torch.sparse.sampled_addmm(ones, g, emb.t(), beta=0.0).values()
        rows["sddmm_d_values"]["library_max_abs_err"] = (
            lib.double() - attention_csr.sddmm_csr_reference(rp, col, g3.double(), emb.double())[:, 0]).abs().max().item()
        scores = attention_csr.sddmm_csr_cuda(rp, col, qk, emb, qb)

        def check_softmax(out):
            ref_p, ref_attn = attention_csr.segment_softmax_csr_reference(rp, scores.double(), temp)
            return {"max_abs_err": max(close(out[0], ref_p, "segment_softmax_csr p"),
                                       close(out[1], ref_attn, "segment_softmax_csr attn"))}

        nnz_h, rows_h = att.nnz * h, att.n_rows * h
        rows["softmax"] = measure_attention_kernel(
            f"segment_softmax_csr h {h} (softmax_stats + softmax_apply)",
            lambda: attention_csr.segment_softmax_csr(rp, scores, temp),
            lambda: attention_csr.segment_softmax_csr_reference(rp, scores, temp),
            lambda: segment_softmax(scores, rp, temp).mean(dim=-1),
            check_softmax,
            bound_ms(4 * (att.n_rows + 1 + 2 * nnz_h + att.nnz), SOFTMAX_OPS_PER_ENTRY * nnz_h),
        )
        p, attn = attention_csr.segment_softmax_csr(rp, scores, temp)
        m, s_ = attention_csr.softmax_stats_cuda(rp, scores, temp)
        g_attn = attention_csr.sddmm_csr_cuda(rp, col, g3, emb)[:, 0].contiguous()
        c = attention_csr.softmax_stats_backward_cuda(rp, p, g_attn)
        rows["softmax_passes_max_abs_err"] = check_softmax_passes("the feature matrix", rp, scores, g_attn, temp)

        def err_only(what):
            return lambda out: {"max_abs_err": rows["softmax_passes_max_abs_err"][what]}

        # each pass alone, on the same inputs (checked just above)
        rows["softmax_stats"] = measure_attention_kernel(
            f"softmax_stats h {h}", lambda: attention_csr.softmax_stats_cuda(rp, scores, temp),
            lambda: attention_csr.softmax_stats_reference(rp, scores, temp), None, err_only("softmax_stats"),
            bound_ms(4 * (att.n_rows + 1 + nnz_h + 2 * rows_h), SOFTMAX_STATS_OPS_PER_ENTRY * nnz_h))
        rows["softmax_apply"] = measure_attention_kernel(
            f"softmax_apply h {h}", lambda: attention_csr.softmax_apply_cuda(rp, scores, m, s_, temp),
            lambda: attention_csr.softmax_apply_reference(rp, scores, m, s_, temp), None, err_only("softmax_apply"),
            bound_ms(4 * (att.n_rows + 1 + 2 * nnz_h + 2 * rows_h + att.nnz), SOFTMAX_APPLY_OPS_PER_ENTRY * nnz_h))
        rows["softmax_stats_backward"] = measure_attention_kernel(
            f"softmax_stats_backward h {h}", lambda: attention_csr.softmax_stats_backward_cuda(rp, p, g_attn),
            lambda: attention_csr.softmax_stats_backward_reference(rp, p, g_attn), None,
            err_only("softmax_stats_backward"),
            bound_ms(4 * (att.n_rows + 1 + nnz_h + att.nnz + rows_h), SOFTMAX_STATS_BACKWARD_OPS_PER_ENTRY * nnz_h))
        rows["softmax_apply_backward"] = measure_attention_kernel(
            f"softmax_apply_backward h {h}",
            lambda: attention_csr.softmax_apply_backward_cuda(rp, p, g_attn, c, temp),
            lambda: attention_csr.softmax_apply_backward_reference(rp, p, g_attn, c, temp), None,
            err_only("softmax_apply_backward"),
            bound_ms(4 * (att.n_rows + 1 + 2 * nnz_h + att.nnz + rows_h), SOFTMAX_APPLY_BACKWARD_OPS_PER_ENTRY * nnz_h))

        def check_backward(out):
            ref = attention_csr.segment_softmax_csr_backward_reference(rp, p.double(), g_attn.double(), temp)
            err, scale = (out.double() - ref).abs().max().item(), ref.abs().max().item()
            if not err <= REL_TOL * scale:
                raise AssertionError(f"segment_softmax_csr_backward: max abs err {err} > {REL_TOL} * {scale}")
            return {"max_abs_err": err, "max_abs_plain": scale}

    s_req = scores.clone().requires_grad_(True)
    a_req = segment_softmax(s_req, rp, temp).mean(dim=-1)
    with torch.no_grad():
        rows["softmax_backward"] = measure_attention_kernel(
            f"segment_softmax_csr_backward h {h} (softmax_stats_backward + softmax_apply_backward)",
            lambda: attention_csr.segment_softmax_csr_backward(rp, p, g_attn, temp),
            lambda: attention_csr.segment_softmax_csr_backward_reference(rp, p, g_attn, temp),
            lambda: torch.autograd.grad(a_req, s_req, g_attn, retain_graph=True)[0],
            check_backward,
            bound_ms(4 * (att.n_rows + 1 + 2 * nnz_h + att.nnz), SOFTMAX_BACKWARD_OPS_PER_ENTRY * nnz_h),
        )
        del s_req, a_req
        g_s = attention_csr.segment_softmax_csr_backward(rp, p, g_attn, temp)

        def earlier_path():
            """The scores' gradient as it was: one SpMM a head with g_s[:, j]
            as edge values on [table | 1 | 0 0 0], a cat and a stack."""
            v1 = torch.cat([emb, emb.new_ones(emb.shape[0], 1), emb.new_zeros(emb.shape[0], 3)], dim=1)
            dq = torch.stack([spmm_csr_cuda(att, v1, val=g_s[:, j].contiguous()) for j in range(h)], dim=1)
            return dq[:, :, :d], dq[:, :, d]

        head_mats = [torch.sparse_csr_tensor(rp, col, g_s[:, j].contiguous(), size=att.shape) for j in range(h)]
        rows["sddmm_backward"] = measure_attention_kernel(
            f"sddmm_csr_backward h {h} (the scores' gradient)",
            lambda: attention_csr.sddmm_csr_backward_cuda(rp, col, g_s, emb),
            lambda: attention_csr.sddmm_csr_backward_reference(rp, col, g_s, emb),
            lambda: [torch.sparse.mm(m, emb) for m in head_mats],
            lambda out: check_sddmm_backward("sddmm_csr_backward", att, g_s, emb, out),
            sddmm_backward_bound_ms(att, h, d),
        )
        del head_mats
        earlier = earlier_path()
        kernel_out = attention_csr.sddmm_csr_backward_cuda(rp, col, g_s, emb)
        rows["sddmm_backward"]["earlier_path_max_abs_diff"] = max(
            (e - k).abs().max().item() for e, k in zip(earlier, kernel_out))
        (rows["sddmm_backward"]["earlier_path_ms_windowed"],) = windowed_ms(earlier_path)
        rows["sddmm_backward"]["earlier_path_ms"] = median_ms(earlier_path)
        rows["sddmm_backward"]["earlier_path_device"] = device_ms_per_call(earlier_path)
        rows["sddmm_backward"]["device_per_call"] = device_ms_per_call(
            lambda: attention_csr.sddmm_csr_backward_cuda(rp, col, g_s, emb))
        log(f"the scores' gradient as it was (4 SpMM on [table | 1 | 0 0 0], cat, stack): "
            f"{rows['sddmm_backward']['earlier_path_ms']:.4f} ms single, "
            f"{rows['sddmm_backward']['earlier_path_ms_windowed']:.4f} windowed, (device ms, launches) a call "
            f"{rows['sddmm_backward']['earlier_path_device']} against the kernel's "
            f"{rows['sddmm_backward']['device_per_call']}; the two differ by at most "
            f"{rows['sddmm_backward']['earlier_path_max_abs_diff']:.3g}")
        del earlier, kernel_out
        rows["attention"] = measure_spmm("attention", dataclasses.replace(att, val=attn), emb)
        rows["attention_transpose"] = measure_spmm(
            "attention^T", dataclasses.replace(att.T, val=attn[att.t_pos].contiguous()), g)
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
    log(f"AttIGCN: attention over {att.nnz} edges ({h} heads, T {temp}, largest row "
        f"{int(torch.diff(rp).max())}); d(values) max abs err {err:.3g} (max |float64| {scale:.3g}); get_rep vs the "
        f"float64 plain chain {rows['rep_max_abs_err']:.3g}")
    return rows


def graph_side(name, model_cfg, trainer_cfg, ds, graph) -> tuple:
    """An epoch and a half of a fresh trainer of the named model, its step
    replayed as a CUDA graph (``graph``) or run eagerly: (the trainer, its
    step losses, its parameters, its launches by route, its sampler draws,
    the peak device memory, the run's seconds)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = get_trainer(trainer_cfg, ds, get_model(model_cfg, ds))
    if graph and trainer.step_graph is None:
        raise AssertionError(f"{name}: the single-device trainer on the card does not replay its step")
    if not graph:
        trainer.step_graph = None
    losses, real = [], trainer.step

    def step(*batch):
        losses.append(real(*batch))
        return losses[-1]

    trainer.step = step
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_one_epoch()
    for _ in range(trainer.steps_per_epoch // 2):
        trainer.step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trainer.step = real
    return (trainer, torch.stack(losses).cpu(), {k: p.detach().cpu() for k, p in trainer.params.items()},
            {k: v for k, v in launches_by_route().items() if v}, sampling.sample_bpr_batch_cuda.launches,
            torch.cuda.max_memory_allocated(), seconds)


def graph_against_eager(name, model_cfg, trainer_cfg, ds, timed) -> dict:
    """Phase 14 for one model: the graph run and the eager run (``graph_side``)
    equal bit for bit, losses and parameters, with the same launches and
    draws; with ``timed``, both trainers' step times after the run and one
    profiled step each, whose kernels the profiler must record alike."""
    out, runs = {}, {}
    for side in ("eager", "graph"):
        trainer, *runs[side] = graph_side(name, model_cfg, trainer_cfg, ds, side == "graph")
        losses, _, launches, draws, peak, seconds = runs[side]
        out[side] = {"steps": len(losses), "seconds": seconds, "peak_bytes": peak, "launches": launches,
                     "draws": draws}
        if timed:
            out[side]["step_ms"] = median_ms(trainer.step, reps=30)
            (out[side]["step_ms_windowed"],) = windowed_ms(trainer.step)
            b = device_breakdown(trainer.step, top=4)
            if b is None:
                raise AssertionError(f"{name} {side}: the profiler recorded no device activity in a step")
            out[side]["profiled_step"] = {"host_ms": b[0], "device_busy_ms": b[1], "device_launches": b[3],
                                          "spmm_chunk_kernels": sum(n for k, _, n in b[2] if "spmm_chunk_kernel" in k)}
        del trainer
    (le, pe, *_), (lg, pg, *_) = runs["eager"], runs["graph"]
    if lg.shape != le.shape or not torch.equal(lg, le):
        bad = int(torch.nonzero(lg != le)[0]) if lg.shape == le.shape else None
        raise AssertionError(f"{name}: the graph run's step losses differ from the eager run's (first at step {bad}; "
                             f"max {float((lg - le).abs().max()) if bad is not None else 'shapes differ'})")
    for k in pe:
        if not torch.equal(pg[k], pe[k]):
            raise AssertionError(f"{name}: parameter {k} after the graph run differs from the eager run's by "
                                 f"{float((pg[k] - pe[k]).abs().max()):.3g}")
    for key in ("launches", "draws"):
        if out["graph"][key] != out["eager"][key]:
            raise AssertionError(f"{name}: {key} {out['graph'][key]} in the graph run, {out['eager'][key]} eager")
    if timed:
        ke, kg = (out[s]["profiled_step"]["spmm_chunk_kernels"] for s in ("eager", "graph"))
        if kg != ke or kg == 0:
            raise AssertionError(f"{name}: the profiler recorded {kg} spmm_chunk_kernel launches in a replayed step, "
                                 f"{ke} in an eager one")
    log(f"{name}: graph and eager runs equal bit for bit over {len(lg)} steps (an epoch end inside); launches "
        f"{out['graph']['launches']}; peak memory graph {out['graph']['peak_bytes'] / 2**30:.3f} GiB, eager "
        f"{out['eager']['peak_bytes'] / 2**30:.3f} GiB; run s graph {out['graph']['seconds']:.3f}, eager "
        f"{out['eager']['seconds']:.3f}"
        + ("" if not timed else "; step ms graph {:.3f} / {:.3f} windowed, eager {:.3f} / {:.3f}; profiled step: "
           "graph {}, eager {}".format(out["graph"]["step_ms"], out["graph"]["step_ms_windowed"],
                                       out["eager"]["step_ms"], out["eager"]["step_ms_windowed"],
                                       out["graph"]["profiled_step"], out["eager"]["profiled_step"])))
    return out


def graph_step_phase(card, ds=None) -> dict:
    """Phase 14: the training step replayed as a CUDA graph against the
    eager step (``graph_against_eager``): IGCN, DOSE_aug and AttIGCN on the
    Gowalla-scale set, timed and profiled; the IGCN family's other models
    on a small set."""
    ds = ds or quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=SEED)
    out = {"card": card}
    for name, model_cfg, trainer_cfg in GRAPH_MODELS:
        out[name] = graph_against_eager(name, model_cfg, trainer_cfg, ds, timed=True)
    small = quick_synthetic_dataset(*GRAPH_SMALL_SET, seed=SEED)
    for name in GRAPH_FAMILY:
        trainer_name = {"IMF": "IGCNTrainer", "DOSE_test": "DOSEtestTrainer"}.get(name, "DOSEaugTrainer")
        model_cfg = dict(IGCN_CONFIG, name=name, aug_num=2_000, aug_rate=0.5, pai=0.6)
        trainer_cfg = dict(DOSE_TRAINER_CONFIG, name=trainer_name, batch_size=GRAPH_SMALL_BATCH)
        out[name] = graph_against_eager(name, model_cfg, trainer_cfg, small, timed=False)
    return out


@contextlib.contextmanager
def plain_attention():
    """AttIGCN's attention as the plain torch ops (autograd through the
    kernels' plain versions) while the block runs: the yardstick of phase
    10 (a)."""
    real = att_igcn.fused_kv_attention
    att_igcn.fused_kv_attention = fused_kv_attention_reference
    try:
        yield
    finally:
        att_igcn.fused_kv_attention = real


def attention_device(model, params, rng) -> dict:
    """Device busy ms of the attention alone (``AttIGCN.attention`` forward
    and backward from a random cotangent), with the kernels and with the
    plain torch ops, under ``torch.profiler``; None where not measured."""
    gw = torch.as_tensor(rng.normal(0.0, 1e-3, model.att_feat.nnz), dtype=torch.float32, device=model.device)
    ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}

    def fwd_bwd():
        torch.autograd.grad(model.attention(ps), [ps["weight_q.w"], ps["weight_k.w"], ps["weight_k.b"]], gw)

    out = {}
    for key, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_attention)):
        with ctx():
            fwd_bwd()
            b = device_breakdown(fwd_bwd, top=12)
        out[key] = None if b is None else {"host_ms": b[0], "device_busy_ms": b[1], "device_launches": b[3],
                                           "kernels": b[2]}
    return out


def folded_query_gemms(model, params, rng) -> dict:
    """Each of the folded query's einsums (``ops.attention_spmm.
    folded_query``) alone on the model's shapes, forward and backward (from
    a random cotangent), under ``torch.profiler``: its device kernels by
    name with their ms, and its operands' shapes. Measured, not changed:
    which one is the step's largest cuBLAS GEMM."""
    d, h = model.embedding_size, model.n_heads
    emb = params["embedding"][: model.feat_n_cols].detach()
    with torch.no_grad():
        q0 = linear(params, "weight_q", spmm_csr_cuda(model.feat, emb)).reshape(-1, h, d)
    q = q0.clone().requires_grad_(True)
    w_k = params["weight_k.w"].detach().clone().requires_grad_(True)
    b_k = params["weight_k.b"].detach().clone().requires_grad_(True)
    wk3, bk2 = w_k.reshape(d, h, d), b_k.reshape(h, d)
    qk = torch.einsum("nhd,vhd->nhv", q, wk3)
    qb = torch.einsum("nhd,hd->nh", q, bk2)
    g_qk = torch.as_tensor(rng.normal(0.0, 1e-3, tuple(qk.shape)), dtype=torch.float32, device=q.device)
    g_qb = torch.as_tensor(rng.normal(0.0, 1e-3, tuple(qb.shape)), dtype=torch.float32, device=q.device)
    parts = {
        "qk forward: einsum('nhd,vhd->nhv', q, Wk)": lambda: torch.einsum("nhd,vhd->nhv", q, wk3),
        "qb forward: einsum('nhd,hd->nh', q, bk)": lambda: torch.einsum("nhd,hd->nh", q, bk2),
        "qk backward, d(q) alone": lambda: torch.autograd.grad(qk, [q], g_qk, retain_graph=True),
        "qk backward, d(Wk) alone": lambda: torch.autograd.grad(qk, [w_k], g_qk, retain_graph=True),
        "qb backward: d(q), d(bk)": lambda: torch.autograd.grad(qb, [q, b_k], g_qb, retain_graph=True),
    }
    out = {"shapes": {"q": list(q.shape), "Wk": [d, h, d], "bk": [h, d], "qk": list(qk.shape)}}
    for name, fn in parts.items():
        fn()
        b = device_breakdown(fn, top=4) or device_breakdown(fn, top=4)  # once more if no device event came
        out[name] = None if b is None else {"device_busy_ms": b[1], "kernels": b[2]}
        log(f"folded query, {name}: {out[name]}")
    return out


def step_memory(trainer) -> tuple[int, int]:
    """(peak device memory allocated over one training step, that peak less
    the memory allocated when the step began: what the step itself adds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    trainer.step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


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

    # (a) AttIGCN: the kernels, an epoch, then the same epoch on the same
    # batches with the plain torch-ops attention
    t = get_trainer(dict(TRAINER_CONFIG, n_epochs=1), ds, get_model(ATT_CONFIG, ds))
    rows.update(check_attention_kernels(t.model, t.params, rng))
    att_dev = attention_device(t.model, t.params, rng)
    att_dev["folded_query_gemms"] = folded_query_gemms(t.model, t.params, rng)
    att = zoo_model_run("AttIGCN", t, ds, ev, card, t.batch_size, keep_losses=True)
    losses = np.concatenate(att.pop("step_losses"))
    att["step_peak_bytes"], att["step_added_bytes"] = step_memory(t)
    del t
    with plain_attention():
        t = get_trainer(dict(TRAINER_CONFIG, n_epochs=1), ds, get_model(ATT_CONFIG, ds))
        plain_losses = np.concatenate(train_recorded(t, lambda: t.train_one_epoch())[0])
        (plain_windowed,) = windowed_ms(t.step)
        plain = {"step_ms": median_ms(t.step, reps=30), "step_ms_windowed": plain_windowed}
        b = device_breakdown(t.step, top=12)
        if b is not None:
            plain["profiled_step"] = {"host_ms": b[0], "device_busy_ms": b[1], "device_launches": b[3], "kernels": b[2]}
        plain["step_peak_bytes"], plain["step_added_bytes"] = step_memory(t)
    del t
    plain["loss_max_abs_diff"] = same_losses("AttIGCN with the kernels against the plain attention", losses,
                                             plain_losses)
    att.update(plain_attention=plain, attention_device=att_dev)
    models["AttIGCN"] = att
    busy = {k: (v or {}).get("device_busy_ms") for k, v in att_dev.items()}
    log(f"AttIGCN on {card}: {len(losses)} losses within {plain['loss_max_abs_diff']:.3g} of the plain attention's; "
        f"step {att['step_ms']:.3f} ms single / {att['step_ms_windowed']:.3f} windowed against the plain attention's "
        f"{plain['step_ms']:.3f} / {plain['step_ms_windowed']:.3f}; step peak device memory "
        f"{att['step_peak_bytes'] / 2**30:.3f} GiB against {plain['step_peak_bytes'] / 2**30:.3f} GiB, of which the "
        f"step adds {att['step_added_bytes'] / 2**30:.3f} against {plain['step_added_bytes'] / 2**30:.3f}; the attention "
        f"alone (forward + backward) device busy {busy['kernels']} ms against {busy['plain']} ms")

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
    steps (CUDA events around each), epochs and evaluations timed and its inductive
    slices kept; the SpMM launch counts are set to 0 just before and read
    just after. -> dict of what the run printed and measured."""
    made, step_events, epoch_s, eval_ms, slices = {}, [], [], [], {}
    real_get_trainer = cli.get_trainer

    def instrumented(config, dataset, model, **mesh):
        trainer = real_get_trainer(config, dataset, model, **mesh)
        real_step, real_epoch, real_eval = trainer.step, trainer.train_one_epoch, trainer.evaluator.evaluate
        real_inductive = trainer.inductive_eval

        def step(*batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = real_step(*batch)
            end.record()
            step_events.append((start, end))
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
    step_s = [start.elapsed_time(end) / 1e3 for start, end in step_events]
    return {
        "trainer": trainer, "result": result, "line": printed.getvalue().strip().splitlines()[-1],
        "launches": launches, "routes": {k: v for k, v in routes.items() if v}, "run_s": run_s,
        "step_s": step_s, "step_p50_ms": statistics.median(step_s) * 1e3 if step_s else float("nan"),
        "epoch_s": epoch_s, "evaluate_ms": eval_ms,
        "inductive_ndcg20": {tag: m["NDCG"][20] for tag, m in slices.items()},
        "products_per_get_rep": 1 + n_layers,
    }


def reloaded_test_metrics(trainer, checkpoint):
    trainer._load_model(checkpoint)
    return trainer.eval("test")[1]


def front_door_phase(card, per_step, rng, work) -> dict:
    """Phase 11, in the directory ``work``: the native graph core, the
    preprocessing of a raw Gowalla file at the published size through the
    command line, and the Gowalla grid's IGCN row run by the command line,
    its checkpoint reloaded and re-imported from the reference's format, and
    a trace of its steps. ``per_step``: an IGCN step's SpMM launches by route
    (phase 7)."""
    out = {"card": card}
    # (a) the library, built from the port's own copy of the source
    if not native.native_available() or not native.library_path().exists():
        raise AssertionError(f"the native graph core did not build or load ({native.library_path()})")
    log(f"native graph core: {native.library_path().relative_to(REPO)}")
    _, model_cfg, trainer_cfg = grid_row("IGCN")
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
    step_s, logdir = [], os.path.join(work, "trace")
    with trace(logdir):
        for _ in range(TRACE_STEPS):
            t0 = time.perf_counter()
            trainer.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    chunks = [e for e in events if e.get("cat") == "kernel" and "spmm_chunk_kernel" in e.get("name", "")]
    if not chunks:
        raise AssertionError("the trace holds no spmm_chunk_kernel launch (spmm_csr_chunks)")
    # the host's ranges: around a captured step the profiler may add a
    # gpu_user_annotation of the same name for the graph's kernels
    spans = sum(e.get("name") == "irt.train.step" and e.get("cat") == "user_annotation" for e in events)
    if spans != TRACE_STEPS:
        raise AssertionError(f"the trace holds {spans} irt.train.step host spans for {TRACE_STEPS} steps")
    out["trace"] = {"steps": TRACE_STEPS, "spmm_chunk_kernel_events": len(chunks), "kernel_events":
                    sum(e.get("cat") == "kernel" for e in events),
                    "step_p50_ms": statistics.median(step_s) * 1e3}
    log(f"trace of {TRACE_STEPS} steps: {len(chunks)} spmm_chunk_kernel events (launched by spmm_csr_chunks; "
        f"{sum(per_step.values()) // 2 * TRACE_STEPS} expected), {out['trace']['kernel_events']} kernel events; "
        f"synchronised step p50 {out['trace']['step_p50_ms']:.3f} ms")
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


# -- phase 12: the multi-GPU layer -------------------------------------------------


def shard_rows(name, coo, shape, x, g, drop):
    """Phase 12 (b): ``coo`` cut into SHARDS column blocks, each block's CSR
    (over the rows its edges span) and transpose through the kernel; the
    forward partials, placed at those rows and summed in shard order, and
    the transposes' rows, concatenated, are held against the whole
    matrix's float64 plain version (the sum: ``check_product``'s bound plus
    SHARDS - 1 roundings), under dropout ``drop`` = (seed, p) too, where the
    union of the shards' kept edges must be exactly ``edge_uniform``'s on
    the whole matrix. -> (shards, per-shard rows of times, max abs err)."""
    whole = build_csr_spmm(*coo, shape, device=x.device)
    shards = [build_edge_sharded_spmm(*coo, shape, SHARDS, s, device=x.device) for s in range(SHARDS)]
    return check_split(name, whole, shards, x, g, drop)


def check_split(name, whole, shards, x, g, drop):
    """:func:`shard_rows`'s checks and times for ``shards`` of the layout
    ``whole``; with ``drop`` None, without dropout."""
    n_rows, n_cols, d = whole.n_rows, whole.n_cols, int(x.shape[1])
    blk, rblk = shards[0].block, shards[0].row_block
    x_pad = x.new_zeros(shards[0].n_cols_pad, d)
    x_pad[:n_cols] = x
    g_pad = g.new_zeros(shards[0].n_rows_pad, d)
    g_pad[:n_rows] = g
    if sum(sh.fwd.nnz for sh in shards) != whole.nnz:
        raise AssertionError(f"{name}: the shards hold {[sh.fwd.nnz for sh in shards]} edges, the whole {whole.nnz}")
    worst = 0.0
    for dr in (None, drop) if drop is not None else (None,):
        total, rows_t = None, []
        for s, sh in enumerate(shards):
            part = place_rows(sh, spmm_csr_cuda(sh.fwd, x_pad[s * blk : (s + 1) * blk].contiguous(), drop=dr))
            total = part if total is None else total + part
            rows_t.append(spmm_csr_cuda(sh.bwd, g_pad[sh.row_lo : sh.row_hi], drop=dr))
        torch.cuda.synchronize()
        res = check_product(f"{name} {SHARDS} shards summed, dropout {dr}", row_blocks(whole, d), x, total[:n_rows],
                            dr, extra_roundings=SHARDS - 1)
        res_t = check_product(f"{name}^T {SHARDS} shards, dropout {dr}", row_blocks(whole.T, d), g,
                              torch.cat(rows_t)[:n_cols], dr)
        worst = max(worst, res["max_abs_err"], res_t["max_abs_err"])
    seed, p = drop if drop is not None else (0, 0.0)
    kept = torch.cat([sh.fwd.eid[kept_by_kernel(sh.fwd.eid, seed, p) != 0] for sh in shards])
    kept_t = torch.cat([sh.bwd.eid[kept_by_kernel(sh.bwd.eid, seed, p) != 0] for sh in shards])
    want = whole.eid[edge_uniform(seed, whole.eid) >= p]
    for what, got in (("forward", kept), ("transpose", kept_t)):
        if not torch.equal(torch.sort(got).values, torch.sort(want).values):
            raise AssertionError(f"{name} {what}: the shards keep {got.numel()} edges, the whole matrix {want.numel()}")
    times, t_side = [], "transpose_dropout" if drop is not None else "transpose"
    for s, sh in enumerate(shards):
        xs = x_pad[s * blk : (s + 1) * blk].contiguous()
        row = {"shard": s, "nnz": sh.fwd.nnz, "rows": [sh.row_lo, sh.row_hi], "cols": sh.fwd.n_cols}
        gs = g_pad[sh.row_lo : sh.row_hi]
        for side, mat, operand, dr in (("forward", sh.fwd, xs, None), (t_side, sh.bwd, gs, drop)):
            lib = torch.sparse_csr_tensor(mat.row_ptr, mat.col, mat.val if dr is None else
                                          dropout_values(mat.val, mat.eid, *dr), size=mat.shape)
            fns = (lambda m=mat, o=operand, dr=dr: spmm_csr_cuda(m, o, drop=dr),
                   lambda l=lib, o=operand: torch.sparse.mm(l, o))
            row[f"{side}_ms"] = median_ms(fns[0])
            row[f"{side}_ms_windowed"], row[f"{side}_library_ms_windowed"] = windowed_ms(*fns)
            row[f"{side}_bound_ms"], _ = spmm_bound_ms(mat, d, dropout=dr is not None)
        times.append(row)
    log(f"{name}: {SHARDS} shards of {[r['nnz'] for r in times]} edges ({blk} columns, {rblk} output rows each; "
        f"the rows holding each shard's edges {[r['rows'] for r in times]}): "
        f"partials summed and transposes against float64, with and without dropout {p}: max abs err {worst:.3g}; "
        f"kept edges = edge_uniform's ({want.numel()} of {whole.nnz}); per shard (ms single / windowed / "
        f"torch.sparse.mm windowed / bound): " + "; ".join(
            f"{r['shard']}: fwd {r['forward_ms']:.4f} / {r['forward_ms_windowed']:.4f} / "
            f"{r['forward_library_ms_windowed']:.4f} / {r['forward_bound_ms']:.4f}, {t_side} "
            f"{r[t_side + '_ms']:.4f} / {r[t_side + '_ms_windowed']:.4f} / "
            f"{r[t_side + '_library_ms_windowed']:.4f} / {r[t_side + '_bound_ms']:.4f}" for r in times))
    return shards, x_pad, g_pad, times, worst


def same_up_to_ties(what, rep, got, want, n_users, chunk=4096):
    """Top-k lists ``got`` and ``want`` [n_users, k] of the representation
    ``rep``: the scores at each rank agree within 1e-5, and the ids agree
    wherever a rank is clear of its neighbours in ``want`` by 1e-4."""
    got, want = (torch.as_tensor(a, device=rep.device).long() for a in (got, want))
    clear_share = []
    for u0 in range(0, n_users, chunk):
        u = torch.arange(u0, min(u0 + chunk, n_users), device=rep.device)
        ur = rep[u].double()[:, None, :]
        sg = (ur * rep[n_users + got[u]].double()).sum(-1)
        sw = (ur * rep[n_users + want[u]].double()).sum(-1)
        if not bool(((sg - sw).abs() <= 1e-5).all()):
            raise AssertionError(f"{what}: a rank's score differs by {(sg - sw).abs().max().item()}")
        gap = (sw[:, :-1] - sw[:, 1:]).abs()
        clear = torch.ones_like(sw, dtype=torch.bool)
        clear[:, 1:] &= gap > 1e-4
        clear[:, :-1] &= gap > 1e-4
        if not torch.equal(got[u][clear], want[u][clear]):
            raise AssertionError(f"{what}: the lists differ at a rank clear of ties")
        clear_share.append(clear.double().mean().item())
    return float(np.mean(clear_share))


def mesh_phase(ds, card, rng, work) -> dict:
    """Phase 12: the multi-GPU layer on the card, over NCCL."""
    out = {"card": card}
    # (a) the group: this process, on the card, NCCL
    t0 = time.perf_counter()
    init_distributed(init_method="file://" + os.path.join(work, "pg_store"))
    world = dist.get_world_size()
    mesh = make_mesh(1, world)
    out["init_s"] = time.perf_counter() - t0
    log(f"process group: {dist.get_backend()} over {world} rank(s) of {torch.cuda.device_count()} card(s); mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}; {out['init_s']:.2f} s")

    # (b) 4-shard layouts of the adjacency and the feature matrix through the kernel
    model = get_model(IGCN_CONFIG, ds)
    n = ds.n_users + ds.n_items
    d, p = IGCN_CONFIG["embedding_size"], IGCN_CONFIG["dropout"]
    adj_coo = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
    frow, fcol, counts, row_sum = build_feat_matrix(ds.train_array, ds.n_users, ds.n_items, model.user_map,
                                                    model.item_map)
    seed = int(rng.integers(0, 2**62))
    x_feat = torch.as_tensor(rng.normal(0.0, 0.1, (model.feat_n_cols, d)), dtype=torch.float32, device=model.device)
    g_rows = torch.as_tensor(rng.normal(0.0, 0.1, (n, d)), dtype=torch.float32, device=model.device)
    with torch.no_grad():
        x_adj = spmm_csr_cuda(model.feat, x_feat)
        adj_shards, adj_x, _, adj_times, err_a = shard_rows("adjacency", adj_coo, (n, n), x_adj, g_rows, (seed, p))
        feat_shards, _, feat_g, feat_times, err_f = shard_rows(
            "feature matrix", (frow, fcol, counts), (n, model.feat_n_cols), x_feat, g_rows, (seed, p))
        fwd_row = measure_spmm("adjacency shard 0 of 4", adj_shards[0].fwd, adj_x[: adj_shards[0].block].contiguous())
        f0 = feat_shards[0]
        t_row = measure_spmm("feature matrix shard 0 of 4, transpose, dropout", f0.bwd, feat_g[f0.row_lo : f0.row_hi],
                             drop=(seed, p))
    out.update(shard_times={"adjacency": adj_times, "feature_matrix": feat_times}, shard_max_abs_err=max(err_a, err_f))
    del adj_shards, feat_shards

    # (c) IGCNTrainer in edge mode: IGCN at mesh (1, world), one epoch, against the
    # single-device trainer of the same seed
    config = dict(TRAINER_CONFIG, n_epochs=1)
    single = get_trainer(config, ds, get_model(IGCN_CONFIG, ds))
    single_losses = [float(single.step()) for _ in range(DATA_MODE_STEPS)]
    edge = get_trainer(config, ds, get_model(IGCN_CONFIG, ds), mesh=mesh, mesh_mode="edge")
    init_ndcg = edge.eval("val")[1]["NDCG"][20]
    reset_launch_counts()  # the mesh path starts here
    reset_collective_counts()
    by_epoch, epoch_s = train_recorded(edge, lambda: edge.train(verbose=True))
    torch.cuda.synchronize()
    run_routes, run_kinds = dict(spmm_csr_cuda.route_launches), dict(collective_counts.by_kind)  # and ends here
    steps = np.concatenate(by_epoch)
    diff = np.abs(steps[:MESH_STEPS_COMPARED] - single_losses[:MESH_STEPS_COMPARED])
    if not (diff <= 1e-5 * np.maximum(1.0, np.abs(single_losses[:MESH_STEPS_COMPARED]))).all():
        raise AssertionError(f"edge-mode losses {steps[:MESH_STEPS_COMPARED]} vs single-device {single_losses[:20]}")
    final = edge.eval("val")[1]["NDCG"][20]
    if not final > init_ndcg:
        raise AssertionError(f"edge-mode val NDCG@20 {final} after the epoch, {init_ndcg} at init")
    shard_routes = ("edge_shard", "edge_shard_dropout", "edge_shard_transpose", "edge_shard_transpose_dropout")
    if min(run_routes[r] for r in shard_routes) == 0 or sum(v for r, v in run_routes.items() if r not in shard_routes):
        raise AssertionError(f"the edge-mode run's launches {run_routes}")
    if min(run_kinds[k] for k in ("all_reduce", "reduce_scatter", "all_gather")) == 0:
        raise AssertionError(f"a kind of collective was not launched: {run_kinds}")
    log(f"edge-mode IGCN, one epoch of {edge.steps_per_epoch} steps: the first {MESH_STEPS_COMPARED} losses within "
        f"{diff.max():.3g} of the single-device trainer's; val NDCG@20 {init_ndcg:.6f} at init, {final:.6f} after; "
        f"epoch s {epoch_s}; launches {run_routes}; collectives {run_kinds}")

    # the best checkpoint into the single-device IGCN; (d) the mesh evaluator
    # and the item-sharded recommend against the single-device ones, on the
    # reloaded weights (before the timed steps below train them on)
    mesh_metrics = edge.eval("test")[1]
    loaded = get_trainer(config, ds, get_model(IGCN_CONFIG, ds))
    loaded._load_model(edge.save_path)
    one_metrics = loaded.eval("test")[1]
    for name in mesh_metrics:
        for k, v in mesh_metrics[name].items():
            if abs(v - one_metrics[name][k]) > 1e-6:
                raise AssertionError(f"test {name}@{k}: mesh {v}, the checkpoint single-device {one_metrics[name][k]}")
    os.remove(edge.save_path)
    with torch.no_grad():
        rep = loaded.model.make_scoring_state(loaded.params)
    rec_mesh, rec_one = edge.recommend("test"), loaded.recommend("test")
    clear = same_up_to_ties("recommend", rep, rec_mesh, rec_one, ds.n_users)
    direct = sharded_recommend_all_users(mesh, rep, ds.n_users, ds.n_items, loaded.evaluator.k_max,
                                         exclude_rows=loaded.evaluator._trainval_excl, batch_size=TEST_BATCH)
    same_up_to_ties("sharded_recommend_all_users", rep, direct, rec_one, ds.n_users)
    out["serving"] = {"test_ndcg20": mesh_metrics["NDCG"][20], "test_recall20": mesh_metrics["Recall"][20],
                      "clear_share": clear}
    log(f"mesh evaluator = single-device to 1e-6 on the reloaded best checkpoint (test NDCG@20 "
        f"{mesh_metrics['NDCG'][20]:.6f}); recommend and sharded_recommend_all_users equal up to ties "
        f"({100 * clear:.1f}% of ranks clear of ties)")

    reset_launch_counts()
    reset_collective_counts()
    edge.step()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in spmm_csr_cuda.route_launches.items() if v}
    per_step_kinds = {k: v for k, v in collective_counts.by_kind.items() if v}
    want = {"edge_shard": 6, "edge_shard_dropout": 2, "edge_shard_transpose": 6, "edge_shard_transpose_dropout": 2}
    if per_step != want or per_step_kinds != {"all_reduce": 2, "reduce_scatter": 4, "all_gather": 4}:
        raise AssertionError(f"one edge-mode step launched {per_step} and collectives {per_step_kinds}")
    step_ms = median_ms(edge.step, reps=30)
    (step_windowed_ms,) = windowed_ms(edge.step)
    train = {
        "steps_per_epoch": edge.steps_per_epoch, "step_ms": step_ms, "step_ms_windowed": step_windowed_ms,
        "examples_per_s": edge.batch_size / step_ms * 1e3,
        "examples_per_s_windowed": edge.batch_size / step_windowed_ms * 1e3, "epoch_s": epoch_s,
        "val_ndcg20_init": init_ndcg, "val_ndcg20": final, "route_launches_run": run_routes,
        "collectives_run": run_kinds, "launches_per_step": per_step, "collectives_per_step": per_step_kinds,
        "loss_max_abs_diff_single": float(diff.max()),
    }
    breakdown = device_breakdown(edge.step, top=12)
    if breakdown is None:
        log("one edge-mode step under torch.profiler: no device activity recorded; breakdown not measured")
    else:
        host, busy, kernels, n_spans = breakdown
        nccl = [(k, ms, c) for k, ms, c in kernels if "nccl" in k.lower()]
        train["profiled_step"] = {"host_ms": host, "device_busy_ms": busy, "device_launches": n_spans,
                                  "kernels": kernels, "nccl_device_ms": sum(ms for _, ms, _ in nccl)}
        log(f"one edge-mode step under torch.profiler: host {host:.3f} ms, device busy {busy:.3f} ms, {n_spans} "
            f"device launches; NCCL kernels {train['profiled_step']['nccl_device_ms']:.4f} ms ({nccl}); by device time:")
        for name, ms, c in kernels:
            log(f"  {ms:9.4f} ms {c:5d}x  {name[:100]}")
    log(f"edge-mode step on {card}: {step_ms:.3f} ms single, {step_windowed_ms:.3f} ms windowed "
        f"({train['examples_per_s']:.0f} / {train['examples_per_s_windowed']:.0f} examples/s); single-device step "
        f"in the same run: {median_ms(single.step, reps=30):.3f} ms; launches a step {per_step}; collectives "
        f"{per_step_kinds}")
    out["train"] = train

    # (e) data mode: IGCNTrainer with the table row-sharded, 50 steps
    data = get_trainer(config, ds, get_model(dict(IGCN_CONFIG, table_align=world), ds), mesh=mesh, mesh_mode="data")
    data_losses = np.array([float(data.step()) for _ in range(DATA_MODE_STEPS)])
    ddiff = np.abs(data_losses - single_losses)
    if not (ddiff <= 1e-5 * np.maximum(1.0, np.abs(single_losses))).all():
        raise AssertionError(f"data-mode losses {data_losses} vs single-device {single_losses}")
    out["data_mode"] = {"steps": DATA_MODE_STEPS, "loss_max_abs_diff_single": float(ddiff.max())}
    log(f"data-mode IGCNTrainer: {DATA_MODE_STEPS} losses within {ddiff.max():.3g} of the single-device trainer's")

    # (f) the command line under torchrun, in phase 11's directory
    n_cards = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n_cards),
           "-m", "inductive_recommendation_tpu_torch", "--grid", "gowalla", "--index", str(CLI_ROW),
           "--mesh", f"1,{n_cards}", "--mesh-mode", "edge", "--n-epochs", "1", "--stage", "test"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    printed = proc.stdout.strip().splitlines()
    line = json.loads(printed[-1])
    launched = json.loads(printed[-2].removeprefix("launches: "))
    if not all(math.isfinite(line[k]) for k in ("best_val_ndcg", "test_ndcg@20", "test_recall@20")):
        raise AssertionError(f"the torchrun line is not finite: {line}")
    n_train = split_counts(os.path.join(work, *GRID_PATH.split("/")))[2]["train"]
    cli_steps = -(-n_train // grid_row("IGCN")[2]["batch_size"])
    expected = {r: cli_steps * k for r, k in want.items()}
    expected["edge_shard"] += 2 * 2 * (1 + IGCN_CONFIG["n_layers"])  # a val and a test get_rep, 2 launches a product
    if launched["spmm_by_route"] != expected:
        raise AssertionError(f"the torchrun run launched {launched['spmm_by_route']}, expected {expected}")
    out["torchrun"] = {"nproc": n_cards, "run_s": run_s, "line": line, "launches": launched, "steps": cli_steps}
    log(f"torchrun --nproc_per_node {n_cards} ... --mesh 1,{n_cards} --mesh-mode edge: {run_s:.2f} s, {cli_steps} "
        f"steps; {line}; launches {launched}")
    return out, fwd_row, t_row, mesh


def family_configs(name, ds, rng):
    """(dataset, model config, trainer config) of ``name`` at its Gowalla
    grid width, one epoch; IDCF_LGCN over a frozen table drawn from the seed
    (phase 9 trains its LightGCN), NeuMF with its row's neg_ratio."""
    if name in ("DOSE_aug", "DOSE_aug2", "DOSE_test"):
        trainer = "DOSEtestTrainer" if name == "DOSE_test" else "DOSEaugTrainer"
        return ds, dict(DOSE_CONFIG, name=name), dict(DOSE_TRAINER_CONFIG, name=trainer, n_epochs=1)
    if name in ("SGL", "HALF"):
        return ds, dict(SGL_CONFIG, name=name), dict(SGL_TRAINER_CONFIG, name=f"{name}Trainer")
    if name == "AttIGCN":
        return ds, dict(ATT_CONFIG), dict(TRAINER_CONFIG, n_epochs=1)
    dataset_cfg, model_cfg, trainer_cfg = grid_row(name)
    if name == "NeuMF":
        ds = copy.copy(ds)
        ds.negative_sample_ratio = dataset_cfg["neg_ratio"]
    if name == "IDCF_LGCN":
        model_cfg.pop("lgcn_path")
        n, d = ds.n_users + ds.n_items, model_cfg["embedding_size"]
        model_cfg["pretrained_embedding"] = rng.normal(0.0, 0.1, (n, d)).astype(np.float32)
    return ds, model_cfg, dict(trainer_cfg, n_epochs=1)


def family_steps(trainer, n=FAMILY_STEPS, grads=None) -> np.ndarray:
    """``n`` steps' losses (MLTrainer: its first epoch's first batches);
    ``grads`` (a dict) gets the first step's gradients."""
    if hasattr(trainer, "batches"):
        return np.array([float(trainer.step(u, v)) for u, v, _ in trainer.batches(0)[:n]])
    losses = []
    for i in range(n):
        losses.append(float(trainer.step()))
        if i == 0 and grads is not None:
            grads.update(model_grads(trainer))
    return np.array(losses)


def model_grads(trainer) -> dict:
    """The last step's gradients in the model's own layout (in edge mode
    IMCGAE holds its shared rows apart, as ``special``)."""
    g = {k: trainer._to_model_layout(k, p.grad).clone() for k, p in trainer.params.items()}
    return g if trainer.placement is None else trainer.model.from_edge_params(g)


def same_grads(what, got, want) -> float:
    """Each parameter's gradient within REL_TOL of its largest entry (those
    of ZERO_GRADS below 1e-6 of the largest of any); -> the largest error
    over its bound."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: gradients of {sorted(got)}, the single-device trainer's of {sorted(want)}")
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if name.endswith(ZERO_GRADS):
            err, bound = max(float(w.abs().max()), float(g.abs().max())), 1e-6 * top
        else:
            err, bound = float((g - w).abs().max()), REL_TOL * float(w.abs().max())
        if not err <= bound:
            raise AssertionError(f"{what}: the first step's gradient of {name} {err:.3g} from the single-device "
                                 f"trainer's, over its bound {bound:.3g}")
        worst = max(worst, err / bound if bound > 0 else 0.0)
    return worst


def same_losses(what, got, want) -> float:
    diff = np.abs(got - want)
    if not (np.isfinite(got).all() and (diff <= REL_TOL * np.maximum(1.0, np.abs(want))).all()):
        raise AssertionError(f"{what}: losses {got} against the single-device trainer's {want}")
    return float(diff.max())


def att_edge_losses(edge, model, got, want) -> bool:
    """AttIGCN's edge losses against the single-device trainer's: bit for
    bit where the shard's CSR is the whole attention layout (world 1: the
    same kernels on the same edges in the same order, the all-reduces
    identities), else within ATT_EDGE_LOSS_TOL * max(1, |loss|). -> whether
    the shard's CSR is the whole layout."""
    emat, whole = edge.placement.shard(model.att_feat), model.att_feat
    same = (emat.row_lo == 0 and emat.fwd.n_rows == whole.n_rows and torch.equal(emat.fwd.row_ptr, whole.row_ptr)
            and torch.equal(emat.fwd.col, whole.col))
    diff = np.abs(got - want)
    if (same and diff.any()) or not (diff <= ATT_EDGE_LOSS_TOL * np.maximum(1.0, np.abs(want))).all():
        raise AssertionError(f"AttIGCN edge mode (shard's CSR the whole layout: {same}): losses {got} against the "
                             f"single-device trainer's {want}")
    return same


def counted_run(fn) -> tuple:
    """``fn()`` with the launch and collective counts set to 0 just before
    and read just after: (its result, launches by route, collectives by
    kind); raises on a launch off the shard routes."""
    reset_launch_counts()
    reset_collective_counts()
    out = fn()
    torch.cuda.synchronize()
    routes = {k: v for k, v in launches_by_route().items() if v}
    if not routes or any(not r.split("/")[-1].startswith("edge_shard") for r in routes):
        raise AssertionError(f"an edge-mode run launched {routes}")
    return out, routes, dict(collective_counts.by_kind)


def split_on_card(name, whole, route, x, g, drop=None):
    """A SHARDS-way split of ``whole`` (a layout built on the device) cut on
    the device (``shard_csr``, as edge mode cuts them), held against the whole
    product (:func:`check_split`). -> (shards, x padded, g padded, times, err)."""
    shards = [shard_csr(whole, SHARDS, s, route=route) for s in range(SHARDS)]
    return check_split(name, whole, shards, x, g, drop)


def attention_split(model, params, rng) -> tuple:
    """AttIGCN's attention over a SHARDS-way column split of the feature
    matrix on one card: each shard's scores and statistics pass (its rows'
    maxima and sums), the maxima combined and the sums rescaled to them and
    added (the two all-reduces of ``parallel/attention.py``, here over the
    shards), each shard's apply pass, then each shard's product with its
    attention as edge values through the kernel. The attention equals the
    single-device ``AttIGCN.attention`` edge by edge within REL_TOL; the
    partials summed, the whole product with that attention within
    ``check_product``'s bound plus SHARDS - 1 roundings. -> (shard 0 with
    its attention, its operand rows, result)."""
    d, h = model.embedding_size, model.n_heads
    n, feat = model.n_users + model.n_items, model.feat
    emb = params["embedding"][: model.feat_n_cols].detach()
    with torch.no_grad():
        whole_attn = model.attention(params)
        q = (spmm_csr_cuda(feat, emb) @ params["weight_q.w"] + params["weight_q.b"]).reshape(-1, h, d)
        qk = torch.einsum("nhd,vhd->nhv", q, params["weight_k.w"].reshape(d, h, d))
        qb = torch.einsum("nhd,hd->nh", q, params["weight_k.b"].reshape(h, d))
    shards = [values_shard(shard_csr(feat, SHARDS, s)) for s in range(SHARDS)]
    blk, n_pad = shards[0].block, shards[0].n_rows_pad
    v_pad = emb.new_zeros(shards[0].n_cols_pad, d)
    v_pad[: model.feat_n_cols] = emb
    qk_pad, qb_pad = qk.new_zeros(n_pad, h, d), qb.new_zeros(n_pad, h)
    qk_pad[:n], qb_pad[:n] = qk, qb
    with torch.no_grad():
        temp = model.temperature
        scores = [shard_scores(sh, qk_pad, qb_pad, v_pad[s * blk : (s + 1) * blk]) for s, sh in enumerate(shards)]
        stats = [shard_stats(sh, sc, temp) for sh, sc in zip(shards, scores)]
        m_all = torch.stack([m for m, _ in stats]).amax(dim=0)
        s_all = sum(attention_csr.rescale_stats(m, s_, m_all, temp) for m, s_ in stats)
        attn = [shard_apply(sh, sc, m_all, s_all, temp)[1] for sh, sc in zip(shards, scores)]
        by_eid = torch.zeros(int(feat.eid.max()) + 1, device=emb.device)
        by_eid[feat.eid.long()] = whole_attn
        got = torch.zeros_like(by_eid)
        for sh, a in zip(shards, attn):
            got[sh.fwd.eid.long()] = a
        attn_err = close(got, by_eid, "the attention of a 4-way split against the single-device attention")
        total = None
        for s, (sh, a) in enumerate(zip(shards, attn)):
            part = place_rows(sh, spmm_csr_cuda(sh.fwd, v_pad[s * blk : (s + 1) * blk].contiguous(), val=a))
            total = part if total is None else total + part
        whole = dataclasses.replace(model.att_feat, val=whole_attn)
        res = check_product(f"AttIGCN attention, {SHARDS} shards summed", row_blocks(whole, d), emb, total[:n],
                            extra_roundings=SHARDS - 1)
    log(f"AttIGCN attention over a {SHARDS}-way split ({[sh.fwd.nnz for sh in shards]} edges): the attention within "
        f"{attn_err:.3g} of the single-device one, the partials summed within {res['max_err_over_limit']:.3g} of "
        f"their limit (max abs err {res['max_abs_err']:.3g})")
    shard0 = dataclasses.replace(shards[0].fwd, val=attn[0])
    return shard0, v_pad[:blk].contiguous(), {"attention_max_abs_err": attn_err, "product": res}


def families_phase(ds, card, rng, mesh) -> tuple:
    """Phase 13: the rest of the multi-GPU layer, over phase 12's group."""
    t_phase = time.perf_counter()
    out = {"edge": {}, "data": {}}
    run_routes, run_kinds = {}, {}

    def add(total, counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    kept = {}
    for name in EDGE_FAMILIES + DATA_ONLY_FAMILIES:
        data, model_cfg, trainer_cfg = family_configs(name, ds, rng)
        model = get_model(model_cfg, data)
        # the single-device reference, then data and edge mode on the same
        # model: each trainer re-initialises its weights from the seed
        single = get_trainer(trainer_cfg, data, model)
        want_grads = {}
        want = family_steps(single, grads=want_grads if name in EDGE_FAMILIES else None)
        res = {"single_losses": want.tolist()}
        dtr = get_trainer(trainer_cfg, data, model, mesh=mesh, mesh_mode="data")
        res["data_loss_max_abs_diff"] = same_losses(f"{name} data mode", family_steps(dtr), want)
        res["trainer"] = trainer_cfg["name"]
        out["data"][name] = res
        del dtr
        if name not in EDGE_FAMILIES:
            log(f"phase 13 {name} ({trainer_cfg['name']}), data mode: {FAMILY_STEPS} losses within "
                f"{res['data_loss_max_abs_diff']:.3g} of the single-device trainer's")
            continue
        edge = get_trainer(trainer_cfg, data, model, mesh=mesh, mesh_mode="edge")
        got_grads = {}
        got, routes, kinds = counted_run(lambda: family_steps(edge, grads=got_grads))
        add(run_routes, routes)
        add(run_kinds, kinds)
        res["edge_loss_max_abs_diff"] = same_losses(f"{name} edge mode", got, want)
        if name == "AttIGCN":
            res["att_shard_is_whole_layout"] = att_edge_losses(edge, model, got, want)
        res["edge_grad_max_err_over_bound"] = same_grads(f"{name} edge mode", got_grads, want_grads)
        del got_grads, want_grads
        _, per_step, per_step_kinds = counted_run(edge.step)
        res.update(edge_launches_run=routes, edge_collectives_run=kinds, launches_per_step=per_step,
                   collectives_per_step=per_step_kinds)
        res["edge_step_ms"] = median_ms(edge.step, reps=10)
        if not hasattr(single, "batches"):
            res["single_step_ms"] = median_ms(single.step, reps=10)
        # evaluate against the host oracle
        metrics = edge.eval("test")[1]
        oracle = calculate_metrics(data.test_data, edge.recommend("test"), edge.topks)
        for metric in ("Precision", "Recall", "NDCG"):
            for k in edge.topks:
                if abs(oracle[metric][k] - metrics[metric][k]) > 1e-6:
                    raise AssertionError(f"{name} edge evaluate {metric}@{k}: {metrics[metric][k]}, oracle "
                                         f"{oracle[metric][k]}")
        res["test_ndcg20"] = metrics["NDCG"][20]
        if name in EPOCH_END_FAMILIES:
            keys = model.view_keys
            before = [edge.placement.shard(model.views[k]).fwd.nnz for k in keys]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            edge.epoch_end()
            torch.cuda.synchronize()
            res["epoch_end_s"] = time.perf_counter() - t0
            res["reshard_ms"] = host_ms(lambda: [edge.placement.cut(model.views[k]) for k in keys], 3)
            for k in keys:
                v = edge.placement.shard(model.views[k])
                if v.fwd.nnz != model.views[k].nnz or not torch.equal(torch.sort(v.fwd.eid).values,
                                                                       torch.sort(model.views[k].eid).values):
                    raise AssertionError(f"{name}: the shard of view {k} does not hold the view's edges")
            if name == "DOSE_aug2" and getattr(model, "aug_feat", None) is None:
                raise AssertionError("DOSE_aug2: no augmented feature matrix after the epoch end")
            after, routes, kinds = counted_run(lambda: family_steps(edge, 2))
            add(run_routes, routes)
            add(run_kinds, kinds)
            res.update(views_nnz_before=before,
                       views_nnz_after=[edge.placement.shard(model.views[k]).fwd.nnz for k in keys],
                       losses_after_epoch_end=after.tolist(), launches_after_epoch_end=routes)
            if not np.isfinite(after).all():
                raise AssertionError(f"{name}: a loss after the epoch end is not finite")
        log(f"phase 13 {name}: edge and data mode, {FAMILY_STEPS} losses each within "
            f"{res['edge_loss_max_abs_diff']:.3g} / {res['data_loss_max_abs_diff']:.3g} of the single-device "
            f"trainer's, the first step's gradients within {res['edge_grad_max_err_over_bound']:.3g} of their "
            f"bounds; edge step {res['edge_step_ms']:.3f} ms (single-device {res.get('single_step_ms', 0):.3f}); "
            f"launches a step {per_step}; collectives a step {per_step_kinds}; evaluate = the host oracle (test "
            f"NDCG@20 {res['test_ndcg20']:.6f})" + (f"; epoch end {res['epoch_end_s']:.3f} s, the re-shard "
                                                     f"{res['reshard_ms']} ms" if "epoch_end_s" in res else ""))
        out["edge"][name] = res
        if name in ("DOSE_aug", "DOSE_aug2", "AttIGCN"):
            kept[name] = (model, edge)
        del single, edge
    out["edge_launches_run"], out["edge_collectives_run"] = run_routes, run_kinds
    for route in ("edge_shard_view", "edge_shard_view_transpose", "edge_shard_aug_feat_dropout",
                  "edge_shard_attention", "sddmm_csr/edge_shard_attention",
                  "sddmm_csr_backward/edge_shard_attention", "sddmm_csr/edge_shard_attention_d_values",
                  *(f"{k}/edge_shard_attention" for k in attention_csr.SOFTMAX_KERNELS)):
        if not run_routes.get(route):
            raise AssertionError(f"phase 13's edge runs launched no {route}: {run_routes}")

    # the 4-way splits on one card, against the whole products
    d = DOSE_CONFIG["embedding_size"]
    seed, p = int(rng.integers(0, 2**62)), DOSE_AUG2_CONFIG["dropout"]
    model, _ = kept["DOSE_aug"]
    view = model.views["aug_adj"]
    x = torch.as_tensor(rng.normal(0.0, 0.1, (view.n_rows, d)), dtype=torch.float32, device=view.col.device)
    with torch.no_grad():
        shards, x_pad, g_pad, times, err_v = split_on_card("DOSE_aug view", view, "edge_shard_view", x, x, None)
        v0 = shards[0]
        view_row = measure_spmm("DOSE_aug view shard 0 of 4", v0.fwd, x_pad[: v0.block].contiguous())
        view_t_row = measure_spmm("DOSE_aug view shard 0 of 4, transpose", v0.bwd, g_pad[v0.row_lo : v0.row_hi])
        del shards
        aug = kept["DOSE_aug2"][0].aug_feat
        xa = torch.as_tensor(rng.normal(0.0, 0.1, (aug.n_cols, d)), dtype=torch.float32, device=aug.col.device)
        ga = torch.as_tensor(rng.normal(0.0, 0.1, (aug.n_rows, d)), dtype=torch.float32, device=aug.col.device)
        shards, xa_pad, _, times_a, err_a = split_on_card("DOSE_aug2 augmented feature matrix", aug,
                                                          "edge_shard_aug_feat", xa, ga, (seed, p))
        a0 = shards[0]
        aug_row = measure_spmm("DOSE_aug2 augmented feature shard 0 of 4, dropout", a0.fwd,
                               xa_pad[: a0.block].contiguous(), drop=(seed, p))
        del shards
    att_model, att_edge = kept["AttIGCN"]
    att0, v0_rows, att_res = attention_split(att_model, att_edge._model_params(), rng)
    with torch.no_grad():
        att_row = measure_spmm("AttIGCN attention shard 0 of 4", att0, v0_rows)
    out["splits"] = {"view": {"times": times, "max_abs_err": err_v}, "aug_feat": {"times": times_a, "max_abs_err": err_a},
                     "attention": att_res}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 took {out['phase_s']:.1f} s")
    del kept
    return out, {"view": view_row, "view_transpose": view_t_row, "aug_feat_dropout": aug_row, "attention": att_row}


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
    reset_launch_counts()  # the serving path's counts were read above
    eval_ms = host_ms(lambda: ev_grown.evaluate(model, params, "test"), 3)
    sums_per_pass = device_metrics.batch_metric_sums_cuda.launches / 3
    log(f"metric-sums kernel launches an evaluate on the grown set: {sums_per_pass:g} (two a batch)")
    if sums_per_pass == 0 or sums_per_pass % 2:
        raise AssertionError(f"evaluate: {sums_per_pass} metric-sums launches a pass")
    topk_per_pass = topk_ops.masked_topk_cuda.launches / 3
    log(f"masked top-k kernel launches an evaluate on the grown set: {topk_per_pass:g} (one a batch)")
    if topk_per_pass != sums_per_pass / 2:
        raise AssertionError(f"evaluate: {topk_per_pass} masked top-k launches a pass, not one a batch")
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

    metric_rows = metric_sums_phase(card, rng)
    topk_rows = masked_topk_phase(card, rng)

    # 7. train, on a fresh model of the Gowalla-scale set: the kernel's
    # training uses at its layouts, then IGCNTrainer
    trainer = get_trainer(TRAINER_CONFIG, ds, get_model(IGCN_CONFIG, ds))
    sampler_rows = sampler_phase(card, {"main": trainer.sampler, "aux": trainer.aux_sampler})
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
    att_step = lmodels["AttIGCN"]["launches_per_step"]
    last_entries[0].update(d_values_max_abs_err=lrows["d_values_max_abs_err"],
                           step_peak_bytes=lmodels["AttIGCN"]["step_peak_bytes"],
                           step_added_bytes=lmodels["AttIGCN"]["step_added_bytes"],
                           plain_attention_step_peak_bytes=lmodels["AttIGCN"]["plain_attention"]["step_peak_bytes"],
                           plain_attention_step_added_bytes=lmodels["AttIGCN"]["plain_attention"]["step_added_bytes"])

    def att_entry(name, row, keys, per, replaces="inductive_recommendation_tpu/ops/attention_spmm.py:175"):
        keys = (keys,) if isinstance(keys, str) else keys
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_windowed", "plain_ms_windowed",
                  "library_ms_windowed", "max_abs_err", "kernel_device_ms_total")
        return {
            "name": name,
            "route": "cuda",
            "source": "inductive_recommendation_tpu_torch/ops/csrc/attention_csr.cu",
            "replaces": replaces,
            "tpu_kernel": None,
            "route_keys": list(keys),
            "launches": sum(att_run[k] for k in keys),
            "launches_per_step": sum(att_step[k] for k in keys),
            **{k: row[k] for k in fields},
            "per": per + "; no TPU kernel: the JAX package computes it with XLA ops (attention_spmm.py:16-34)",
            "detail": [row],
        }

    softmax_at = "inductive_recommendation_tpu/ops/attention_spmm.py:203-210"
    att_entries = [
        att_entry("sddmm_csr", lrows["sddmm_scores"], "sddmm_csr/attention",
                  f"AttIGCN's scores, {ATT_CONFIG['n_heads']} heads: the folded query qk [n_rows, h, 64] read once a "
                  "row into registers against the gathered table rows, + qb; library_ms: torch.sparse."
                  "sampled_addmm batched over the heads; launches: AttIGCN's epoch and evaluate"),
        att_entry("sddmm_csr_backward", lrows["sddmm_backward"], "sddmm_csr_backward/attention",
                  f"the scores' gradient, {ATT_CONFIG['n_heads']} heads: d(qk) and d(qb) from the scores' cotangent, "
                  "each table row gathered once an edge for every head, edge-balanced chunks with the cut rows "
                  "added in chunk order by a second launch (counted too); library_ms: torch.sparse.mm once a head "
                  "(h calls); earlier_path_*: the path it replaced, one SpMM a head on [table | 1 | 0 0 0] with a "
                  "cat and a stack"),
        att_entry("sddmm_csr_d_values", lrows["sddmm_d_values"], "sddmm_csr/attention_d_values",
                  "d(values) of the product with the attention as edge values: the cotangent's row . the table's "
                  "row, one head; library_ms: torch.sparse.sampled_addmm on the CSR"),
        att_entry("segment_softmax_csr", lrows["softmax"], ("softmax_stats/attention", "softmax_apply/attention"),
                  "the per-row softmax of each head at T and the head mean: softmax_stats (its chunk and cut-row "
                  "launches) then softmax_apply; library_ms: the torch ops it replaced (scatter_reduce amax, exp, "
                  "index_add)", softmax_at),
        att_entry("segment_softmax_csr_backward", lrows["softmax_backward"],
                  ("softmax_stats_backward/attention", "softmax_apply_backward/attention"),
                  "the scores' cotangent from the attention's: softmax_stats_backward then softmax_apply_backward; "
                  "library_ms: autograd's backward through the torch ops' softmax and head mean", softmax_at),
        att_entry("softmax_stats", lrows["softmax_stats"], "softmax_stats/attention",
                  "each row's max and sum of exp((x - max) / T) of each head, edge-balanced chunks with the cut rows "
                  "combined in chunk order by a second launch (counted too)", softmax_at),
        att_entry("softmax_apply", lrows["softmax_apply"], "softmax_apply/attention",
                  "p and its head mean from the row statistics, edge-balanced", softmax_at),
        att_entry("softmax_stats_backward", lrows["softmax_stats_backward"], "softmax_stats_backward/attention",
                  "each row's sum of p g of each head, the statistics pass in backward mode", softmax_at),
        att_entry("softmax_apply_backward", lrows["softmax_apply_backward"], "softmax_apply_backward/attention",
                  "g_s = p (g - c[row]) / (h T), the apply pass in backward mode", softmax_at),
    ]
    view["detail"].append(lrows["sgl_view"])

    # 11. the front door: the raw file, the preprocessing and the grid's IGCN
    # row through the command line; 12. the multi-GPU layer, its command-line
    # run in the same directory
    with tempfile.TemporaryDirectory(prefix="front_door_") as work:
        front = front_door_phase(card, {r: k for r, k in train["launches_per_step"].items() if k}, rng, work)
        log("front door: " + json.dumps(front))
        kernel.update(launches_cli=front["cli"]["launches"], route_launches_cli=front["cli"]["route_launches"])
        try:
            mesh, shard_fwd, shard_t, the_mesh = mesh_phase(ds, card, rng, work)
            families, frows = families_phase(ds, card, rng, the_mesh)
        finally:  # the group's store is in this directory: leave it before the directory goes
            if dist.is_initialized():
                dist.destroy_process_group()
    log("mesh: " + json.dumps(mesh))
    log("families: " + json.dumps(families))

    # 14. the training step replayed as a CUDA graph against the eager step
    log("graph step: " + json.dumps(graph_step_phase(card, ds)))
    max_err = max(max_err, mesh["shard_max_abs_err"], shard_fwd["max_abs_err"], shard_t["max_abs_err"])
    mroutes, mstep = mesh["train"]["route_launches_run"], mesh["train"]["launches_per_step"]
    shard_entries = [
        entry("spmm_csr_edge_shard", shard_fwd, mroutes["edge_shard"], mstep["edge_shard"],
              f"one rank's product in the edge-sharded layer (parallel/spmm.py): shard 0 of a {SHARDS}-way column "
              "split of the adjacency (A[:, blk_0] @ x_0); launches: the edge-mode IGCN epoch at mesh (1, world): "
              "its adjacency products and every forward product of its evaluations; every shard's time in the mesh "
              "line's shard_times", [shard_fwd]),
        entry("spmm_csr_edge_shard_transpose_dropout", shard_t, mroutes["edge_shard_transpose_dropout"],
              mstep["edge_shard_transpose_dropout"],
              f"the backward of a rank's feature product under dropout (p {IGCN_CONFIG['dropout']}, keyed by the "
              f"global edge id): shard 0's transpose CSR of a {SHARDS}-way split @ the all-gathered cotangent; "
              "launches: the edge-mode IGCN epoch", [shard_t]),
    ]
    for e in shard_entries:
        e["collectives_per_step"] = mesh["train"]["collectives_per_step"]
    max_err = max(max_err, *(r["max_abs_err"] for r in frows.values()))
    fruns, fedge = families["edge_launches_run"], families["edge"]
    family_entries = [
        entry("spmm_csr_edge_shard_view", frows["view"], fruns["edge_shard_view"],
              fedge["DOSE_aug"]["launches_per_step"]["edge_shard_view"],
              f"a rank's product with its shard of a DOSE_aug view (shard 0 of a {SHARDS}-way column split of the "
              "view selected at the epoch end, cut on the device); launches: phase 13's edge-mode runs of DOSE_aug, "
              "DOSE_aug2, SGL and HALF", [frows["view"]]),
        entry("spmm_csr_edge_shard_view_transpose", frows["view_transpose"], fruns["edge_shard_view_transpose"],
              fedge["DOSE_aug"]["launches_per_step"]["edge_shard_view_transpose"],
              "its backward: the shard's own transpose CSR (a block of a symmetric view is not symmetric) @ the "
              "all-gathered cotangent", [frows["view_transpose"]]),
        entry("spmm_csr_edge_shard_aug_feat_dropout", frows["aug_feat_dropout"], fruns["edge_shard_aug_feat_dropout"],
              fedge["DOSE_aug2"]["launches_after_epoch_end"]["edge_shard_aug_feat_dropout"] // 2,
              f"shard 0 of a {SHARDS}-way split of DOSE_aug2's augmented feature matrix under dropout "
              f"(p {DOSE_AUG2_CONFIG['dropout']}, keyed by the global edge id); launches: DOSE_aug2's edge-mode steps "
              "after its epoch end", [frows["aug_feat_dropout"]]),
        entry("spmm_csr_edge_shard_attention", frows["attention"], fruns["edge_shard_attention"],
              fedge["AttIGCN"]["launches_per_step"]["edge_shard_attention"],
              f"shard 0 of a {SHARDS}-way split of the feature matrix with its {ATT_CONFIG['n_heads']}-head "
              "attention as edge values (the row maxima and sums combined over the shards); launches: AttIGCN's "
              "edge-mode run", [frows["attention"]]),
    ]
    for e in att_entries:  # the same kernels on the shard path: phase 13's edge runs
        e["launches_edge_shard"] = sum(fruns.get(k.replace("/attention", "/edge_shard_attention"), 0)
                                       for k in e["route_keys"])
    metric_entry = {
        "name": "metric_sums",
        "route": "cuda",
        "source": "inductive_recommendation_tpu_torch/ops/csrc/metric_sums.cu",
        "replaces": "none (inductive_recommendation_tpu/eval/device_metrics.py::batch_metric_sums, XLA ops)",
        "launches_per_evaluate": sums_per_pass,
        "per": f"one batch of {TEST_BATCH} users, top 100, {len(METRIC_TOPKS)} cutoffs; *_ms: median of single "
        "calls, *_ms_windowed: median of windows of 10 back-to-back calls",
        "detail": list(metric_rows.values()),
    }
    topk_entry = {
        "name": "masked_topk",
        "route": "cuda",
        "source": "inductive_recommendation_tpu_torch/ops/csrc/masked_topk.cu",
        "replaces": "none (inductive_recommendation_tpu/ops/topk.py::masked_topk, a scatter and lax.top_k)",
        "launches_per_evaluate": topk_per_pass,
        "per": f"one batch of {TEST_BATCH} rows, top 100; *_ms: median of single calls, *_ms_windowed: median of "
        "windows of 10 back-to-back calls, host_us: the host's enqueue of a call",
        "detail": list(topk_rows.values()),
    }
    sampler_entry = {
        "name": "bpr_sample",
        "route": "cuda",
        "source": "inductive_recommendation_tpu_torch/ops/csrc/bpr_sample.cu",
        "replaces": "none (inductive_recommendation_tpu/data/sampling.py::sample_bpr_batch, XLA ops)",
        "per": f"one draw of {TRAINER_CONFIG['batch_size']} pairs; *_ms: median of single calls, *_ms_windowed: "
        "median of windows of 10 back-to-back calls, host_us: the host's enqueue of a draw",
        "detail": list(sampler_rows.values()),
    }
    print(json.dumps({"kernels": [kernel, transpose, dropout, view, *zoo_entries, *last_entries, *att_entries,
                                  *shard_entries, *family_entries, metric_entry, topk_entry,
                                  sampler_entry]}))
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
