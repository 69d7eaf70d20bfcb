#!/usr/bin/env python3
"""The port's multi-GPU layer across cards, one process a card over NCCL:

    torchrun --standalone --nproc_per_node 4 chip_mesh.py     # on a machine with 4 cards
    torchrun --standalone --nproc_per_node 4 chip_mesh.py --models AttIGCN   # one model's runs

``chip_smoke.py`` runs the layer at world 1 (one card); this script runs what
exists only across cards. On the Gowalla-scale synthetic set of
``chip_smoke.py``, with IGCN's grid row (d 64, 3 layers, dropout 0.3, batch
2,048), DOSE_aug's (the same width, aug_num 500,000) and AttIGCN (4 heads),
every rank:

1. joins the NCCL group (``parallel.init_distributed``: torchrun's
   environment, ``cuda:LOCAL_RANK``);
2. for each model trains a single-device trainer of the seed on its own card
   for ``STEPS`` steps: the reference, the same on every rank;
3. for each of the model's meshes (IGCN and DOSE_aug: edge (1, W), edge
   (2, W / 2) and data (2, W / 2) with W the world size; AttIGCN: edge
   (1, W)): trains the port's trainer ``STEPS`` steps from the same seed,
   holds every loss to the reference's within 1e-5 (the same batches,
   dropout masks and views; AttIGCN, whose softmax combines the shards'
   row statistics, within ``LOSS_TOL``), counts one step's SpMM launches by route and
   collectives by kind (with AttIGCN's attention kernel launches), times the step (the median of ``TIMED`` steps, each
   ended by a synchronise on every rank) and its peak device memory, and
   holds its mesh evaluator's test metrics to a single-device evaluator's on
   the gathered weights within 1e-6;
4. times its own shard of the adjacency's W-way split, forward and
   transpose, against ``torch.sparse.mm`` on the same shard.

Any failed check raises, and torchrun then exits with a code other than 0.
Rank 0 prints the card's name and power limit first and one JSON object of
the numbers last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from inductive_recommendation_tpu_torch import get_model, get_trainer
from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset
from inductive_recommendation_tpu_torch.eval import Evaluator
from inductive_recommendation_tpu_torch.graph import sym_normalized_adjacency
from inductive_recommendation_tpu_torch.models import params_from_jax
from inductive_recommendation_tpu_torch.ops import attention_csr, spmm_csr_cuda
from inductive_recommendation_tpu_torch.ops.csr_spmm import reset_launch_counts
from inductive_recommendation_tpu_torch.parallel import (
    build_edge_sharded_spmm,
    counts,
    init_distributed,
    make_mesh,
    reset_collective_counts,
)

SEED = 0
N_USERS, N_ITEMS, N_INTER = 29858, 40981, 1_200_000  # chip_smoke.py's Gowalla-scale set
IGCN_CONFIG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3, "dropout": 0.3, "feature_ratio": 1}
TRAINER_CONFIG = {
    "name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 0.0, "aux_reg": 0.01,
    "n_epochs": 1, "batch_size": 2048, "test_batch_size": 512, "topks": [20],
}
# (model config, trainer config, meshes as (mode, 'data' size)) of each model
MODELS = (
    (IGCN_CONFIG, TRAINER_CONFIG, (("edge", 1), ("edge", 2), ("data", 2))),
    (dict(IGCN_CONFIG, name="DOSE_aug", aug_num=500_000),
     dict(TRAINER_CONFIG, name="DOSEaugTrainer", aux_reg=0.001, contrastive_reg=0.1),
     (("edge", 1), ("edge", 2), ("data", 2))),
    (dict(IGCN_CONFIG, name="AttIGCN", n_heads=4), TRAINER_CONFIG, (("edge", 1),)),
)
STEPS = 20
TIMED = 30
# each loss against the single-device reference's, relative to max(1, |loss|)
LOSS_TOL = {"AttIGCN": 1.2e-7}


def log(*args):
    if dist.get_rank() == 0:
        print(*args, flush=True)


def step_ms(step, reps=TIMED, warmup=3) -> float:
    """The median of ``reps`` steps on the host clock, each ended by a
    synchronise on this rank (the collectives tie the ranks together)."""
    for _ in range(warmup):
        step()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def windowed(fn, reps=15, inner=10, warmup=5) -> float:
    """Per-call ms in windows of ``inner`` back-to-back calls (CUDA events),
    the median over ``reps`` windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def close_metrics(got, want, what):
    for name in want:
        for k, v in want[name].items():
            if abs(got[name][k] - v) > 1e-6:
                raise AssertionError(f"{what}: {name}@{k} {got[name][k]} against the single-device {v}")


def run_mesh(ds, model_cfg, trainer_cfg, mode, shape, ref_losses, single_ms, dev) -> dict:
    mesh = make_mesh(*shape)
    name = model_cfg["name"]
    # the model's own table (no table_align): the same init as the reference;
    # data mode pads the rows it shards
    trainer = get_trainer(trainer_cfg, ds, get_model(model_cfg, ds), mesh=mesh, mesh_mode=mode)
    losses = np.array([float(trainer.step()) for _ in range(STEPS)])
    diff = np.abs(losses - ref_losses)
    if not (diff <= LOSS_TOL.get(name, 1e-5) * np.maximum(1.0, np.abs(ref_losses))).all():
        raise AssertionError(f"{name} {mode} {shape}: losses {losses} against the single-device {ref_losses}")
    reset_launch_counts()
    attention_csr.reset_launch_counts()
    reset_collective_counts()
    trainer.step()
    torch.cuda.synchronize()
    launches = {k: v for k, v in {**spmm_csr_cuda.route_launches, **attention_csr.route_launches}.items() if v}
    kinds = dict(counts.by_kind)
    torch.cuda.reset_peak_memory_stats()
    ms = step_ms(trainer.step)
    peak = torch.cuda.max_memory_allocated()
    # the mesh evaluator against a single-device one on the gathered weights
    got = trainer.eval("test")[1]
    single = get_model(model_cfg, ds)
    params = params_from_jax(single, {k: v.detach().cpu().numpy() for k, v in trainer._model_params().items()})
    want = Evaluator(ds, trainer_cfg["topks"], trainer_cfg["test_batch_size"], device=dev).evaluate(
        single, params, "test")[1]
    close_metrics(got, want, f"{name} {mode} {shape} evaluate")
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, int(peak))
    out = {
        "model": name, "mode": mode, "mesh": list(shape), "loss_max_abs_diff_single": float(diff.max()), "step_ms": ms,
        "examples_per_s": trainer_cfg["batch_size"] / ms * 1e3, "step_over_single": ms / single_ms,
        "launches_per_step": launches, "collectives_per_step": kinds,
        "peak_bytes_by_rank": peaks, "test_ndcg20": got["NDCG"][20],
    }
    log(f"{name} {mode} mesh {shape}: {STEPS} losses within {diff.max():.3g} of the single-device trainer's; step "
        f"{ms:.3f} ms ({out['examples_per_s']:.0f} examples/s, {out['step_over_single']:.2f}x the single-device "
        f"step); launches a step {launches}; collectives {kinds}; peak memory by rank {out['peak_bytes_by_rank']}; "
        f"test metrics = single-device on the gathered weights (NDCG@20 {got['NDCG'][20]:.6f})")
    return out


def shard_times(ds, world, rank, dev) -> dict:
    """This rank's shard of the adjacency's ``world``-way split: forward and
    transpose products, the kernel against torch.sparse.mm (windowed)."""
    n = ds.n_users + ds.n_items
    row, col, val = sym_normalized_adjacency(ds.train_array, ds.n_users, ds.n_items)
    emat = build_edge_sharded_spmm(row, col, val, (n, n), world, rank, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(emat.block, 64, device=dev, generator=gen)
    g = torch.randn(emat.row_hi - emat.row_lo, 64, device=dev, generator=gen)  # the rows the shard's edges span
    out = {"rank": rank, "nnz": emat.fwd.nnz, "rows": [emat.row_lo, emat.row_hi]}
    for side, mat, operand in (("forward", emat.fwd, x), ("transpose", emat.bwd, g)):
        lib = torch.sparse_csr_tensor(mat.row_ptr, mat.col, mat.val, size=mat.shape)
        with torch.no_grad():
            out[f"{side}_ms"] = windowed(lambda m=mat, o=operand: spmm_csr_cuda(m, o))
            out[f"{side}_library_ms"] = windowed(lambda l=lib, o=operand: torch.sparse.mm(l, o))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", nargs="+", default=[m["name"] for m, _, _ in MODELS],
                        choices=[m["name"] for m, _, _ in MODELS], help="the models to run (default: all)")
    args = parser.parse_args()
    dev = init_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    log(f"torch {torch.__version__}, {world} ranks over {dist.get_backend()}, {torch.cuda.device_count()} cards")
    if world < 2 or world % 2:
        raise SystemExit(f"chip_mesh.py needs an even world of 2 or more ranks, got {world}")
    ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=SEED)
    runs, single_ms = [], {}
    for model_cfg, trainer_cfg, meshes in MODELS:
        name = model_cfg["name"]
        if name not in args.models:
            continue
        single = get_trainer(trainer_cfg, ds, get_model(model_cfg, ds))
        ref = np.array([float(single.step()) for _ in range(STEPS)])
        single_ms[name] = step_ms(single.step)
        log(f"single-device {name} step on each card: {single_ms[name]:.3f} ms")
        del single
        runs += [run_mesh(ds, model_cfg, trainer_cfg, mode, (n_data, world // n_data), ref, single_ms[name], dev)
                 for mode, n_data in meshes]
    shards = [None] * world
    dist.all_gather_object(shards, shard_times(ds, world, rank, dev))
    log(f"adjacency shards of the {world}-way split, ms windowed (kernel / torch.sparse.mm): " + "; ".join(
        f"{s['rank']}: {s['nnz']} edges in rows {s['rows']}, forward {s['forward_ms']:.4f} / {s['forward_library_ms']:.4f}, "
        f"transpose {s['transpose_ms']:.4f} / {s['transpose_library_ms']:.4f}" for s in shards))
    log(json.dumps({"world": world, "single_step_ms": single_ms, "meshes": runs, "shards": shards}))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
