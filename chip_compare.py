#!/usr/bin/env python3
"""AttIGCN's attention kernels and training step on one CUDA card, for
comparing two checkouts, on the Gowalla-scale synthetic set of
``chip_smoke.py`` (AttIGCN at IGCN's grid width, 4 heads, batch 2,048):

    python3 /path/to/chip_compare.py      # from the root of a checkout

The package measured is the checkout's own (its root goes first on the
path), so two commits compare by running one copy of the script from the
root of each, in turns on one card (parent, change, change, parent). It
prints, for the checkout:

- the scores ``sddmm_csr`` at 4 heads (the folded query of the model's
  random weights) and at one head (d(values): a random cotangent), the
  scores' gradient (``torch.autograd.grad`` through ``attention_scores``
  from a random cotangent: the checkout's ``_Scores.backward``, whatever
  it launches), ``segment_softmax_csr`` and
  ``segment_softmax_csr_backward`` on the feature matrix (random scores
  from the seed, T as AttIGCN's), through their public entry points: the
  device time of each kernel they launch (torch.profiler, mean over 20
  calls) and the median of 15 windows of 10 calls (CUDA events); and the
  SpMM's chunk kernel on the feature matrix at d 64, whose gathers (nnz x
  64 x 4 B) over its device time give the card's L2 gather rate;
- one training step, single-device and edge mode at mesh (1, 1): after 3
  steps, 3 profiled steps (device launches, device busy ms, host ms of
  each) and the median of 20 steps on the host clock, each ended by a
  synchronise."""

import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from inductive_recommendation_tpu_torch import get_model, get_trainer  # noqa: E402
from inductive_recommendation_tpu_torch.data import quick_synthetic_dataset  # noqa: E402
from inductive_recommendation_tpu_torch.ops import _build, attention_csr  # noqa: E402
from inductive_recommendation_tpu_torch.ops.attention_spmm import folded_query  # noqa: E402
from inductive_recommendation_tpu_torch.ops.csr_spmm import spmm_csr_cuda  # noqa: E402
from inductive_recommendation_tpu_torch.parallel import init_distributed, make_mesh  # noqa: E402

N_USERS, N_ITEMS, N_INTER, SEED = 29858, 40981, 1_200_000, 0  # chip_smoke.py's set
TRAINER = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1,
           "batch_size": 2048, "test_batch_size": 512, "topks": [20]}
CONFIG = {"name": "AttIGCN", "embedding_size": 64, "n_layers": 3, "dropout": 0.3, "feature_ratio": 1, "n_heads": 4}


def profiled(step):
    """[(device launches, device busy ms, host ms)] of 3 profiled steps, and
    the median step ms of 20 more."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
        counts.append((len(kernels), round(busy, 3), round(host, 3)))
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return counts, float(np.median(times))


def kernel_times(fn, calls=20, windows=15, inner=10):
    """({kernel name: mean device ms a launch over ``calls`` profiled
    calls}, {kernel name: (device ms, launches) a call}, the median per-call
    ms of ``windows`` windows of ``inner`` calls). Launches a call that are
    not whole show that the profiler dropped events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, seen = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"<.*", "", e.name).split("::")[-1].split("(")[0].strip()
            total[name] = total.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            seen[name] = seen.get(name, 0) + 1
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    per_call = {k: (round(total[k] / calls, 5), seen[k] / calls) for k in total}
    return {k: round(total[k] / seen[k], 5) for k in total}, per_call, float(np.median(times))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare.py needs a CUDA card")
    here = os.path.basename(os.getcwd())
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"{here} build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}", flush=True)
    for name, text in logs.items():
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = re.sub(r".*?(sddmm\w*|softmax\w*|spmm\w*).*", r"\1", line)
            elif "Used" in line and kernel.startswith("sddmm"):
                print(f"{here} build {name} {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
    with tempfile.TemporaryDirectory() as work:
        init_distributed(init_method="file://" + os.path.join(work, "pg"))
        ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=SEED)
        model = get_model(CONFIG, ds)
        att, d, h = model.att_feat, CONFIG["embedding_size"], CONFIG["n_heads"]
        dev = att.row_ptr.device
        gen = torch.Generator(device=dev).manual_seed(SEED)
        scores = torch.randn(att.nnz, h, generator=gen, device=dev) * 30.0
        g = torch.randn(att.nnz, generator=gen, device=dev)
        g_s = torch.randn(att.nnz, h, generator=gen, device=dev) * 1e-3
        g_rows = torch.randn(att.n_rows, 1, d, generator=gen, device=dev)
        temp, params = model.temperature, model.init_params(torch.Generator(device=dev).manual_seed(SEED))
        emb = params["embedding"][: model.feat_n_cols].detach()
        rp, col = att.row_ptr, att.col
        with torch.no_grad():
            q = (spmm_csr_cuda(model.feat, emb) @ params["weight_q.w"] + params["weight_q.b"]).reshape(-1, h, d)
            qk, qb = (t.contiguous() for t in folded_query(q, params["weight_k.w"], params["weight_k.b"], d))
        qk_req, qb_req = qk.clone().requires_grad_(True), qb.clone().requires_grad_(True)
        out = attention_csr.attention_scores(att, qk_req, qb_req, emb)
        with torch.no_grad():
            p, _ = attention_csr.segment_softmax_csr(rp, scores, temp)
            for name, fn in (
                ("sddmm_csr h 4", lambda: attention_csr.sddmm_csr(rp, col, qk, emb, qb)),
                ("sddmm_csr h 1", lambda: attention_csr.sddmm_csr(rp, col, g_rows, emb, route="attention_d_values")),
                ("scores gradient", lambda: torch.autograd.grad(out, [qk_req, qb_req], g_s, retain_graph=True)),
                ("spmm_csr feat d 64", lambda: spmm_csr_cuda(att, emb)),
                ("segment_softmax_csr", lambda: attention_csr.segment_softmax_csr(rp, scores, temp)),
                ("segment_softmax_csr_backward",
                 lambda: attention_csr.segment_softmax_csr_backward(rp, p, g, temp)),
            ):
                device, per_call, windowed = kernel_times(fn)
                print(f"{here} {name}: device ms a launch by kernel {device}; a call: (device ms, launches) by "
                      f"kernel {per_call}, device ms {sum(v[0] for v in per_call.values()):.5f}; windows of 10 calls "
                      f"{windowed:.5f} ms", flush=True)
                if name.startswith("spmm"):
                    chunk_ms = device.get("spmm_chunk_kernel")
                    gathered = att.nnz * d * 4
                    print(f"{here} L2 gather rate: {gathered / 1e6:.1f} MB gathered by spmm_chunk_kernel in "
                          f"{chunk_ms} ms = {gathered / chunk_ms / 1e9:.3f} TB/s", flush=True)
        del out, qk_req, qb_req
        single = get_trainer(TRAINER, ds, model)
        edge = get_trainer(TRAINER, ds, model, mesh=make_mesh(1, 1), mesh_mode="edge")
        for name, trainer in (("single", single), ("edge", edge)):
            counts, ms = profiled(trainer.step)
            print(f"{here} {name} step: (device launches, device busy ms, host ms) of 3 profiled steps {counts}; "
                  f"median step {ms:.3f} ms", flush=True)
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
