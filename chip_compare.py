#!/usr/bin/env python3
"""AttIGCN's row softmax and training step on one CUDA card, for comparing
two checkouts, on the Gowalla-scale synthetic set of ``chip_smoke.py``
(AttIGCN at IGCN's grid width, 4 heads, batch 2,048):

    python3 /path/to/chip_compare.py      # from the root of a checkout

The package measured is the checkout's own (its root goes first on the
path), so two commits compare by running one copy of the script from the
root of each, in turns on one card (parent, change, change, parent). It
prints, for the checkout:

- ``segment_softmax_csr`` and ``segment_softmax_csr_backward`` on the
  feature matrix (random scores from the seed, T as AttIGCN's), through
  their public entry points: the device time of each kernel they launch
  (torch.profiler, mean over 20 calls) and the median of 15 windows of 10
  calls (CUDA events);
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
from inductive_recommendation_tpu_torch.ops import attention_csr  # noqa: E402
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
    """({kernel name: mean device ms over ``calls`` profiled calls}, the
    median per-call ms of ``windows`` windows of ``inner`` calls)."""
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
    return {k: round(total[k] / seen[k], 5) for k in total}, float(np.median(times))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare.py needs a CUDA card")
    here = os.path.basename(os.getcwd())
    with tempfile.TemporaryDirectory() as work:
        init_distributed(init_method="file://" + os.path.join(work, "pg"))
        ds = quick_synthetic_dataset(N_USERS, N_ITEMS, N_INTER, seed=SEED)
        model = get_model(CONFIG, ds)
        att = model.att_feat
        gen = torch.Generator(device=att.row_ptr.device).manual_seed(SEED)
        scores = torch.randn(att.nnz, CONFIG["n_heads"], generator=gen, device=att.row_ptr.device) * 30.0
        g = torch.randn(att.nnz, generator=gen, device=att.row_ptr.device)
        temp = model.temperature
        with torch.no_grad():
            p, _ = attention_csr.segment_softmax_csr(att.row_ptr, scores, temp)
            for name, fn in (
                ("segment_softmax_csr", lambda: attention_csr.segment_softmax_csr(att.row_ptr, scores, temp)),
                ("segment_softmax_csr_backward",
                 lambda: attention_csr.segment_softmax_csr_backward(att.row_ptr, p, g, temp)),
            ):
                device, windowed = kernel_times(fn)
                print(f"{here} {name}: device ms by kernel {device} (total {sum(device.values()):.5f}); windows of "
                      f"10 calls {windowed:.5f} ms", flush=True)
        single = get_trainer(TRAINER, ds, model)
        edge = get_trainer(TRAINER, ds, model, mesh=make_mesh(1, 1), mesh_mode="edge")
        for name, trainer in (("single", single), ("edge", edge)):
            counts, ms = profiled(trainer.step)
            print(f"{here} {name} step: (device launches, device busy ms, host ms) of 3 profiled steps {counts}; "
                  f"median step {ms:.3f} ms", flush=True)
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
