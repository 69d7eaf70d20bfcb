"""Timing helpers: the profiler's device timeline, its busy union and idle
gaps, the breakdown the result line carries, and the card's name, power
limit and clocks. The busy union and the kernel sums are those of the
repo's ``chip_smoke.py::device_breakdown``; the idle gaps are new."""

from __future__ import annotations

import dataclasses
import subprocess
import time

import torch


@dataclasses.dataclass
class Trace:
    """What a profiled sub-window left: device intervals (s, on the
    profiler's clock), host op intervals, the sub-window's wall length and
    the units (steps or passes) and launches by route it held."""

    device: list  # [(start_s, end_s, name)]
    host: list  # [(start_s, end_s, name)]
    window_s: float
    units: int
    launches: dict

    @property
    def busy_s(self) -> float:
        return busy_union(self.device)

    def device_s(self, match) -> float:
        """Summed device time of the kernels whose name ``match`` accepts."""
        return sum(e - s for s, e, n in self.device if match(n))


def busy_union(spans) -> float:
    """Length of the union of [start, end) intervals."""
    busy, run_start, run_end = 0.0, None, None
    for s, e, _ in sorted(spans):
        if run_end is None or s > run_end:
            if run_end is not None:
                busy += run_end - run_start
            run_start, run_end = s, e
        else:
            run_end = max(run_end, e)
    return busy + (run_end - run_start if run_end is not None else 0.0)


def profiled(fn, device) -> tuple:
    """Runs ``fn`` under ``torch.profiler`` (CPU and CUDA activity); returns
    (fn's result, device spans, host spans, wall seconds). User annotations
    are left out of the device spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return out, dev, host, wall


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps of the device, each named by the host op that overlaps it most
    (the innermost among equals); seconds as measured."""
    by_name = {}
    for s, e, n in trace.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, run_end = [], None
    for s, e, _ in sorted(trace.device):
        if run_end is not None and s > run_end:
            gaps.append((run_end, s))
        run_end = e if run_end is None else max(run_end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        best, best_key = "host", (0.0, 0.0)
        for s, e, n in trace.host:
            ov = min(b, e) - max(a, s)
            if ov > 0 and (ov, -(e - s)) > best_key:
                best, best_key = n, (ov, -(e - s))
        named.append([best, b - a])
    return {"device_ops": [[short(n), t] for n, t in ops], "idle_gaps": [[short(n), t] for n, t in named]}


def short(name: str, limit: int = 160) -> str:
    """A kernel's name cut to ``limit`` characters (template arguments run
    to thousands)."""
    return name if len(name) <= limit else name[: limit - 3] + "..."


def nvidia_smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unavailable"
