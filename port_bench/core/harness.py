"""One run of one cell: set-up, the measured window, the traced sub-window
in a ``--trace 1`` run, the check, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name (``core/manifest.py``): the cell's entry in
``BENCHMARK.json`` names its configuration (a JSON file under ``paths``,
whose model's module is ``models/<model>.py``) and its traffic
(``traffic/<name>.json``, whose ``kind`` names the general driver
``kinds/<kind>.py``); each per-layer metric is read by
``metrics/<name>.py``; the check's limits are ``limits/<cell>.json``."""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from port_bench.core import judge as J
from port_bench.core import manifest as M
from port_bench.core.data import seed_words
from port_bench.core.guard import forbidden_modules
from port_bench.core.port import Probe
from port_bench.core.timing import breakdown, nvidia_smi


class RunError(Exception):
    """A run that must end with no result line."""


class Run:
    """The state of one run, handed to the kind's driver and the metric
    readers."""

    def __init__(self, root, manifest, cell, config, traffic, kind, seed, trace, device):
        self.root, self.manifest, self.cell = root, manifest, cell
        self.config, self.traffic, self.kind = config, traffic, kind
        self.bench = M.model(root, config["model"]["name"])  # the model's module (models/<model>.py)
        self.seed, self.trace_mode, self.device = int(seed), bool(trace), torch.device(device)
        self.trace = None  # core.timing.Trace of the traced sub-window
        self.window_s, self.units = None, 0
        self.probe = Probe(self.device, self.trace_mode)

    def cutoffs(self) -> list:
        """The evaluation's cutoffs: the mix's own where it gives them, else
        the trainer's."""
        return self.traffic.get("topks", self.config["trainer"]["topks"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_weights(self, shapes: dict) -> dict:
        """The weights, made on the device from the seed in one call a leaf,
        by the configuration's ``weights`` rule: ``{"normal": std}`` or
        ``{"fill": value}``."""
        g = torch.Generator(device=self.device).manual_seed(int(seed_words(self.seed, 3).generate_state(1)[0]))
        out = {}
        for name, shape in shapes.items():
            rule = self.config["weights"][name]
            t = torch.empty(shape, dtype=torch.float32, device=self.device)
            if "normal" in rule:
                t.normal_(0.0, float(rule["normal"]), generator=g)
            else:
                t.fill_(float(rule["fill"]))
            out[name] = t
        return out


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: end-to-end ones with trace off,
    per-layer ones with it on."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def run_cell(root, cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, limits=None) -> dict:
    """The result line's object. ``device`` None means the card, whose absence
    raises ``RunError``; tests pass ``"cpu"``."""
    manifest = M.load_manifest(root)
    cell = M.cell(manifest, cell_name)
    config = M.config(root, manifest, cell["config"])
    traffic = M.traffic(root, cell["traffic"])
    kind = M.kind(root, traffic["kind"])
    limits = M.limits(root, cell_name) if limits is None else limits
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"cell {cell_name} needs {cell['chips']} CUDA device(s); "
                           f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(root, manifest, cell_name, config, traffic, kind, seed, trace, device)
    wanted = cell_metrics(manifest, cell_name, trace)

    kind.setup(run)
    setup_s = time.perf_counter() - t_start
    e2e = kind.window(run, seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    metrics, extra = {}, {}
    if trace:
        run.trace = kind.profile(run)
        if run.device.type == "cuda" and not run.trace.device:
            raise RunError("the profiler recorded no device activity: the per-layer metrics are not measured")
        for m in wanted:
            value = M.reader(root, m["name"])(run)
            if value is None:
                print(f"port_bench: {m['name']} found nothing to read in this run", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra["busy_s"], extra["window_s"] = run.trace.busy_s, run.trace.window_s
        bd = breakdown(run.trace)
    else:
        e2e["setup_s"] = setup_s
        e2e["peak_mem_gib"] = peak / 2**30
        for m in wanted:
            if e2e.get(m["name"]) is None:
                raise RunError(f"end-to-end metric {m['name']} was not measured in cell {cell_name}")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    captured = kind.capture(run)
    run.model = run.trainer = run.evaluator = None
    run.probe.remove()
    run.probe = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = J.within(kind.judge(run, captured), limits)

    found = forbidden_modules()
    if found:
        raise RunError("modules of JAX or of the JAX package were loaded: " + ", ".join(found))
    n_failed = sum(not ok for _, _, ok in checks.values())
    result = {
        "correct": n_failed == 0,
        "attempted": int(run.units),
        "failed": int(n_failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if run.device.type == "cuda" else run.device.type,
            "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
            **extra,
        },
    }
    if trace:
        result["breakdown"] = bd
    result["card"] = nvidia_smi("name,power.limit,clocks.sm,clocks.mem") if run.device.type == "cuda" else "cpu"
    result["window"] = {"seconds": run.window_s, "units": run.units}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim, _) in checks.items()}
    for name, (v, lim, ok) in checks.items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    return result


def dumps(result: dict) -> str:
    return json.dumps(result, separators=(",", ":"))
