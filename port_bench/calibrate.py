"""The readings the check's limits are set from (PERF.md, "Correct"): for
one cell, on each seed, the numbers of a sound run of the program; on the
first seeds, the numbers of the control (the reference in the next lower
precision, put in the program's place) and of each fault the cell can have
(``core/faults.py``), planted in the program. One process, runs one after
another, each with a short window at the cell's own load.

    python3 port_bench/calibrate.py --workload igcn_gowalla.train --seeds 11,12,13 \\
        --control-seeds 3 --fault-seeds 3 --seconds 2 --out chiprun_out/calibrate.jsonl

Prints a JSON line for each reading, and a summary line: for each number
the largest sound reading and the smallest control and fault readings."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def one(root, cell, seed, seconds, device, fault=None, control=False):
    """{'numbers': ..., 'control': ...} of one set-up and window."""
    import torch

    from port_bench.core import faults
    from port_bench.core import manifest as M
    from port_bench.core.harness import Run

    manifest = M.load_manifest(root)
    entry = M.cell(manifest, cell)
    traffic = M.traffic(root, entry["traffic"])
    kind = M.kind(root, traffic["kind"])
    run = Run(root, manifest, cell, M.config(root, manifest, entry["config"]), traffic, kind, seed, False, device)
    patch = faults.FAULTS[fault](traffic["kind"]) if fault else contextlib.nullcontext()
    with patch:
        kind.setup(run)
        kind.window(run, seconds)
        cap = kind.capture(run)
        run.probe.remove()  # before the patch is undone: the probe wraps what it patched
    run.model = run.trainer = run.evaluator = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"numbers": kind.judge(run, cap)}
    if control:
        out["control"] = kind.judge(run, kind.control_outputs(run, cap))
    return out


def main(argv=None, root=ROOT, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default=None, help="comma-separated; default: every fault of the cell's kind")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.core import faults
    from port_bench.core import manifest as M

    device = device or "cuda"
    manifest = M.load_manifest(root)
    kind_name = M.traffic(root, M.cell(manifest, args.workload)["traffic"])["kind"]
    names = args.faults.split(",") if args.faults else list(faults.KIND_FAULTS[kind_name])
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = []
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = dict(rec, workload=args.workload, t=time.perf_counter() - T_START)
        lines.append(rec)
        text = json.dumps(rec)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    for i, seed in enumerate(seeds):
        got = one(root, args.workload, seed, args.seconds, device, control=i < args.control_seeds)
        emit({"seed": seed, "what": "sound", "numbers": got["numbers"]})
        if "control" in got:
            emit({"seed": seed, "what": "control", "numbers": got["control"]})
    for fault in names:
        for seed in seeds[: args.fault_seeds]:
            try:
                got = one(root, args.workload, seed, args.seconds, device, fault=fault)
                emit({"seed": seed, "what": fault, "numbers": got["numbers"]})
            except Exception as exc:  # a fault that crashes the program has failed, with no number
                emit({"seed": seed, "what": fault, "error": f"{type(exc).__name__}: {exc}"})
    summary = {}
    for rec in lines:
        for name, v in rec.get("numbers", {}).items():
            s = summary.setdefault(name, {})
            key = "sound_max" if rec["what"] == "sound" else rec["what"] + "_min"
            s[key] = v if key not in s else (max(s[key], v) if key == "sound_max" else min(s[key], v))
    emit({"what": "summary", "summary": summary,
          "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"})
    if sink:
        sink.close()
    return summary


if __name__ == "__main__":
    main()
