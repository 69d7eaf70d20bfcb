"""The readers of the program's spans (``core/spans.py`` and the
``metrics/`` that use it) on traces made by hand, and the traced cells on
the CPU, where every span metric of a cell reads a number and the launch
metrics read nothing (the CPU launches no kernel)."""

import json
import time
import types

import pytest

from conftest import ROOT

from port_bench.core import manifest as M
from port_bench.core import spans
from port_bench.core.harness import run_cell
from port_bench.core.timing import Trace

SEED = 2**31 + 4057
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in MANIFEST["per_layer"] if m["source"] == "program_span"]


def _trace(host, units=2):
    return Trace(device=[], host=host, window_s=1.0, units=units, launches={})


# two steps: each a step range holding a sample range with one launch and a
# forward range with two; one launch between the steps, one inside a step
# but in no phase, and a sample range nested in another of the same name
HOST = [
    (0.000, 0.010, "irt.train.step"),
    (0.000, 0.004, "irt.train.sample"),
    (0.001, 0.002, "irt.train.sample"),
    (0.001, 0.0011, "cudaLaunchKernel"),
    (0.004, 0.009, "irt.train.forward"),
    (0.005, 0.0051, "cudaLaunchKernel"),
    (0.006, 0.0061, "cuLaunchKernel"),
    (0.0095, 0.0096, "cudaLaunchKernelExC"),
    (0.011, 0.0112, "cudaLaunchKernel"),
    (0.012, 0.020, "irt.train.step"),
    (0.012, 0.015, "irt.train.sample"),
    (0.0125, 0.0126, "cudaGraphLaunch"),
    (0.015, 0.019, "irt.train.forward"),
    (0.016, 0.0161, "cudaLaunchKernel"),
    (0.0185, 0.0186, "cudaLaunchKernel"),
    (0.0149, 0.0152, "cudaLaunchKernel"),  # crosses sample's end: in the step, not in sample
    (0.003, 0.004, "aten::mul"),
]


def test_host_time_is_the_union_per_unit():
    t = _trace(HOST)
    assert spans.host_s(t, "irt.train.sample") == pytest.approx(0.004 + 0.003)
    assert spans.ms_per_unit(t, "irt.train.sample") == pytest.approx(3.5)
    assert spans.ms_per_unit(t, "irt.train.forward") == pytest.approx((5 + 4) / 2)
    assert spans.ms_per_unit(t, "irt.train.step") == pytest.approx(9.0)
    assert spans.host_s(t, "irt.train.sample", "irt.train.forward") == pytest.approx(0.009 + 0.007)


def test_launches_inside_and_only_inside():
    t = _trace(HOST)
    assert spans.launches(t, "irt.train.sample") == 2
    assert spans.launches(t, "irt.train.forward") == 4
    assert spans.launches(t, "irt.train.step") == 8  # the one between the steps is out
    assert spans.launches_per_unit(t, "irt.train.step") == 4.0


def test_absent_span_or_no_launch_reads_none():
    t = _trace(HOST)
    assert spans.host_s(t, "irt.train.backward") is None
    assert spans.ms_per_unit(t, "irt.train.backward") is None
    assert spans.launches(t, "irt.train.backward") is None
    cpu = _trace([h for h in HOST if not h[2].startswith(spans.LAUNCH_PREFIXES)])
    assert spans.ms_per_unit(cpu, "irt.train.sample") == pytest.approx(3.5)
    assert spans.launches(cpu, "irt.train.sample") is None


def _run(trace):
    return types.SimpleNamespace(trace=trace)


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_each_reader_reads_its_span_and_none_without(metric):
    read = M.reader(ROOT, metric)
    assert read(_run(_trace(HOST[-1:], units=3))) is None
    names = {"sample": ["irt.train.sample"], "forward": ["irt.train.forward"], "backward": ["irt.train.backward"],
             "optimizer": ["irt.train.optimizer"], "step": ["irt.train.step"], "score": ["irt.eval.score"],
             "topk": ["irt.eval.topk"], "metric_sums": ["irt.eval.metric_sums"],
             "evaluator_build": ["irt.eval.evaluator_build", "irt.eval.buckets"],
             "ground_truth": ["irt.eval.ground_truth"]}
    stem = metric.split(".")[0].rsplit("_", 1)[0]
    host = []
    for k, name in enumerate(names[stem]):
        host += [(k, k + 0.006, name), (k + 0.001, k + 0.0011, "cudaLaunchKernel")]
    host += [(0.5, 0.5001, "cudaLaunchKernel"), (0.5, 0.6, "irt.other")]
    got = read(_run(_trace(host, units=3)))
    if metric.split(".")[0].endswith("_launches"):
        assert got == pytest.approx(len(names[stem]) / 3)
    elif metric.startswith(("evaluator_build", "ground_truth")):  # per round: the sub-window is one
        assert got == pytest.approx(6.0 * len(names[stem]))
    else:
        assert got == pytest.approx(6.0 / 3)


@pytest.mark.parametrize("cell", ["igcn_gowalla.train", "igcn_gowalla.eval", "igcn_gowalla.inductive"])
def test_traced_cell_on_the_cpu_reads_every_span_time(tiny_root, cell):
    r = run_cell(tiny_root, cell, SEED, 0.3, True, time.perf_counter(), device="cpu",
                 limits=M.limits(ROOT, cell))
    assert r["correct"], r["checks"]
    mine = [m for m in SPAN_METRICS if cell in m["workloads"]]
    assert mine
    for m in mine:
        if m["unit"] == "launches":
            assert m["name"] not in r["metrics"]
        else:
            assert r["metrics"][m["name"]]["value"] > 0, m["name"]
