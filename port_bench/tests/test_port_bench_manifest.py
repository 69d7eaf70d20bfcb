"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name."""

import json
import re

from conftest import ROOT

from port_bench.core import manifest as M
from port_bench.core.harness import cell_metrics

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "port_bench/run.py"]
    assert MANIFEST["paths"] == ["port_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    assert M.problems(MANIFEST) == []
    for group, allowed in KEYS.items():
        for e in MANIFEST[group]:
            assert set(e) <= allowed, (group, e["name"], set(e) - allowed)
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert LINE.match(e["why"]), e["name"]
    for c in MANIFEST["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(M.NAME.match(k) for k in c["reduced"])
    for m in MANIFEST["per_layer"]:
        assert LINE.match(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert len(m["unit"]) <= 16 and M.UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        names = {m["name"] for m in cell_metrics(MANIFEST, w["name"], False)}
        assert "setup_s" in names and len(names - {"setup_s"}) >= 1, w["name"]
        layer = cell_metrics(MANIFEST, w["name"], True)
        assert layer, w["name"]
        for m in layer:  # each per-layer metric's cells report what it moves
            assert m["moves"] in names
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
    roofs = [m for m in MANIFEST["per_layer"] if m["name"].split(".")[0].endswith("_roofline")]
    assert all(m["unit"] == "%" for m in roofs)
    assert any("mfu" in m["name"] for m in MANIFEST["per_layer"])


def test_cells_find_their_files():
    for w in MANIFEST["workloads"]:
        cfg = M.config(ROOT, MANIFEST, w["config"])
        mix = M.traffic(ROOT, w["traffic"])
        M.kind(ROOT, mix["kind"])
        limits = M.limits(ROOT, w["name"])
        assert limits and all(v >= 0 for v in limits.values())
        assert cfg["name"] == w["config"]
    for m in MANIFEST["per_layer"]:
        assert callable(M.reader(ROOT, m["name"]))
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("port_bench/") for f in files)


def test_no_width_reduced():
    width = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|embedding)")
    for c in MANIFEST["configs"]:
        assert not any(width.search(k) for k in c["reduced"]), c["name"]
