"""``BENCHMARK.json`` and the files it names, found by name.

- a cell: its entry in ``workloads``;
- a configuration: the ``file`` of its entry in ``configs``;
- a traffic mix: ``port_bench/traffic/<traffic>.json``, whose ``kind``
  names its driver, ``port_bench/kinds/<kind>.py``;
- a configuration's model: ``port_bench/models/<model>.py``, ``<model>``
  the configuration's ``model.name`` lowercased (what a traffic kind asks
  of the model: its work counts, its layouts, its plain reference; see
  ``models/igcn.py``);
- a per-layer metric: ``port_bench/metrics/<name>.py``, a module with
  ``read(run) -> float | None``;
- a cell's limits for the check: ``port_bench/limits/<cell>.json``.

A later change adds a cell, a configuration, a model, a mix of an existing
kind or a metric by adding such files and entries; no file here names one.
A mix of a new kind brings its driver, ``kinds/<kind>.py``."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class ManifestError(Exception):
    pass


def _json(path: Path) -> dict:
    if not path.is_file():
        raise ManifestError(f"{path} is missing")
    return json.loads(path.read_text())


def load_manifest(root) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise ManifestError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(root, manifest: dict, name: str) -> dict:
    return _json(Path(root) / _named(manifest["configs"], name, "config")["file"])


def _file(root, sub: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ManifestError(f"{name!r} is not a name")
    return Path(root) / BENCH_DIR / sub / f"{name}{suffix}"


def traffic(root, name: str) -> dict:
    return _json(_file(root, "traffic", name, ".json"))


def limits(root, cell_name: str) -> dict:
    return _json(_file(root, "limits", cell_name, ".json"))


def _module(path: Path):
    """The module of a file, loaded once a path (and registered, as a
    dataclass defined in it needs)."""
    if not path.is_file():
        raise ManifestError(f"{path} is missing")
    name = "port_bench_file_" + re.sub(r"\W", "_", str(path.resolve()))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def kind(root, name: str):
    return _module(_file(root, "kinds", name, ".py"))


def model(root, model_name: str):
    """The benchmark's module of a model: ``models/<model_name lowercased>.py``."""
    return _module(_file(root, "models", model_name.lower(), ".py"))


def beside(file, name: str):
    """The module ``<name>.py`` in the directory of ``file`` (a model's module
    that builds on another's)."""
    return _module(Path(file).resolve().parent / f"{name}.py")


def reader(root, metric: str):
    return _module(_file(root, "metrics", metric, ".py")).read


def problems(manifest: dict) -> list:
    """What in the manifest breaks the naming rules: names, units, the
    metrics' cells and the cells' configurations."""
    out = []
    configs = {c["name"] for c in manifest["configs"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in manifest[group]:
            if not NAME.match(e["name"]):
                out.append(f"{group}: bad name {e['name']!r}")
            if e["name"] in seen:
                out.append(f"{group}: {e['name']} twice")
            seen.add(e["name"])
    for w in manifest["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if not NAME.match(w["traffic"]):
            out.append(f"{w['name']}: bad traffic {w['traffic']!r}")
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            if not UNIT.match(m["unit"]):
                out.append(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"{m['name']}: better is {m['better']!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    out.append(f"{m['name']}: unknown workload {c}")
    return out
