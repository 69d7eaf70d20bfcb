"""Each cell run whole at a tiny size on the CPU (the harness's look for a
card skipped): the program agrees with the plain reference within the
cell's limits; the control (the reference in the next lower precision, put
in the program's place) and every fault the cell can have come out not
correct; a configuration and a cell added as files only are found and
run; and nothing loads JAX or the JAX package."""

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT

from port_bench.core import faults
from port_bench.core import manifest as M
from port_bench.core.harness import run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 977


def _limits(cell):
    return M.limits(ROOT, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_at_a_tiny_size(tiny_root, cell):
    r = run_cell(tiny_root, cell, SEED, 0.5, False, time.perf_counter(), device="cpu", limits=_limits(cell))
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name


def _calibrate(root, cell, seed, fault=None, control=False):
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_bench_calibrate", ROOT / "port_bench" / "calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.one(root, cell, seed, 0.3, "cpu", fault=fault, control=control)


def _fails(numbers, limits):
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(tiny_root, cell):
    got = _calibrate(tiny_root, cell, SEED, control=True)
    assert not _fails(got["numbers"], _limits(cell))
    assert _fails(got["control"], _limits(cell)), got["control"]


@pytest.mark.parametrize("cell,fault", [
    (w, f) for w in CELLS
    for f in faults.KIND_FAULTS[M.traffic(ROOT, M.cell(M.load_manifest(ROOT), w)["traffic"])["kind"]]
])
def test_fault_comes_out_not_correct(tiny_root, cell, fault):
    got = _calibrate(tiny_root, cell, SEED + 1, fault=fault)
    assert _fails(got["numbers"], _limits(cell)), (fault, got["numbers"])


def test_a_config_and_a_cell_added_as_files_run(tiny_root, tmp_path):
    from conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "port_bench/configs/igcn_gowalla.json").read_text())
    cfg.update(name="igcn_two_layers")
    cfg["model"]["n_layers"] = 2
    (root / "port_bench/configs/igcn_two_layers.json").write_text(json.dumps(cfg))
    (root / "port_bench/traffic/eval_k20.json").write_text(json.dumps(
        {"kind": "eval", "stage": "test", "trace_passes": 1}))
    (root / "port_bench/limits/igcn_two_layers.eval_k20.json").write_text(
        (root / "port_bench/limits/igcn_gowalla.eval.json").read_text())
    manifest["configs"].append({"name": "igcn_two_layers", "source": "a test", "reduced": [],
                                "file": "port_bench/configs/igcn_two_layers.json", "why": "a test"})
    manifest["workloads"].append({"name": "igcn_two_layers.eval_k20", "config": "igcn_two_layers",
                                  "traffic": "eval_k20", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "eval_users_per_s":
            m["workloads"].append("igcn_two_layers.eval_k20")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = run_cell(root, "igcn_two_layers.eval_k20", SEED, 0.3, False, time.perf_counter(), device="cpu")
    assert r["correct"] and "eval_users_per_s" in r["metrics"]


def test_a_cell_finds_its_models_module_by_name(tmp_path):
    """The model's module is ``models/<model name lowercased>.py`` of the
    checkout the run is in: without it the cell does not run."""
    from conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    (root / "port_bench/models/igcn.py").unlink()
    with pytest.raises(M.ManifestError, match="models/igcn.py"):
        run_cell(root, "igcn_gowalla.eval", SEED, 0.2, False, time.perf_counter(), device="cpu")


def test_dose_selection_is_judged_from_the_references_own_steps(tiny_root):
    """Adam's state left unchanged after the checked steps: the checked
    numbers agree, but the first epoch end's selection, which the reference
    works out from its own parameters after every step it followed, does
    not."""
    import torch

    cell = "dose_aug_gowalla.train"
    step, calls = torch.optim.Adam.step, []

    def late_unchanged(self, closure=None):
        calls.append(1)
        return step(self, closure) if len(calls) <= 3 else None

    torch.optim.Adam.step = late_unchanged
    try:
        got = _calibrate(tiny_root, cell, SEED + 2)
    finally:
        torch.optim.Adam.step = step
    assert _fails(got["numbers"], _limits(cell)) == ["sel_gap"], got["numbers"]


def test_no_card_no_result(tiny_root):
    """Where torch sees no card, run.py prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "port_bench/run.py"), "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    """A checkout of BENCHMARK.json and port_bench/ alone: no result, a
    non-zero exit."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_nothing_loads_jax(tiny_root):
    """A whole run in a fresh process, then its modules' top-level names,
    compared whole: no jax, jaxlib, flax or the JAX package."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench.core.harness import run_cell\n"
        "from port_bench.core.guard import forbidden_modules, FORBIDDEN\n"
        "run_cell(%r, %r, 5, 0.2, False, time.perf_counter(), device='cpu')\n"
        "print(forbidden_modules())\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('inductive')))\n"
    ) % (str(ROOT), str(tiny_root), CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    found, loaded = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "inductive_recommendation_tpu_torch" in loaded
    assert "'inductive_recommendation_tpu'" not in loaded and "'inductive_recommendation_tpu." not in loaded


def test_guard_compares_whole_names():
    from port_bench.core.guard import forbidden_modules

    assert forbidden_modules(["inductive_recommendation_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "inductive_recommendation_tpu.models"]) == [
        "inductive_recommendation_tpu", "jax"]


def test_reference_imports_nothing_of_the_program():
    files = [ROOT / "port_bench/core" / n for n in ("reference.py", "judge.py", "data.py", "roofline.py")]
    for path in files + sorted((ROOT / "port_bench/models").glob("*.py")):
        text = path.read_text()
        assert "inductive_recommendation_tpu" not in text.replace("inductive_recommendation_tpu_torch", "") or \
            "import inductive_recommendation_tpu" not in text
        assert "from inductive_recommendation_tpu" not in text and "import jax" not in text


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, str(ROOT / "port_bench/run.py"), "--workload", cell, "--seed", str(SEED),
                          "--seconds", "3"], capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
