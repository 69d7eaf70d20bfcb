"""Fixtures of the benchmark's own tests: the repo root on the path, the
``chip`` marker (tests that need a CUDA card; they decide inside a fixture
and skip here), and a throwaway checkout whose configurations are cut to a
size the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny sizes: every width as published, the scale cut
TINY_SIZES = [300, 400, 6000]
TINY_OLD = {"n_old_users": 270, "n_old_items": 280}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped where torch sees none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip (port_bench/README.md)")
    return torch.device("cuda", 0)


def make_tiny_root(dest: Path) -> Path:
    """A checkout holding BENCHMARK.json and port_bench/ with every
    configuration cut to TINY_SIZES (batches of 64) and the inductive mix's
    old counts to TINY_OLD."""
    shutil.copytree(ROOT / "port_bench", dest / "port_bench", ignore=shutil.ignore_patterns("tests", ".cache"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["data"]["sizes"] = list(TINY_SIZES)
        if "aug_num" in cfg["model"]:
            cfg["model"]["aug_num"] = 500
        cfg["trainer"]["batch_size"] = cfg["trainer"]["test_batch_size"] = 64
        (dest / c["file"]).write_text(json.dumps(cfg))
    for t in (dest / "port_bench" / "traffic").glob("*.json"):
        mix = json.loads(t.read_text())
        if mix["kind"] == "inductive":
            mix.update(TINY_OLD)
            t.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
