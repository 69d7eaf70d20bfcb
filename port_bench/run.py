"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload igcn_gowalla.train --seed 7 --seconds 10 --trace 0

From the root of a checkout. It imports the PyTorch and CUDA port
(``inductive_recommendation_tpu_torch``) and plain torch / numpy, never JAX
or the JAX package. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``; last, ``checks``: each number compared
with its limit, which the last lines of standard error repeat). With no
CUDA device, with JAX loaded, or without the port beside it, it prints no
result and exits with a code other than 0."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _pin_caches():
    """Kernel and build caches at fixed paths inside the checkout, so that a
    second run there finds every kernel built."""
    cache = ROOT / "port_bench" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    from port_bench.core.harness import RunError, dumps, run_cell

    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except RunError as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 3
    print(dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
