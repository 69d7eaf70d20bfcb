"""Run a function on a few CPU ranks of one gloo group, each a fresh Python
process: the CPU stand-in for ``torchrun`` that the tests use, since one card
cannot hold two NCCL ranks.

    results = run_ranks("my_module:my_function", 4, arg1, arg2)

Rank r runs ``my_module.my_function(arg1, arg2)`` with ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` set as torchrun sets them, after joining
the group (``init_distributed(device="cpu")`` over a file store in a fresh
temporary directory); the return values come back pickled, in rank order.
The children get this process's ``sys.path`` and one CPU thread each.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

_CHILD = "from inductive_recommendation_tpu_torch.parallel.launch import _child; _child()"


def run_ranks(target: str, world_size: int, *args, timeout: float = 600.0) -> list:
    """``target`` = "module:function"; raises with the failing ranks' output
    when a rank fails (the others are stopped then) or the run outlasts
    ``timeout`` seconds."""
    tmp = tempfile.mkdtemp(prefix="irt_ranks_")
    procs, logs = [], []
    try:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump((target, args), f)
        for rank in range(world_size):
            env = dict(
                os.environ, RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                IRT_RANKS_DIR=tmp, PYTHONPATH=os.pathsep.join(p for p in sys.path if p), OMP_NUM_THREADS="1",
            )
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, "-c", _CHILD], env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        # a rank that fails leaves the others waiting in a collective: stop them all
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        failed = [rank for rank, p in enumerate(procs) if p.poll() != 0]
        if failed:
            tails = []
            for rank in failed:
                logs[rank].seek(0)
                tails.append(f"-- rank {rank} --\n" + logs[rank].read()[-4000:])
            raise RuntimeError(f"ranks {failed} of {world_size} failed running {target}:\n" + "\n".join(tails))
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"out{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _child():
    import importlib

    import torch.distributed as dist

    from inductive_recommendation_tpu_torch.parallel.mesh import init_distributed

    tmp = os.environ["IRT_RANKS_DIR"]
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        target, args = pickle.load(f)
    init_distributed(device="cpu", init_method="file://" + os.path.join(tmp, "store"))
    module, name = target.split(":")
    out = getattr(importlib.import_module(module), name)(*args)
    with open(os.path.join(tmp, f"out{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
