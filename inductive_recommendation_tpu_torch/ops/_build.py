"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` into a shared library under ``ops/build/`` (listed in
``.gitignore``), then loaded with ``ctypes``. No PyTorch header is included,
so a build takes seconds. The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale library is never
loaded. Several sources compile in parallel: one ``nvcc`` each, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# the C entry points of each source: name -> [(function, argtypes)]
_P, _I, _I64, _U64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float
SIGNATURES = {
    "spmm_csr": [
        ("spmm_csr_chunks", [_P, _P, _P, _P, _U64, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        ("spmm_csr_carries", [_P, _P, _P, _P, _I, _I, _I, _P]),
    ],
    "attention_csr": [
        ("sddmm_csr", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        ("sddmm_csr_backward", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        ("softmax_stats", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P]),
        ("softmax_apply", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P]),
    ],
    "metric_sums": [
        ("metric_sums", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P]),
    ],
    "bpr_sample": [
        ("bpr_sample", [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _I, _I, _P]),
    ],
    "masked_topk": [
        ("masked_topk", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    ],
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, str]:
    """Compile every named source whose library is missing, all at once.

    Returns {name: nvcc's output} for the sources compiled by this call
    (register and shared-memory use, from ``-Xptxas=-v``). Raises with the
    compiler's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name]:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
