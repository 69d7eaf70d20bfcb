"""The scores kernel and its gradient (``sddmm_csr``, ``sddmm_csr_backward``
of ``ops/csrc/attention_csr.cu``) run on the CPU through the host shim of
``test_torch_port_softmax_emulated.py``: g++ builds the source against it,
every warp runs as 32 threads that meet at each shuffle, ballot and
``__syncwarp``, and the C entry points are called through ctypes on CPU
tensors as the port's wrappers call them on the card.

Each kernel is held to its plain version in float64 entry by entry, within
the worst-case rounding error of its order of sums: a score within
gamma(dv + 8) (|a| . |x| + |b|), an entry of d_a or d_b of row r within
gamma(h_r) (|g| @ |x|) (resp. sum |g|), h_r = min(deg_r, 256) + deg_r //
256 + 8 (a lane's chain over the chunk's part of the row, the shuffles, the
carries); gamma(h) = h u / (1 - h u), u = 2^-24. Every output is written
(the buffers start at 7.0), and a second launch is bitwise the first. The
CSRs hold runs of empty rows, a row over several chunks, rows cut exactly at
chunk ends, a run of one-edge rows, one row and no edge at all; h 1, 2, 3,
4 and 8; widths 16, 64 and 128 with operands 16-byte aligned (the 16-byte
kernels) and 64 with operands 4 bytes off (the scalar ones).

This checks the kernels' logic (the chunk walk from the first-row table,
the carries), not their speed or the card's arithmetic:
``chip_smoke.py`` holds the same kernels to the same plain versions on the
card. Skipped where no g++ is installed."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import test_torch_port_softmax_emulated as softmax_emu

from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.ops import attention_csr as K

U = 2.0**-24
CHUNK = K.SOFTMAX_CHUNK
CASES = {
    # runs of empty rows, a row over 3 chunks, the rest 0-6 edges
    "empty runs and a long row": np.concatenate([np.zeros(60, np.int64), [600], np.zeros(20, np.int64),
                                                 np.random.default_rng(1).integers(0, 7, 40)]),
    # rows ending exactly at the first two chunk ends, empty rows at the second,
    # then rows ending at the ends of the scores' half-size chunks
    "rows cut at chunk ends": np.array([CHUNK, 1, CHUNK - 1, 0, 0, CHUNK // 2, CHUNK // 2, 2]),
    # chunks of one-edge rows
    "a run of one-edge rows": np.concatenate([[3], np.ones(60, np.int64), [9]]),
    "one row": np.array([3]),
    "no edges": np.array([0, 0, 0]),
}
N_COLS = 50


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA source")
    work = tmp_path_factory.mktemp("sddmm_emulated")
    (work / "cuda_shim.h").write_text(softmax_emu.SHIM)
    (work / "attention_csr.cpp").write_text(softmax_emu._host_source((_build.CSRC / "attention_csr.cu").read_text()))
    out = work / "libattention_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{work}", "-o", str(out),
                    str(work / "attention_csr.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES["attention_csr"]:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _twice(fn):
    out, again = fn(), fn()
    pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs), "two launches differ"
    return out


def _gamma(h):
    return h * U / (1.0 - h * U)


def _within(got, ref, limit, what):
    err = (got.double() - ref).abs()
    bad = err > limit
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} entries past their limit, max err {float(err.max())}"


def _scores(lib, row_ptr, col, a, x, b):
    nnz, h = col.shape[0], a.shape[1]
    out = torch.full((nnz, h), 7.0)
    assert lib.sddmm_csr(_ptr(row_ptr), _ptr(K.chunk_first_rows(row_ptr, nnz)), _ptr(col), _ptr(a), _ptr(x),
                         _ptr(b), _ptr(out), row_ptr.shape[0] - 1, nnz, h, x.shape[1], None) == 0
    return out


def _scores_grad(lib, row_ptr, col, g, x):
    (nnz, h), n_rows, dv = g.shape, row_ptr.shape[0] - 1, x.shape[1]
    nc = K.n_softmax_chunks(nnz)
    d_a, d_b = torch.full((n_rows, h, dv), 7.0), torch.full((n_rows, h), 7.0)
    carry_a, carry_b = torch.full((nc, 2, h, dv), 7.0), torch.full((nc, 2, h), 7.0)
    cut = torch.full((nc,), -7, dtype=torch.int32)
    assert lib.sddmm_csr_backward(_ptr(row_ptr), _ptr(K.chunk_first_rows(row_ptr, nnz)), _ptr(col), _ptr(g),
                                  _ptr(x), _ptr(d_a), _ptr(d_b), _ptr(carry_a), _ptr(carry_b), _ptr(cut), n_rows,
                                  nnz, h, dv, nc, None) == 0
    return d_a, d_b


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("h", [1, 2, 3, 4, 8])
def test_emulated_scores_and_gradient_match_the_plain_versions(lib, case, h):
    degrees = CASES[case]
    rng = np.random.default_rng(h)
    row_ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(degrees)]), dtype=torch.int32)
    n_rows, nnz = len(degrees), int(row_ptr[-1])
    col = torch.as_tensor(rng.integers(0, N_COLS, nnz), dtype=torch.int32)
    deg = torch.diff(row_ptr).double()
    h_r = (deg.clamp(max=CHUNK) + torch.div(deg, CHUNK, rounding_mode="floor") + 8)[:, None]
    widths = [(16, True), (64, True), (64, False)] + ([(128, True)] if h == 8 else [])
    for dv, aligned in widths:
        what = f"{case}, h {h}, dv {dv}, aligned {aligned}"
        a = torch.as_tensor(rng.standard_normal((n_rows, h, dv)), dtype=torch.float32)
        x = torch.as_tensor(rng.standard_normal((N_COLS, dv)), dtype=torch.float32)
        b = torch.as_tensor(rng.standard_normal((n_rows, h)), dtype=torch.float32)
        g = torch.as_tensor(rng.standard_normal((nnz, h)), dtype=torch.float32)
        ka, kx, kb, kg = (t if aligned else softmax_emu._misaligned(t) for t in (a, x, b, g))
        for bias in (kb, None) if (dv, aligned) == (64, True) else (kb,):
            out = _twice(lambda: _scores(lib, row_ptr, col, ka, kx, bias))
            ref_b, mag_b = (None, None) if bias is None else (b.double(), b.double().abs())
            ref = K.sddmm_csr_reference(row_ptr, col, a.double(), x.double(), ref_b)
            mag = K.sddmm_csr_reference(row_ptr, col, a.double().abs(), x.double().abs(), mag_b)
            _within(out, ref, _gamma(dv + 8) * mag, f"{what}: scores, bias {bias is not None}")
        d_a, d_b = _twice(lambda: _scores_grad(lib, row_ptr, col, kg, kx))
        ref_a, ref_b = K.sddmm_csr_backward_reference(row_ptr, col, g.double(), x.double())
        mag_a, mag_b = K.sddmm_csr_backward_reference(row_ptr, col, g.double().abs(), x.double().abs())
        _within(d_a, ref_a, _gamma(h_r)[:, :, None] * mag_a, f"{what}: d_a")
        _within(d_b, ref_b, _gamma(h_r) * mag_b, f"{what}: d_b")
        if nnz == 0:
            assert not bool(d_a.any()) and not bool(d_b.any()), f"{what}: rows without edges are not 0"
