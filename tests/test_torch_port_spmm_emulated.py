"""The SpMM kernel's dropout route (``ops/csrc/spmm_csr.cu``) run on the CPU
through the host shim of ``test_torch_port_softmax_emulated.py``, with its
seed read from memory, as a training step captured in a CUDA graph passes
it (``seed_ptr``: an entry of the step's seed table).

g++ builds the source against the shim and its C entry points run on CPU
tensors through ctypes, as ``ops.csr_spmm.spmm_csr_cuda`` calls them on the
card. On the identity operand a product is its matrix written out, so the
edges it keeps and their values are held bit for bit to
``spmm_csr_dropout_reference`` with the same seed as an integer, on the
forward layout and its transpose; a seed by value gives the same bits as by
address; on a random operand the product is held to the plain version
within fp32 rounding; and two seeds give two masks. The matrix spans
several chunks of the kernel, with a row cut across them.

This checks the kernel's logic, not its speed: ``chip_smoke.py`` holds the
kernel to the plain version on the card. Skipped where no g++ is
installed."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import test_torch_port_softmax_emulated as softmax_emu

from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.ops.csr_spmm import (
    build_csr_spmm,
    n_chunks,
    spmm_csr_dropout_reference,
)

# the CUDA names this source uses beyond the shim's
EXTRA = r"""
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
"""
P = 0.3
SEEDS = (3_839_649_608_876_091_011, 12_345)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA source")
    work = tmp_path_factory.mktemp("spmm_emulated")
    (work / "cuda_shim.h").write_text(softmax_emu.SHIM + EXTRA)
    (work / "spmm_csr.cpp").write_text(softmax_emu._host_source((_build.CSRC / "spmm_csr.cu").read_text()))
    out = work / "libspmm_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{work}", "-o", str(out),
                    str(work / "spmm_csr.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES["spmm_csr"]:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def mat():
    """A 40 x 400 matrix of about 1,000 edges, one row of 390 (over two
    chunk ends), an empty row, the rest random; with its transpose."""
    rng = np.random.default_rng(4)
    rows = np.concatenate([np.full(390, 7), rng.integers(0, 40, 600)])
    rows[rows == 11] = 12  # row 11 empty
    cols = np.concatenate([rng.permutation(400)[:390], rng.integers(0, 400, 600)])
    keys = np.unique(rows * 400 + cols)  # one edge an entry: the identity operand writes each out alone
    rows, cols = keys // 400, keys % 400
    vals = rng.uniform(0.5, 2.0, len(keys)).astype(np.float32)
    m = build_csr_spmm(rows, cols, vals, (40, 400), symmetric=False, device="cpu")
    assert n_chunks(m.nnz) > 4 and m.row_ptr[8] - m.row_ptr[7] > 2 * 192
    return m


def product(lib, mat, x, seed=None, seed_ptr=None):
    """The kernel's two launches on ``mat`` under dropout P, its seed by
    value or, given ``seed_ptr`` (an int64 tensor), by address."""
    d, chunks = x.shape[1], n_chunks(mat.nnz)
    out = torch.full((mat.n_rows, d), 7.0)
    carry, cut_row = torch.empty(chunks, 2, d), torch.empty(chunks, dtype=torch.int32)
    err = lib.spmm_csr_chunks(mat.row_ptr.data_ptr(), mat.col.data_ptr(), mat.val.data_ptr(), mat.eid.data_ptr(),
                              0 if seed is None else seed, None if seed_ptr is None else seed_ptr.data_ptr(), P,
                              x.data_ptr(), out.data_ptr(), carry.data_ptr(), cut_row.data_ptr(), mat.n_rows,
                              mat.nnz, d, chunks, None)
    assert err == 0
    assert lib.spmm_csr_carries(mat.row_ptr.data_ptr(), cut_row.data_ptr(), carry.data_ptr(), out.data_ptr(),
                                mat.n_rows, d, chunks, None) == 0
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("side", ["forward", "transpose"])
def test_a_seed_read_from_memory_drops_the_plain_versions_edges(lib, mat, seed, side):
    m = mat if side == "forward" else mat.T
    table = torch.tensor([0, seed, 0], dtype=torch.int64)
    eye = torch.eye(m.n_cols)
    got = product(lib, m, eye, seed_ptr=table[1])
    want = spmm_csr_dropout_reference(m, eye, seed, P)
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < m.nnz  # some edges kept, some dropped
    assert torch.equal(product(lib, m, eye, seed=seed), got)


def test_both_sides_drop_the_same_edges_and_two_seeds_two_masks(lib, mat):
    seed = torch.tensor([SEEDS[0]], dtype=torch.int64)
    forward = product(lib, mat, torch.eye(mat.n_cols), seed_ptr=seed[0])
    transpose = product(lib, mat.T, torch.eye(mat.T.n_cols), seed_ptr=seed[0])
    assert torch.equal(forward, transpose.T)
    other = product(lib, mat, torch.eye(mat.n_cols), seed_ptr=torch.tensor([SEEDS[1]], dtype=torch.int64)[0])
    assert not torch.equal(forward != 0, other != 0)


@pytest.mark.parametrize("d", [64, 37])
def test_a_random_operand_within_rounding(lib, mat, d):
    """d 64 takes the 16-byte path, 37 the scalar one."""
    x = torch.randn(mat.n_cols, d, generator=torch.Generator().manual_seed(d))
    table = torch.tensor([SEEDS[0]], dtype=torch.int64)
    got = product(lib, mat, x, seed_ptr=table[0])
    want = spmm_csr_dropout_reference(mat, x.double(), SEEDS[0], P)
    bound = 8 * 400 * 2.0**-24 * spmm_csr_dropout_reference(mat, x.abs().double(), SEEDS[0], P)
    assert ((got.double() - want).abs() <= bound + 1e-30).all()
