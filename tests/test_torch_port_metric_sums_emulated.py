"""The evaluation's metric-sums kernel (``ops/csrc/metric_sums.cu``) run on
the CPU through the host shim of ``test_torch_port_softmax_emulated.py``: g++
builds the source against it, every warp runs as 32 threads that meet at each
shuffle, ballot and ``__syncwarp``, and the C entry point is called through
ctypes on CPU tensors as ``eval/device_metrics.py::batch_metric_sums_cuda``
calls it on the card.

The sums are held to the JAX package's ``batch_metric_sums`` and to the plain
version (``batch_metric_sums_reference``) within 1e-6 (the kernel sums in
double, the others in float32), the valid count exactly, a second launch
bitwise, and each user's values bitwise to
the plain version run on that user alone (the same float discounts and
ideal cumulative, the DCG exact in double as PyTorch's CPU cumsum takes it,
the same divisions). Cases: both membership routes (a binary search of
sorted rows, a compare against rows staged in shared memory, also rows over
one staged tile), K = 25 with cutoffs (1, 5, 20, 30), ground truth longer
than K, empty ground-truth rows, padding users, batches that are not a
multiple of a block's 4 users, one cutoff, more than 32 cutoffs (a lane's
second slot), K over a warp's 128 ranks at a time.

This checks the kernel's logic, not its speed or the card's arithmetic:
``chip_smoke.py`` holds it to the plain version on the card. Skipped where no
g++ is installed."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_port_softmax_emulated as softmax_emu

from inductive_recommendation_tpu.eval import device_metrics as jax_dm
from inductive_recommendation_tpu_torch.eval import device_metrics as dm
from inductive_recommendation_tpu_torch.ops import _build

# the CUDA names this source uses beyond the shim's
EXTRA = r"""
inline int __popc(unsigned x) { return __builtin_popcount(x); }
constexpr cudaError_t cudaErrorInvalidValue = 1;
"""

N_ITEMS = 700
CASES = {
    # name: (B, K, topks, ground-truth width, sorted)
    "sorted, wide rows": (37, 100, (1, *range(5, 101, 5)), 512, True),
    "staged rows": (37, 100, (1, *range(5, 101, 5)), 256, False),
    "K 25, a cutoff over K, sorted": (21, 25, (1, 5, 20, 30), 300, True),
    "K 25, a cutoff over K, staged": (21, 25, (1, 5, 20, 30), 64, False),
    "one cutoff": (9, 40, (20,), 128, False),
    "one cutoff, sorted": (9, 40, (20,), 16, True),
    "rows over one staged tile": (6, 50, (1, 10, 50), 600, False),
    "40 cutoffs, K over 128 ranks": (7, 300, tuple(range(1, 301, 7))[:40], 512, True),
    "64 cutoffs, staged": (5, 70, tuple(range(1, 65)), 100, False),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA source")
    work = tmp_path_factory.mktemp("metric_sums_emulated")
    (work / "cuda_shim.h").write_text(softmax_emu.SHIM + EXTRA)
    (work / "metric_sums.cpp").write_text(softmax_emu._host_source((_build.CSRC / "metric_sums.cu").read_text()))
    out = work / "libmetric_sums_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{work}", "-o", str(out),
                    str(work / "metric_sums.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES["metric_sums"]:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _case(seed, B, K, width, sorted_gt):
    """A batch: distinct ranked ids, ground truth of every length from empty
    to the full width (longer than K too) padded with the sentinel, padding
    users at the end and here and there."""
    rng = np.random.default_rng(seed)
    rec = np.stack([rng.choice(N_ITEMS, size=K, replace=False) for _ in range(B)])
    lens = rng.integers(0, width + 1, B)
    lens[0], lens[-1] = 0, width
    rows = np.full((B, width), N_ITEMS, dtype=np.int32)
    for u, n in enumerate(lens):
        # about half the ids from the user's own ranking, so every rank can hit
        own = rng.choice(rec[u], size=min(n // 2, K), replace=False)
        rest = rng.choice(np.setdiff1d(np.arange(N_ITEMS), own), size=n - own.size, replace=False)
        rows[u, :n] = rng.permutation(np.concatenate([own, rest]))
    if sorted_gt:
        rows.sort(axis=1)
    valid = rng.random(B) < 0.85
    valid[-2:] = False
    return (torch.as_tensor(rec, dtype=torch.int64), torch.as_tensor(rows), torch.as_tensor(lens, dtype=torch.int32),
            torch.as_tensor(valid))


def _launch(lib, rec, rows, lens, valid, topks, sorted_gt):
    """(per-user values [3 n + 1, B], sums [n, 3], n_valid) from the C entry."""
    B, K = rec.shape
    n_out = 3 * len(topks) + 1
    vals, out = torch.full((n_out, B), 7.0), torch.full((n_out,), 7.0)
    err = lib.metric_sums(rec.data_ptr(), rows.data_ptr(), lens.data_ptr(), valid.data_ptr(), vals.data_ptr(),
                          out.data_ptr(), B, K, rows.shape[1], (ctypes.c_int * len(topks))(*topks), len(topks),
                          int(sorted_gt), None)
    assert err == 0
    return vals, out[:-1].view(len(topks), 3), out[-1]


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_the_plain_sums(lib, name):
    B, K, topks, width, sorted_gt = CASES[name]
    rec, rows, lens, valid = _case(len(name), B, K, width, sorted_gt)
    vals, sums, n_valid = _launch(lib, rec, rows, lens, valid, topks, sorted_gt)
    again = _launch(lib, rec, rows, lens, valid, topks, sorted_gt)
    assert all(torch.equal(a, b) for a, b in zip((vals, sums, n_valid), again)), "two launches differ"

    want_s, want_v = dm.batch_metric_sums_reference(rec, rows, lens, valid, topks, sorted_gt)
    np.testing.assert_allclose(sums.numpy(), want_s.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(n_valid, want_v)
    assert float(n_valid) == float(((lens > 0) & valid).sum())
    jax_s, jax_v = jax_dm.batch_metric_sums(jnp.asarray(rec.numpy().astype(np.int32)), jnp.asarray(rows.numpy()),
                                            jnp.asarray(lens.numpy()), jnp.asarray(valid.numpy()), topks,
                                            sorted_gt=sorted_gt)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jax_s), rtol=1e-6, atol=1e-6)
    assert float(n_valid) == float(jax_v)
    # each user's values, bitwise the plain version's on that user alone
    for u in range(B):
        one = [t[u : u + 1] for t in (rec, rows, lens, valid)]
        want_u, want_uv = dm.batch_metric_sums_reference(*one, topks, sorted_gt)
        got_u = vals[:, u]
        assert torch.equal(got_u[:-1].view(len(topks), 3), want_u), (name, u)
        assert torch.equal(got_u[-1], want_uv), (name, u)


def test_an_empty_batch_sums_to_zero(lib):
    rec, rows, lens, valid = _case(0, 3, 10, 8, False)
    _, sums, n_valid = _launch(lib, rec[:0], rows[:0], lens[:0], valid[:0], (1, 5), False)
    assert torch.equal(sums, torch.zeros(2, 3)) and float(n_valid) == 0.0


def test_the_entry_refuses_what_the_kernel_does_not_take(lib):
    rec, rows, lens, valid = _case(0, 3, 10, 8, False)
    assert _launch_err(lib, rec, rows, lens, valid, tuple(range(1, 66))) != 0  # 65 cutoffs
    assert _launch_err(lib, rec, rows, lens, valid, ()) != 0


def _launch_err(lib, rec, rows, lens, valid, topks):
    n_out = 3 * len(topks) + 1
    vals, out = torch.empty(n_out, rec.shape[0]), torch.empty(n_out)
    return lib.metric_sums(rec.data_ptr(), rows.data_ptr(), lens.data_ptr(), valid.data_ptr(), vals.data_ptr(),
                           out.data_ptr(), rec.shape[0], rec.shape[1], rows.shape[1],
                           (ctypes.c_int * max(1, len(topks)))(*topks), len(topks), 0, None)


def test_the_wrapper_keeps_cpu_tensors_on_the_plain_path_and_refuses_wide_cutoffs():
    rec, rows, lens, valid = _case(1, 5, 12, 8, False)
    before = dm.batch_metric_sums_cuda.launches
    got = dm.batch_metric_sums(rec, rows, lens, valid, (1, 5, 12), False)
    want = dm.batch_metric_sums_reference(rec, rows, lens, valid, (1, 5, 12), False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dm.batch_metric_sums_cuda.launches == before
    with pytest.raises(ValueError, match="cutoffs"):
        dm.batch_metric_sums_cuda(rec, rows, lens, valid, tuple(range(1, dm.MAX_CUTOFFS + 2)), False)
    with pytest.raises(TypeError, match="int64"):
        dm.batch_metric_sums_cuda(rec.int(), rows, lens, valid, (1,), False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dm.batch_metric_sums(rec, rows, lens.to("meta"), valid, (1,), False)
