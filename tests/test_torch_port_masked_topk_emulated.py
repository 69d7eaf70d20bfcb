"""The evaluation's masked top-k kernel (``ops/csrc/masked_topk.cu``) run on
the CPU through the host shim of ``test_torch_port_softmax_emulated.py``: g++
builds the source against it, every block runs as its threads at once (they
meet at each ``__syncthreads``, each warp's 32 at its shuffles), and
``ops/topk.py::masked_topk_cuda`` calls the C entry point through ctypes on
CPU tensors (the library loader, the current device and the stream stubbed),
as it calls it on the card.

Values and ids are held exactly to a float64 lexsort of the masked scores by
(value desc, id asc) and to the JAX package's ``masked_topk`` (``lax.top_k``
breaks ties by the lower index too); a second launch is bitwise the first.
Cases: k 1, 20, 100 and k = n_items; n_items odd and a multiple of 4; rows cut
into chunks and merged by a second launch (the source built with blocks of
256 items, ``MASKED_TOPK_ITEMS``); exclusion rows with duplicates and sentinel padding; a banned mask;
rows with fewer eligible items than k; a row of all -inf; ties at the k-th
place, few (the candidate buffer) and over 2,048 (the bisection route); -0,
+inf; rows over the candidate buffer's 2,048 entries, whose threshold comes
from the threads' maxima, by their rank in a histogram bin or, where more
than 256 maxima crowd the bin, by its lower edge (then over 256 candidates,
sorted rather than ranked). The wrapper counts 1 launch a call, 2 for cut rows. Every case runs with
blocks of 256 threads (the source's ``MASKED_TOPK_THREADS``), which the
emulation runs about four times faster, and two again with the card's 1,024.

This checks the kernel's logic, not its speed: ``chip_smoke.py`` holds it to
the plain version on the card. Skipped where no g++ is installed."""

import ctypes
import re
import shutil
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_port_softmax_emulated as softmax_emu

from inductive_recommendation_tpu.ops.topk import masked_topk as jax_masked_topk
from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.ops import topk

# the CUDA names this source uses beyond the shim's
EXTRA = r"""
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The emulated library built with blocks of the given threads (the card's
    1,024, or fewer, which the emulation runs faster) and items a block holds
    (the card's ``BLOCK_ITEMS``, or fewer to cut small rows), built once each."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA source")
    work = tmp_path_factory.mktemp("masked_topk_emulated")
    (work / "cuda_shim.h").write_text(softmax_emu.SHIM + EXTRA)
    (work / "masked_topk.cpp").write_text(
        softmax_emu._host_source((_build.CSRC / "masked_topk.cu").read_text(), launch="emu::LaunchBlock"))
    built = {}

    def get(threads, items=topk.BLOCK_ITEMS):
        if (threads, items) not in built:
            out = work / f"libmasked_topk_emulated_{threads}_{items}.so"
            subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w", f"-I{work}",
                            f"-DMASKED_TOPK_THREADS={threads}", f"-DMASKED_TOPK_ITEMS={items}", "-o", str(out),
                            str(work / "masked_topk.cpp")], check=True, capture_output=True, timeout=300)
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in _build.SIGNATURES["masked_topk"]:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            built[threads, items] = lib
        return built[threads, items]

    return get


@pytest.fixture
def lib(libs):
    return libs(CARD_THREADS)


@pytest.fixture
def emulated(libs, monkeypatch):
    """``masked_topk_cuda`` launching the emulated kernel built with the given
    threads and items a block on CPU tensors."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's device index
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=None))

    def build(threads, items):
        lib = libs(threads, items)
        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(topk, "BLOCK_ITEMS", items)
        return topk.masked_topk_cuda

    return build


def reference(scores, k, excl, banned):
    """(values, ids) of the masked rows sorted by (value desc, id asc), in float64."""
    s = scores.astype(np.float64)
    n = s.shape[1]
    if banned is not None:
        s[:, banned] = -np.inf
    if excl is not None:
        for r, row in enumerate(excl):
            s[r, row[row < n]] = -np.inf
    order = np.stack([np.lexsort((np.arange(n), -row)) for row in s])[:, :k]
    return np.take_along_axis(s, order, 1).astype(np.float32), order


def _exclusions(rng, rows, n, m):
    """[rows, m] int32: ids with duplicates, then the sentinel n as padding."""
    excl = np.full((rows, m), n, dtype=np.int32)
    for r in range(rows):
        used = rng.integers(0, m + 1)
        ids = rng.choice(n, size=max(1, used // 2), replace=False)
        excl[r, :used] = rng.choice(ids, size=used)  # duplicates
    return excl


def _case(name):
    """(scores [rows, n] fp32, k, exclude_idx or None, banned or None, items a block holds)."""
    rng = np.random.default_rng(len(name))
    sizes = re.fullmatch(r"k (\d+), n (\d+)", name)
    if sizes:
        k, n = int(sizes[1]), int(sizes[2])
        scores = rng.normal(0.0, 3.0, (4, n)).astype(np.float32)
        return scores, k, _exclusions(rng, 4, n, 40), rng.random(n) < 0.1, topk.BLOCK_ITEMS
    if name == "k = n_items":
        scores = rng.normal(0.0, 1.0, (5, 37)).astype(np.float32)
        return scores, 37, _exclusions(rng, 5, 37, 9), None, topk.BLOCK_ITEMS
    if name == "cut rows, 3 chunks":
        scores = rng.normal(0.0, 1.0, (3, 701)).astype(np.float32)
        return scores, 80, _exclusions(rng, 3, 701, 64), rng.random(701) < 0.05, 256
    if name == "cut rows, k 100, ties across chunks":
        scores = np.round(rng.normal(0.0, 1.0, (4, 511)), 1).astype(np.float32)
        return scores, 100, _exclusions(rng, 4, 511, 16), None, 256
    if name == "fewer eligible than k, all -inf":
        n = 150
        scores = rng.normal(0.0, 1.0, (4, n)).astype(np.float32)
        excl = _exclusions(rng, 4, n, 200)
        excl[0, :120] = rng.permutation(n)[:120]  # 30 eligible
        excl[1, :n] = np.arange(n)  # none eligible
        scores[2] = -np.inf
        return scores, 100, excl, None, topk.BLOCK_ITEMS
    if name == "every item banned":
        scores = rng.normal(0.0, 1.0, (3, 300)).astype(np.float32)
        return scores, 100, None, np.ones(300, bool), topk.BLOCK_ITEMS
    if name == "ties at the k-th place, candidate buffer":
        scores = np.round(rng.normal(0.0, 1.0, (6, 997)), 1).astype(np.float32)
        scores[1, ::3] = 0.0
        scores[1, 1::3] = -0.0
        scores[2, 5] = np.inf
        return scores, 100, _exclusions(rng, 6, 997, 64), None, topk.BLOCK_ITEMS
    if name == "maxima crowd one bin":  # 1,100 high scores within 1e-4 of each other, the rest far below
        n = 4099
        scores = np.full((4, n), -1.0, dtype=np.float32)
        for r in range(4):
            scores[r, rng.permutation(n)[:1100]] = 1.0 + rng.random(1100) * 1e-4
        return scores, 100, _exclusions(rng, 4, n, 64), None, topk.BLOCK_ITEMS
    if name == "ties at the k-th place, bisection":
        n = 3001
        scores = rng.normal(0.0, 1.0, (4, n)).astype(np.float32)
        scores[0] = 0.5  # every item ties
        scores[1, rng.permutation(n)[:2500]] = 7.0  # 2,500 tie above the rest
        scores[2] = np.round(scores[2], 0)  # a few levels, 2,000-odd at the k-th
        scores[3, :60] = 9.0  # 60 above, the rest tie at the k-th
        scores[3, 60:] = 1.0
        return scores, 100, _exclusions(rng, 4, n, 256), rng.random(n) < 0.02, topk.BLOCK_ITEMS
    raise KeyError(name)


CARD_THREADS = 1024  # kThreads on the card
CASES = ["k 1, n 997", "k 20, n 997", "k 100, n 997", "k 100, n 1000", "k 100, n 4099", "k = n_items",
         "cut rows, 3 chunks", "cut rows, k 100, ties across chunks", "fewer eligible than k, all -inf",
         "every item banned", "ties at the k-th place, candidate buffer", "maxima crowd one bin",
         "ties at the k-th place, bisection"]
# every case at 256 threads a block; three again at the card's 1,024 (more
# maxima than the rank takes share a bin only there)
RUNS = [(name, 256) for name in CASES] + [(name, CARD_THREADS) for name in CASES[4:5] + CASES[-2:]]


@pytest.mark.parametrize("name,threads", RUNS)
def test_kernel_matches_the_lexsort_and_jax(emulated, name, threads):
    scores, k, excl, banned, items = _case(name)
    run = emulated(threads, items)
    args = (torch.as_tensor(scores), k, None if excl is None else torch.as_tensor(excl),
            None if banned is None else torch.as_tensor(banned))
    before = topk.masked_topk_cuda.launches
    vals, ids = run(*args)
    again = run(*args)
    per_call = 1 + (topk.n_chunks(scores.shape[1]) > 1)
    assert topk.masked_topk_cuda.launches - before == 2 * per_call
    assert torch.equal(vals, again[0]) and torch.equal(ids, again[1]), "two launches differ"
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64 and vals.shape == ids.shape == (len(scores), k)

    want_v, want_i = reference(scores, k, excl, banned)
    np.testing.assert_array_equal(ids.numpy(), want_i, err_msg=name)
    np.testing.assert_array_equal(vals.numpy(), want_v, err_msg=name)
    jv, ji = jax_masked_topk(jnp.asarray(scores), k, None if excl is None else jnp.asarray(excl),
                             None if banned is None else jnp.asarray(banned))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji), err_msg=name)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv), err_msg=name)


def test_the_block_constants_match_the_source():
    src = (_build.CSRC / "masked_topk.cu").read_text()
    assert f"constexpr int kMaxK = {topk.MAX_K};" in src
    assert f"#define MASKED_TOPK_ITEMS {topk.BLOCK_ITEMS}\n" in src
    # the largest catalogs of the grids in one block, Amazon-Book's cut in two
    assert topk.n_chunks(40_981) == 1 and topk.n_chunks(91_599) == 2


def test_the_entry_refuses_what_the_kernel_does_not_take(lib):
    scores, out_v, out_i = torch.zeros(2, 300), torch.empty(2, 200), torch.empty(2, 200, dtype=torch.int64)

    def err(k, n_items=300, m=0, rows=2):
        return lib.masked_topk(scores.data_ptr(), None, None, None, None, out_v.data_ptr(), out_i.data_ptr(), rows,
                               n_items, m, k, None)

    assert err(topk.MAX_K + 1) != 0
    assert err(0) != 0
    assert err(10, n_items=5) != 0
    assert err(10, m=-1) != 0
    assert err(10, rows=-1) != 0
    assert err(10, n_items=topk.BLOCK_ITEMS + 1) != 0  # cut rows need candidate buffers
    assert err(10) == 0 and err(10, rows=0) == 0


def test_the_wrapper_keeps_cpu_tensors_on_the_plain_path_and_refuses(monkeypatch):
    rng = np.random.default_rng(3)
    scores = torch.as_tensor(rng.normal(0.0, 1.0, (4, 50)).astype(np.float32))
    excl = torch.as_tensor(_exclusions(rng, 4, 50, 8))
    banned = torch.as_tensor(rng.random(50) < 0.2)
    before = topk.masked_topk_cuda.launches
    got = topk.masked_topk(scores, 10, excl, banned)
    want = torch.topk(topk.mask_scores(scores, excl, banned), 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert topk.masked_topk_cuda.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        topk.masked_topk(scores, 10, excl.to("meta"), banned)
    with pytest.raises(ValueError, match="k 129"):
        topk.masked_topk_cuda(torch.zeros(4, 200), topk.MAX_K + 1)
    with pytest.raises(TypeError, match="int32"):
        topk.masked_topk_cuda(scores, 10, excl.long())
    monkeypatch.setattr(topk, "BLOCK_ITEMS", 256)
    with pytest.raises(ValueError, match="merges at most"):
        topk.masked_topk_cuda(torch.zeros(1, 2000), 100)
