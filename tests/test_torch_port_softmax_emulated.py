"""The softmax passes' CUDA source (``ops/csrc/attention_csr.cu``) run on the
CPU: the file is compiled with g++ against a small host shim in which every
warp is 32 threads that meet at each shuffle, ballot and ``__syncwarp``
(blocks and warps run one after another), and its C entry points are called
through ctypes on CPU tensors, as the port's wrappers call them on the card.
Each pass is held to its plain version in float64: m exactly, s within 1e-5
of max(1, s) row by row, p, attn and c within 1e-5 * max(1, max |ref|), g_s
within 1e-5 of max |ref|; a second launch is bitwise the first. The CSRs
hold runs of empty rows, a row over several chunks, rows cut exactly at
chunk ends, a row of -inf scores and no edge at all; h 1, 3, 4 and 8,
operands aligned (the 16-byte path) and 4 bytes off (the scalar path).

This checks the kernels' logic (the chunk walk, the segmented scan, the
carries, the staging), not their speed or the card's arithmetic:
``chip_smoke.py`` holds the same passes to the same plain versions on the
card. Skipped where no g++ is installed."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from inductive_recommendation_tpu_torch.ops import _build
from inductive_recommendation_tpu_torch.ops import attention_csr as K

TOL = 1e-5
T = 80.0

# the CUDA names the source uses, for the host
SHIM = r"""
#pragma once
#include <pthread.h>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct U3 { unsigned x, y, z; };
inline thread_local U3 threadIdx, blockIdx, gridDim;
template <class T> T __ldg(const T* p) { return *p; }
#define __host__
namespace emu {
struct Warp { pthread_barrier_t bar; uint64_t slot[32]; };
inline thread_local Warp* W;
inline pthread_barrier_t* block_bar;  // LaunchBlock's barrier of every thread of the block
inline unsigned char* dyn_smem;       // LaunchBlock's dynamic shared memory
inline int lane() { return threadIdx.x & 31; }
inline void sync() { pthread_barrier_wait(&W->bar); }
template <class T> T xchg(T v, int src) {
  uint64_t s = 0;
  std::memcpy(&s, &v, sizeof(T));
  W->slot[lane()] = s;
  sync();
  T o;
  std::memcpy(&o, &W->slot[src], sizeof(T));
  sync();
  return o;
}
// a kernel launch: every block, every warp of it in turn, each warp 32 threads
template <class K> auto Launch(K k, dim3 grid, dim3 block, int = 0, void* = nullptr) {
  return [=](auto... a) {
    for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx)
        for (unsigned w = 0; w < block.x / 32; ++w) {
          Warp warp;
          pthread_barrier_init(&warp.bar, nullptr, 32);
          std::vector<std::thread> ts;
          for (unsigned l = 0; l < 32; ++l)
            ts.emplace_back([=, &warp] {
              W = &warp;
              threadIdx = {w * 32 + l, 0, 0};
              blockIdx = {bx, by, bz};
              gridDim = {grid.x, grid.y, grid.z};
              k(a...);
            });
          for (auto& t : ts) t.join();
          pthread_barrier_destroy(&warp.bar);
        }
  };
}
// a launch of a kernel that meets at __syncthreads: every block in turn, all
// the block's threads at once (each warp still meeting at its shuffles), with
// `smem` bytes of dynamic shared memory
template <class K> auto LaunchBlock(K k, dim3 grid, dim3 block, size_t smem = 0, void* = nullptr) {
  return [=](auto... a) {
    const unsigned n_warps = block.x / 32;
    for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<uint64_t> mem((smem + 7) / 8 + 2);
        dyn_smem = reinterpret_cast<unsigned char*>(mem.data() + (reinterpret_cast<uintptr_t>(mem.data()) & 8 ? 1 : 0));
        pthread_barrier_t bar;
        pthread_barrier_init(&bar, nullptr, block.x);
        block_bar = &bar;
        std::vector<Warp> warps(n_warps);
        for (auto& wp : warps) pthread_barrier_init(&wp.bar, nullptr, 32);
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block.x; ++t)
          ts.emplace_back([=, &warps] {
            W = &warps[t / 32];
            threadIdx = {t, 0, 0};
            blockIdx = {bx, by, bz};
            gridDim = {grid.x, grid.y, grid.z};
            k(a...);
          });
        for (auto& t : ts) t.join();
        for (auto& wp : warps) pthread_barrier_destroy(&wp.bar);
        pthread_barrier_destroy(&bar);
      }
  };
}
}  // namespace emu
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu::xchg(v, src & 31); }
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int s = emu::lane() - d;
  return emu::xchg(v, s < 0 ? emu::lane() : s);
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  const int s = emu::lane() + d;
  return emu::xchg(v, s > 31 ? emu::lane() : s);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m) { return emu::xchg(v, emu::lane() ^ m); }
inline unsigned __ballot_sync(unsigned, bool p) {
  emu::W->slot[emu::lane()] = p;
  emu::sync();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (emu::W->slot[i] ? 1u : 0u) << i;
  emu::sync();
  return b;
}
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline void __syncwarp() { emu::sync(); }
inline void __syncthreads() { pthread_barrier_wait(emu::block_bar); }
template <class T> T atomicAdd(T* p, T v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
inline float __expf(float x) { return std::exp(x); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaPeekAtLastError() { return 0; }
"""


def _host_source(src: str, launch: str = "emu::Launch") -> str:
    """The .cu's text for the host: the shim for the runtime header, each
    ``kernel<<<grid, block, ...>>>(args)`` as ``emu::Launch(kernel, grid,
    block, ...)(args)`` (``launch="emu::LaunchBlock"`` for kernels that meet
    at ``__syncthreads``), dynamic shared memory as the launch's buffer, the
    cp.async copies as plain copies."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    src = re.sub(r"([\w:]+(?:<[^<>]*>)?)<<<(.*?)>>>\(", launch + r"(\1, \2)(", src)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem);", src)
    src = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global[^\n]*\);',
                 "*reinterpret_cast<int*>(smem_ptr) = *reinterpret_cast<const int*>(gptr);", src)
    src = re.sub(r'asm volatile\("cp\.async\.cg\.shared\.global[^\n]*\);', "std::memcpy(smem_ptr, gptr, 16);", src)
    src = re.sub(r'asm volatile\("cp\.async\.wait_all;[^\n]*\);', "", src)
    assert "asm volatile" not in src and "<<<" not in src
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation of the CUDA source")
    work = tmp_path_factory.mktemp("softmax_emulated")
    (work / "cuda_shim.h").write_text(SHIM)
    (work / "attention_csr.cpp").write_text(_host_source((_build.CSRC / "attention_csr.cu").read_text()))
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


def _misaligned(t):
    """The same values 4 bytes past a 16-byte aligned start."""
    return torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view_as(t).copy_(t)


class _Passes:
    """The C entry points on CPU tensors, as the wrappers launch them."""

    def __init__(self, lib, row_ptr):
        self.lib, self.rp = lib, row_ptr
        self.n_rows = row_ptr.shape[0] - 1
        self.table = K.chunk_first_rows(row_ptr, int(row_ptr[-1]))

    def stats(self, x, g=None):
        nnz, h = x.shape
        nc = K.n_softmax_chunks(nnz)
        a = torch.full((self.n_rows, h), 7.0)
        b = None if g is not None else torch.full((self.n_rows, h), 7.0)
        carry, cut = torch.full((nc, 2, 2, h), 7.0), torch.full((nc,), -7, dtype=torch.int32)
        assert self.lib.softmax_stats(_ptr(self.rp), _ptr(self.table), _ptr(x), _ptr(g), _ptr(a), _ptr(b),
                                      _ptr(carry), _ptr(cut), self.n_rows, nnz, h, T, nc, int(g is not None),
                                      None) == 0
        return a if g is not None else (a, b)

    def apply(self, x, sa, sb, g=None):
        nnz, h = x.shape
        out = torch.full((nnz, h), 7.0)
        attn = None if g is not None else torch.full((nnz,), 7.0)
        assert self.lib.softmax_apply(_ptr(self.rp), _ptr(self.table), _ptr(x), _ptr(g), _ptr(sa), _ptr(sb),
                                      _ptr(out), _ptr(attn), self.n_rows, nnz, h, T, K.n_softmax_chunks(nnz),
                                      int(g is not None), None) == 0
        return out if g is not None else (out, attn)


def _twice(fn):
    out, again = fn(), fn()
    pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
    assert all(torch.equal(a, b) for a, b in pairs), "two launches differ"
    return out


def _amax(t) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def _close(got, want, what):
    err = _amax(got.double() - want)
    assert err <= TOL * max(1.0, _amax(want)), f"{what}: max abs err {err}"


CHUNK = K.SOFTMAX_CHUNK
CASES = {
    # runs of empty rows, a row over 5 chunks, the rest 0-12 edges
    "empty runs and a long row": (np.concatenate([np.zeros(300, np.int64), [1100], np.zeros(40, np.int64),
                                                  np.random.default_rng(1).integers(0, 13, 120)]), 3),
    "rows cut at chunk ends": (np.array([CHUNK, CHUNK, 2 * CHUNK, 1, CHUNK - 1, 0, 0, CHUNK, 3, 5]), 9),
    "one row": (np.array([3]), 0),
    "no edges": (np.array([0, 0, 0]), None),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("h", [1, 3, 4, 8])
def test_emulated_passes_match_the_plain_versions(lib, case, h):
    degrees, neg = CASES[case]
    rng = np.random.default_rng(h)
    row_ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(degrees)]), dtype=torch.int32)
    nnz = int(row_ptr[-1])
    scores = torch.as_tensor(rng.normal(0.0, 30.0, (nnz, h)), dtype=torch.float32)
    if neg is not None:  # a row of -inf scores
        scores[int(row_ptr[neg]) : int(row_ptr[neg + 1])] = -torch.inf
    g = torch.as_tensor(rng.normal(0.0, 1.0, nnz), dtype=torch.float32)
    run = _Passes(lib, row_ptr)
    for aligned in (True, False):
        x, gx = (scores, g) if aligned else (_misaligned(scores), _misaligned(g))
        m, s = _twice(lambda: run.stats(x))
        ref_m, ref_s = K.softmax_stats_reference(row_ptr, scores.double(), T)
        assert torch.equal(m.double(), ref_m), f"{case}, h {h}: m"
        assert _amax((s.double() - ref_s) / ref_s.clamp(min=1.0)) <= TOL, f"{case}, h {h}: s"
        p, attn = _twice(lambda: run.apply(x, m, s))
        ref_p, ref_attn = K.softmax_apply_reference(row_ptr, scores.double(), m.double(), s.double(), T)
        _close(p, ref_p, f"{case}, h {h}: p")
        _close(attn, ref_attn, f"{case}, h {h}: attn")
        px = p if aligned else _misaligned(p)
        c = _twice(lambda: run.stats(px, gx))
        ref_c = K.softmax_stats_backward_reference(row_ptr, p.double(), g.double())
        _close(c, ref_c, f"{case}, h {h}: c")
        g_s = _twice(lambda: run.apply(px, c, None, gx))
        ref_gs = K.softmax_apply_backward_reference(row_ptr, p.double(), g.double(), c.double(), T)
        err = _amax(g_s.double() - ref_gs)
        assert err <= TOL * _amax(ref_gs), f"{case}, h {h}: g_s {err}"
