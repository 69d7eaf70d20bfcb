// AttIGCN's attention over a CSR for Hopper (sm_90a): three kernels.
//
//   sddmm_csr:                    out[e, j] = a[r_e, j, :] . x[c_e, :] (+ b[r_e, j]),  j < h <= 8
//   segment_softmax_csr:          p[e, j]   = exp((s[e, j] - max_row j) / T) / sum_row j,
//                                 attn[e]   = mean_j p[e, j]
//   segment_softmax_csr_backward: g_s[e, j] = p[e, j] * (g[e] - sum_row p[., j] * g[.]) / (h * T)
//
// over the edges e in [row_ptr[r], row_ptr[r+1]) of each row r, c_e = col[e].
//
// Replaces: no TPU kernel. The JAX package computes this attention
// (inductive_recommendation_tpu/ops/attention_spmm.py::attention_spmm_fused_kv,
// :223, its forward _attention_forward_qk :175) with XLA ops and no Pallas
// kernel (:16-34). The port's first version gathered an [nnz, h, dv] copy of
// the folded query per edge and scattered its gradient back with atomics;
// these kernels read a row's folded query once and keep every sum in a fixed
// order.
//
// What bounds them: bytes. sddmm_csr at h = 4, dv = 64 does 2 * h * dv flops
// an edge against x's dv-wide row gathered per edge (256 B, largely from L2:
// x is 18 MB at the Gowalla-scale feature matrix) and 8 + 4 h bytes of CSR
// and output; the softmax kernels move a few floats an edge.
//
// Design.
// - sddmm_csr walks [0, nnz) in chunks of kEdgesPerWarp edges, one warp each,
//   like spmm_csr.cu's first launch: every warp has the same number of edges
//   whatever the row degrees, and no chunk carries anything to another, since
//   every output is one edge's. A warp finds the row of its first edge by a
//   32-way search of row_ptr, then walks the rows that hold its edges, the
//   next one found from 32 row ends loaded at once (a run of empty rows costs
//   one load, or a search when it is longer than 32 rows). For each row it
//   loads a[r] into registers once: lanes form P = 32 / G groups of G lanes,
//   each lane holding 4 columns of every head (16-byte loads), and each group
//   takes every P-th edge, kUnroll edges a group in flight. A group's h dot
//   products meet by __shfl_xor_sync, halving the heads a lane holds each
//   round (H - 1 + log2(G / H) shuffles, not H log2 G: 5 instead of 16 at 4
//   heads and G = 16); one lane of each team that ends with a head's sum
//   writes it.
//   Widths dv % 4 != 0, dv > 128 or operands off 16-byte alignment take a
//   scalar variant (one column a lane, a[r] read from L1 per edge).
//   The chunk's columns are staged in shared memory with cp.async while the
//   warp searches for its first row. The registers are sized for H >= h
//   heads (1, 2, 4 or 8), so one head does not pay for eight.
// - The softmax kernels give each row of up to kLongRow edges one warp (8
//   rows a block) and each longer row a block of its own (256 threads; the
//   wrapper lists those rows once a layout, and their blocks come first in
//   the grid, so that they do not form the launch's tail), so a 12,745-edge
//   row is neither walked by 32 lanes nor queued behind its neighbours: the
//   power-law head of the feature matrix (its first rows) would otherwise
//   share a block.
//   A thread loads kRowUnroll edges at once. Runs of empty rows cost a warp
//   each, which returns at once. Each reduction is a fixed tree (a thread's
//   edges in order, __shfl_xor_sync, then the block's warps in order): the
//   same inputs give the same bits.
//
// Contract (checked by the Python wrapper, ops/attention_csr.py): every
// pointer on the current device and contiguous; row_ptr / col int32, the rest
// fp32; 1 <= h <= kMaxHeads; nnz = row_ptr[n_rows] < 2^31; a is
// [n_rows, h, dv], x [n_cols, dv], b null or [n_rows, h]; scores, p and g_s
// [nnz, h]; attn and g [nnz]; long_rows int32, every row with more than
// kLongRow edges once. The launches go on the given stream, allocate
// nothing and do not synchronise. Each entry point returns cudaGetLastError()
// after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxHeads = 8;
constexpr int kEdgesPerWarp = 128;  // sddmm_csr's chunk
constexpr int kUnroll = 4;          // edges a group keeps in flight
constexpr int kLongRow = 256;       // longer rows get a block (LONG_ROW in attention_csr.py)
constexpr int kRowUnroll = 4;       // edges a softmax thread loads at once

// The first i in [0, n] with a[i] >= v, for a nondecreasing a[0..n] with
// a[n] >= v (as in spmm_csr.cu). Uniform across the warp.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n, int v, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int stride = (hi - lo + 31) / 32;
    const int p = lo + lane * stride;
    const bool ge = p >= hi || __ldg(a + p) >= v;
    const unsigned ballot = __ballot_sync(kFull, ge);
    const int k = ballot ? __ffs(ballot) - 1 : 32;
    if (k == 0) {
      hi = lo;
    } else {
      const int nlo = lo + (k - 1) * stride + 1;
      if (k < 32) hi = min(lo + k * stride, hi);
      lo = nlo;
    }
  }
  return lo;
}

// The row after r that holds edge e, given row_ptr[r + 1] == e < nnz.
__device__ __forceinline__ int next_row(const int* __restrict__ row_ptr, int n_rows, int r, int e, int lane) {
  const int i = r + 1 + lane;
  const bool holds = i < n_rows && __ldg(row_ptr + i + 1) > e;
  const unsigned ballot = __ballot_sync(kFull, holds);
  return ballot ? r + __ffs(ballot) : warp_lower_bound(row_ptr, n_rows, e + 1, lane) - 1;
}

// 4-byte asynchronous copy from global to shared memory, and the wait for
// all of this thread's copies (as in spmm_csr.cu).
__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gptr) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// -- sddmm_csr --------------------------------------------------------------------

// 16-byte path: G lanes of 4 columns cover dv <= 4 G; a[r] in registers;
// H >= h heads' registers (h in (H / 2, H]). At most 64 registers a thread
// (4 blocks an SM): the loop is bound by the latency of its gathers.
template <int G, int H>
__global__ void __launch_bounds__(kThreads, 4)
sddmm_vec_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col, const float* __restrict__ a,
                 const float* __restrict__ x, const float* __restrict__ b, float* __restrict__ out,
                 int n_rows, int nnz, int h, int dv, int n_chunks) {
  constexpr int P = 32 / G;
  __shared__ int s_cols[kWarpsPerBlock][kEdgesPerWarp];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;  // whole warps leave together
  int* s_col = s_cols[warp];
  const int group = lane / G, gl = lane % G, col0 = gl * 4;
  const bool active = col0 < dv;
  const int cs = c * kEdgesPerWarp;
  const int ce = cs + min(nnz - cs, kEdgesPerWarp);
  // stage the chunk's columns while the warp searches for its first row
  for (int i = lane; i < ce - cs; i += 32) cp_async4(s_col + i, col + cs + i);
  int r = warp_lower_bound(row_ptr, n_rows, cs + 1, lane) - 1;  // the row holding edge cs
  cp_async_wait_all();
  __syncwarp();
  int e0 = cs;
  while (true) {
    const int rend = min(__ldg(row_ptr + r + 1), ce);
    float4 ar[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      ar[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < h && active) ar[j] = __ldg(reinterpret_cast<const float4*>(a + ((size_t)r * h + j) * dv + col0));
    }
    for (int first = e0; first < rend; first += kUnroll * P) {  // uniform across the warp
      float4 xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = first + u * P + group;
        xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (active && i < rend) xv[u] = __ldg(reinterpret_cast<const float4*>(x + (size_t)s_col[i - cs] * dv + col0));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float s[H];
#pragma unroll
        for (int j = 0; j < H; ++j) {
          s[j] = ar[j].x * xv[u].x;
          s[j] = fmaf(ar[j].y, xv[u].y, s[j]);
          s[j] = fmaf(ar[j].z, xv[u].z, s[j]);
          s[j] = fmaf(ar[j].w, xv[u].w, s[j]);
        }
        // the group's h sums by halving: each round a lane keeps half of
        // its heads and sends the other half to its partner, then plain
        // rounds for the head it keeps
        int head = 0;  // the first head this lane keeps
#pragma unroll
        for (int rnd = 0, m = G / 2; m > 0; ++rnd, m >>= 1) {
          const int k = H >> rnd;  // heads a lane holds before this round
          if (k > 1) {
            const bool upper = (gl & m) != 0;
#pragma unroll
            for (int q = 0; q < k / 2; ++q) {
              const float send = upper ? s[q] : s[q + k / 2];
              const float keep = upper ? s[q + k / 2] : s[q];
              s[q] = keep + __shfl_xor_sync(kFull, send, m);
            }
            if (upper) head += k / 2;
          } else {
            s[0] += __shfl_xor_sync(kFull, s[0], m);
          }
        }
        // each team of kTeam lanes holds the same kKept heads' sums
        constexpr int kKept = H > G ? H / G : 1, kTeam = H < G ? G / H : 1;
        const int i = first + u * P + group;
        if (i < rend && (gl & (kTeam - 1)) == 0) {
#pragma unroll
          for (int q = 0; q < kKept; ++q) {
            const int j = head + q;
            if (j < h) out[(size_t)i * h + j] = b != nullptr ? s[q] + __ldg(b + (size_t)r * h + j) : s[q];
          }
        }
      }
    }
    if (rend >= ce) break;
    e0 = rend;
    r = next_row(row_ptr, n_rows, r, e0, lane);
  }
}

// Scalar path: any dv, any alignment; lane l takes the columns l, l + 32, ...
__global__ void __launch_bounds__(kThreads)
sddmm_scalar_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col, const float* __restrict__ a,
                    const float* __restrict__ x, const float* __restrict__ b, float* __restrict__ out,
                    int n_rows, int nnz, int h, int dv, int n_chunks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;
  const int cs = c * kEdgesPerWarp;
  const int ce = cs + min(nnz - cs, kEdgesPerWarp);
  int r = warp_lower_bound(row_ptr, n_rows, cs + 1, lane) - 1;
  int e0 = cs;
  while (true) {
    const int rend = min(__ldg(row_ptr + r + 1), ce);
    const float* ar = a + (size_t)r * h * dv;
    for (int i = e0; i < rend; ++i) {
      const float* xr = x + (size_t)__ldg(col + i) * dv;
      float s[kMaxHeads];
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) s[j] = 0.f;
      for (int k = lane; k < dv; k += 32) {
        const float xk = __ldg(xr + k);
#pragma unroll
        for (int j = 0; j < kMaxHeads; ++j) {
          if (j < h) s[j] = fmaf(__ldg(ar + (size_t)j * dv + k), xk, s[j]);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
        for (int j = 0; j < kMaxHeads; ++j) {
          if (j < h) s[j] += __shfl_xor_sync(kFull, s[j], m);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxHeads; ++j) {
        if (j < h && j == lane) out[(size_t)i * h + j] = b != nullptr ? s[j] + __ldg(b + (size_t)r * h + j) : s[j];
      }
    }
    if (rend >= ce) break;
    e0 = rend;
    r = next_row(row_ptr, n_rows, r, e0, lane);
  }
}

// -- the row softmax and its backward ---------------------------------------------

// Reduces v[0..h) over a team: the warp (kBlock false) or the whole block
// (kBlock true: each warp's result through shared memory, combined in warp
// order). Every thread of the team gets the same bits. kMax: max, else sum.
template <bool kBlock, bool kMax, int H>
__device__ __forceinline__ void team_reduce(float (&v)[H], int h, float (*sh)[kMaxHeads]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (j < h) {
        const float o = __shfl_xor_sync(kFull, v[j], m);
        v[j] = kMax ? fmaxf(v[j], o) : v[j] + o;
      }
    }
  }
  if constexpr (kBlock) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < H; ++j) sh[warp][j] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (j < h) {
        float t = sh[0][j];
        for (int w = 1; w < kWarpsPerBlock; ++w) t = kMax ? fmaxf(t, sh[w][j]) : t + sh[w][j];
        v[j] = t;
      }
    }
    __syncthreads();  // sh is free again
  }
}

// Loads the h scores of kRowUnroll edges e0, e0 + n, ... (fill past end).
template <int H>
__device__ __forceinline__ void load_edges(const float* __restrict__ in, int e0, int n, int end, int h, float fill,
                                           float (&v)[kRowUnroll][H]) {
#pragma unroll
  for (int u = 0; u < kRowUnroll; ++u) {
    const int e = e0 + u * n;
#pragma unroll
    for (int j = 0; j < H; ++j) v[u][j] = e < end && j < h ? __ldg(in + (size_t)e * h + j) : fill;
  }
}

// One row [start, end) by a team of n threads, thread t of them; each
// thread takes the edges t, t + n, ..., kRowUnroll of them at a time, and
// sums them in edge order.
template <bool kBlock, int H>
__device__ void softmax_row(const float* __restrict__ scores, float* __restrict__ p, float* __restrict__ attn,
                            int start, int end, int h, float T, int t, int n, float (*sh)[kMaxHeads]) {
  float m[H], s[H], v[kRowUnroll][H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    m[j] = -INFINITY;
    s[j] = 0.f;
  }
  for (int e0 = start + t; e0 < end; e0 += kRowUnroll * n) {
    load_edges(scores, e0, n, end, h, -INFINITY, v);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < H; ++j) m[j] = fmaxf(m[j], v[u][j]);
    }
  }
  team_reduce<kBlock, true>(m, h, sh);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (!isfinite(m[j])) m[j] = 0.f;  // the plain version's rule for a row with no finite max
  }
  for (int e0 = start + t; e0 < end; e0 += kRowUnroll * n) {
    load_edges(scores, e0, n, end, h, 0.f, v);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (e0 + u * n < end) {
#pragma unroll
        for (int j = 0; j < H; ++j) s[j] += expf((v[u][j] - m[j]) / T);
      }
    }
  }
  team_reduce<kBlock, false>(s, h, sh);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (!(s[j] > 0.f)) s[j] = 1.f;  // a zero sum is taken as 1
  }
  for (int e0 = start + t; e0 < end; e0 += kRowUnroll * n) {
    load_edges(scores, e0, n, end, h, 0.f, v);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int e = e0 + u * n;
      if (e < end) {
        float mean = 0.f;
#pragma unroll
        for (int j = 0; j < H; ++j) {
          if (j < h) {
            const float pj = expf((v[u][j] - m[j]) / T) / s[j];
            p[(size_t)e * h + j] = pj;
            mean += pj;
          }
        }
        attn[e] = mean / static_cast<float>(h);
      }
    }
  }
}

template <bool kBlock, int H>
__device__ void softmax_backward_row(const float* __restrict__ p, const float* __restrict__ g,
                                     float* __restrict__ g_s, int start, int end, int h, float hT, int t, int n,
                                     float (*sh)[kMaxHeads]) {
  float c[H], v[kRowUnroll][H], ge[kRowUnroll];
#pragma unroll
  for (int j = 0; j < H; ++j) c[j] = 0.f;
  for (int e0 = start + t; e0 < end; e0 += kRowUnroll * n) {
    load_edges(p, e0, n, end, h, 0.f, v);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) ge[u] = e0 + u * n < end ? __ldg(g + e0 + u * n) : 0.f;
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (e0 + u * n < end) {
#pragma unroll
        for (int j = 0; j < H; ++j) c[j] = fmaf(v[u][j], ge[u], c[j]);
      }
    }
  }
  team_reduce<kBlock, false>(c, h, sh);
  for (int e0 = start + t; e0 < end; e0 += kRowUnroll * n) {
    load_edges(p, e0, n, end, h, 0.f, v);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) ge[u] = e0 + u * n < end ? __ldg(g + e0 + u * n) : 0.f;
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int e = e0 + u * n;
      if (e < end) {
#pragma unroll
        for (int j = 0; j < H; ++j) {
          if (j < h) g_s[(size_t)e * h + j] = v[u][j] * (ge[u] - c[j]) / hT;
        }
      }
    }
  }
}

// Blocks [0, n_long): one for each row listed in long_rows, first, so that
// they are not the tail of the launch; then one warp a row, the rows up to
// kLongRow edges.
template <bool kBackward, int H>
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const int* __restrict__ row_ptr, const int* __restrict__ long_rows, int n_long,
                    const float* __restrict__ in, const float* __restrict__ g, float* __restrict__ out,
                    float* __restrict__ attn, int n_rows, int h, float T) {
  __shared__ float sh[kWarpsPerBlock][kMaxHeads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int r, t, n;
  if (blockIdx.x >= n_long) {  // uniform across the block
    r = (blockIdx.x - n_long) * kWarpsPerBlock + warp;
    if (r >= n_rows) return;  // whole warps leave together
    t = lane;
    n = 32;
  } else {
    r = __ldg(long_rows + blockIdx.x);
    t = threadIdx.x;
    n = kThreads;
  }
  const int start = __ldg(row_ptr + r), end = __ldg(row_ptr + r + 1);
  const bool block_row = end - start > kLongRow;
  if (block_row != (n == kThreads)) return;  // a long row is its block's; an empty row writes nothing
  if (block_row) {
    if constexpr (kBackward) {
      softmax_backward_row<true, H>(in, g, out, start, end, h, static_cast<float>(h) * T, t, n, sh);
    } else {
      softmax_row<true, H>(in, out, attn, start, end, h, T, t, n, sh);
    }
  } else {
    if constexpr (kBackward) {
      softmax_backward_row<false, H>(in, g, out, start, end, h, static_cast<float>(h) * T, t, n, sh);
    } else {
      softmax_row<false, H>(in, out, attn, start, end, h, T, t, n, sh);
    }
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<H>()) with the register width H >= h of h heads: 1, 2, 4 or 8.
template <typename F>
void with_heads(int h, F&& f) {
  if (h == 1) {
    f(Int<1>());
  } else if (h == 2) {
    f(Int<2>());
  } else if (h <= 4) {
    f(Int<4>());
  } else {
    f(Int<8>());
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

unsigned blocks_for(long long units) { return (unsigned)((units + kWarpsPerBlock - 1) / kWarpsPerBlock); }

}  // namespace

// K1: out[e, j] = a[r_e, j, :] . x[col[e], :] (+ b[r_e, j]); b may be null.
extern "C" int sddmm_csr(const void* row_ptr, const void* col, const void* a, const void* x, const void* b,
                         void* out, int n_rows, int nnz, int h, int dv, void* stream) {
  if (nnz > 0 && n_rows > 0 && h >= 1 && h <= kMaxHeads) {
    const int n_chunks = (nnz + kEdgesPerWarp - 1) / kEdgesPerWarp;
    const dim3 grid(blocks_for(n_chunks));
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, s>>>(static_cast<const int*>(row_ptr), static_cast<const int*>(col),
                                       static_cast<const float*>(a), static_cast<const float*>(x),
                                       static_cast<const float*>(b), static_cast<float*>(out), n_rows, nnz, h, dv,
                                       n_chunks);
    };
    if (dv % 4 != 0 || dv > 128 || !aligned16(a) || !aligned16(x)) {
      args(sddmm_scalar_kernel);
    } else {
      with_heads(h, [&](auto hh) {
        constexpr int H = decltype(hh)::value;
        if (dv <= 16) {
          args(sddmm_vec_kernel<4, H>);
        } else if (dv <= 32) {
          args(sddmm_vec_kernel<8, H>);
        } else if (dv <= 64) {
          args(sddmm_vec_kernel<16, H>);
        } else {
          args(sddmm_vec_kernel<32, H>);
        }
      });
    }
  }
  return (int)cudaGetLastError();
}

// K2: p[e, j] = exp((scores[e, j] - max) / T) / sum over the row, attn[e] = mean_j p[e, j].
// long_rows: the n_long rows with more than kLongRow edges, in any order.
extern "C" int segment_softmax_csr(const void* row_ptr, const void* long_rows, int n_long, const void* scores,
                                   void* p, void* attn, int n_rows, int h, float T, void* stream) {
  if (n_rows > 0 && h >= 1 && h <= kMaxHeads) {
    with_heads(h, [&](auto hh) {
      softmax_rows_kernel<false, decltype(hh)::value>
          <<<blocks_for(n_rows) + n_long, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const int*>(row_ptr), static_cast<const int*>(long_rows), n_long,
              static_cast<const float*>(scores), nullptr, static_cast<float*>(p), static_cast<float*>(attn), n_rows,
              h, T);
    });
  }
  return (int)cudaGetLastError();
}

// K3: g_s[e, j] = p[e, j] * (g[e] - sum over the row of p[., j] * g[.]) / (h * T).
extern "C" int segment_softmax_csr_backward(const void* row_ptr, const void* long_rows, int n_long, const void* p,
                                            const void* g, void* g_s, int n_rows, int h, float T, void* stream) {
  if (n_rows > 0 && h >= 1 && h <= kMaxHeads) {
    with_heads(h, [&](auto hh) {
      softmax_rows_kernel<true, decltype(hh)::value>
          <<<blocks_for(n_rows) + n_long, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const int*>(row_ptr), static_cast<const int*>(long_rows), n_long,
              static_cast<const float*>(p), static_cast<const float*>(g), static_cast<float*>(g_s), nullptr, n_rows,
              h, T);
    });
  }
  return (int)cudaGetLastError();
}
