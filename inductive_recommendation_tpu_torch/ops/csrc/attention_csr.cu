// AttIGCN's attention over a CSR for Hopper (sm_90a): the scores kernel, its
// gradient, and the row softmax's statistics and apply passes.
//
//   sddmm_csr:          out[e, j] = a[r_e, j, :] . x[c_e, :] (+ b[r_e, j]),  j < h <= 8
//   sddmm_csr_backward: d_a[r, j, :] = sum_e g[e, j] x[c_e, :],  d_b[r, j] = sum_e g[e, j]
//   softmax_stats:      forward m[r, j] = max_e s[e, j], sum[r, j] = sum_e exp((s[e, j] - m[r, j]) / T);
//                       backward c[r, j] = sum_e p[e, j] g[e]
//   softmax_apply:      forward p[e, j] = exp((s[e, j] - m'[r_e, j]) / T) / sum'[r_e, j],
//                               attn[e] = mean_j p[e, j];
//                       backward g_s[e, j] = p[e, j] (g[e] - c[r_e, j]) / (h T)
//
// over the edges e in [row_ptr[r], row_ptr[r+1]) of each row r, c_e = col[e];
// m' is m where it is finite and 0 elsewhere, sum' is sum where it is > 0 and
// 1 elsewhere (the plain version's rules, ops/spmm.py segment_softmax). The
// row softmax of one CSR is softmax_stats then softmax_apply; on a shard of
// the edge-sharded layer the two all-reduces of parallel/attention.py come
// between them (the max of m, then the sums rescaled to them).
//
// Replaces: no TPU kernel. The JAX package computes this attention
// (inductive_recommendation_tpu/ops/attention_spmm.py::attention_spmm_fused_kv,
// :223, its forward _attention_forward_qk :175, the scores' einsum :201-202
// and its autodiff; sharded, inductive_recommendation_tpu/parallel/attention.py:70)
// with XLA ops and no Pallas kernel (:16-34). The port's first version
// gathered an [nnz, h, dv] copy of the folded query per edge and scattered
// its gradient back with atomics, then took the gradient as one SpMM a head
// on [x | 1 | 0 0 0]; these kernels read a row's folded query once, gather
// each x row once per edge for every head, and keep every sum in a fixed
// order.
//
// What bounds them: bytes. sddmm_csr at h = 4, dv = 64 does 2 h dv flops an
// edge against x's dv-wide row gathered per edge (256 B, largely from L2: x
// is 18 MB at the Gowalla-scale feature matrix, the gathers 477 MB a launch)
// and 8 + 4 h bytes of CSR and output, and reads the folded query a (72.5 MB
// at 4 heads, more than L2) once a row; sddmm_csr_backward moves the same
// gathers and writes a's shape. The softmax passes move a few floats an edge
// (the [nnz, h] scores read twice, the second time largely from L2, p
// written once).
//
// Design.
// - Every kernel but the scores is edge-balanced: [0, nnz) in chunks of
//   kSoftmaxChunk = 256 edges, one warp each, whatever the row degrees (a
//   12,745-edge row and a run of one-edge rows cost a warp the same). A
//   warp's walk starts at its chunk's first row, from a table made once a
//   layout (first_row: no search of row_ptr in each chunk), and loads 32 row
//   starts at once (chunk_rows).
// - sddmm_csr: chunks of kEdgesPerWarp = 128 edges, one warp each; the
//   warp copies the chunk's columns into shared memory with cp.async while
//   it finds its first row from the same table (row_of_edge), then walks
//   the chunk row by row. 16-byte path: P = 32 / G groups of G lanes, each
//   lane 4 columns of the row's a (h float4s in registers, read once a row)
//   and of each edge's x row, each group every P-th edge, kUnroll edges'
//   gathers in flight. The h dot products meet by __shfl_xor_sync, halving
//   the heads a lane holds each round (H - 1 + log2(G / H) shuffles, not H
//   log2 G); one lane of each team that ends with a head's sum writes it.
//   Each output is one edge's: nothing is carried between chunks. On the
//   card the kernel is bound by the latency of its gathers and instruction
//   chains more than by bytes: an edge-balanced rewrite (256-edge chunks,
//   the chunk's rows of a staged in shared memory by cp.async, one flat
//   loop over the edges) measured 1.8% slower at 4 heads and 6.5% faster
//   at one head (PERF.md, section 6), and did not pay for its code.
//   Widths dv % 4 != 0, dv > 128 or operands off 16-byte alignment take a
//   scalar kernel (the same chunks and walk, one column a lane, a[r] read
//   per edge).
// - sddmm_csr_backward: an SpMM whose h edge values share one gather, in
//   two launches as spmm_csr.cu's. The chunk kernel stages the chunk's
//   columns and its [256, h] cotangents in shared memory (cp.async), walks
//   its rows, and sums each row's part with H 16-byte accumulators a lane
//   (P groups of G lanes, every P-th edge, kUnroll edges in flight), d_b
//   beside them (no ones column); the groups meet by __shfl_xor_sync.
//   Rows that end in the chunk are written; the part of a row that runs in
//   from an earlier chunk goes to carry[c][0], the part of the row cut by
//   the chunk's end to carry[c][1] and its index to cut_row[c]; the last
//   chunk writes the trailing empty rows. The carry kernel adds each cut
//   row's parts in chunk order (one group of lanes a boundary and head).
//   dv % 4 != 0 or operands off 16-byte alignment take one float a lane;
//   widths over 4 G take more column tiles along grid.y.
// - The softmax passes: each lane takes kSoftmaxLane consecutive edges of
//   the warp's chunk. Lanes reading 16-byte pieces of their own runs
//   straight from global memory stream at less than half the rate of
//   coalesced accesses, so a warp first copies its chunk into a padded
//   shared-memory tile with coalesced 16-byte cp.async copies (the pad keeps
//   both the copies and each lane's reads of its run free of bank
//   conflicts), and the apply pass writes back through the same tile. The
//   copies are started before the warp finds its rows, so the walk's latency
//   hides behind them. The walk marks in the tile where each row starts; a
//   lane knows each of its edges' row from the marks and a max-scan over the
//   lanes.
//   * softmax_stats_chunk_kernel: each lane walks its edges in order and keeps
//     an online (max m, sum s of exp((x - m) / T)) of each head for each row
//     segment: one exp an entry (exp(-|x - m| / T) serves both a new max, as
//     the old sum's rescale, and an old one, as the new term). A row that
//     starts and ends inside the lane is written at once. The lanes' last
//     segments meet in a segmented scan over the warp (5 shuffle rounds, rows
//     as keys; segments combine by s = s_a exp((m_a - m) / T) + s_b exp((m_b -
//     m) / T), m = max(m_a, m_b), the factor of a segment with m = -inf being
//     0), and a lane's first segment takes the scan of the lanes before it.
//     The lane that holds a row's last edge in the chunk writes it. As in
//     spmm_csr.cu, the part of a row that runs into the chunk from an earlier
//     one goes to carry[c][0], the part of the row cut by the chunk's end to
//     carry[c][1] (its index to cut_row[c]), and the chunk writes every empty
//     row that starts in it (m = -inf, s = 0). Backward mode is the same walk
//     with c = sum p g as the statistic and a sum as the combine.
//   * softmax_stats_carry_kernel: a warp a chunk boundary combines a cut row's
//     carries, its lanes taking every 32nd chunk in order and meeting in a
//     fixed shuffle tree (a 50-chunk row is not a 50-step chain).
//   * softmax_apply_kernel: the same chunks, tile and row marks; each lane
//     loads its first two rows' statistics before it needs them (from L2:
//     [n_rows, h] is 1.1 MB at the Gowalla scale) and writes p and attn
//     (backward: g_s). Each output is one edge's, so nothing is carried.
//   The lanes' registers are sized for H >= h heads (1, 2, 4 or 8); h = 3,
//   5-7 and operands off 16-byte alignment take 4-byte copies (kVec false).
//   Divisions by T, h T and the row sums are multiplications by reciprocals
//   (an IEEE division branches to a slow path on a zero or infinite
//   numerator, which every row's max and every segment's start give), and
//   the exponentials are __expf (ex2.approx; within a few ulp here, far
//   inside the passes' tolerance of 1e-5).
// Nothing is atomic, every sum has a fixed order, and every kernel's
// registers are sized for H >= h heads (1, 2, 4 or 8), so one head does not
// pay for eight.

// Contract (checked by the Python wrapper, ops/attention_csr.py): every
// pointer on the current device and contiguous; row_ptr / col int32, cut_row
// int32, the rest fp32; 1 <= h <= kMaxHeads; nnz = row_ptr[n_rows] < 2^31; a
// and d_a are [n_rows, h, dv], x [n_cols, dv], b null or [n_rows, h], d_b
// [n_rows, h]; scores, p, g and g_s [nnz, h] (the softmax's g: [nnz]); attn
// [nnz]; the statistics [n_rows, h]; n_chunks = max(1, ceil(nnz /
// kSoftmaxChunk)) (SOFTMAX_CHUNK in attention_csr.py), the softmax's carry 4
// h floats, sddmm_csr_backward's carry_a 2 h dv and carry_b 2 h floats, and
// cut_row one int32 a chunk; first_row, for each chunk c, the first row r
// with row_ptr[r] >= c * kSoftmaxChunk. The launches go on the given stream,
// allocate nothing and do not synchronise. Each entry point returns
// cudaGetLastError() after its launches.

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
constexpr int kSoftmaxLane = 8;     // consecutive edges a softmax lane takes
constexpr int kSoftmaxChunk = 32 * kSoftmaxLane;  // a softmax warp's (SOFTMAX_CHUNK in attention_csr.py)
constexpr int kSoftmaxWarps = 4;    // a softmax block's (its tiles fit in 48 KB at 8 heads)
constexpr int kSoftmaxThreads = 32 * kSoftmaxWarps;
constexpr int kBwdWarps = 4;        // a sddmm_csr_backward block's (its tiles fit in 48 KB at 8 heads)

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

// The row after r that holds edge e, given row_ptr[r + 1] <= e < nnz.
__device__ __forceinline__ int next_row(const int* __restrict__ row_ptr, int n_rows, int r, int e, int lane) {
  const int i = r + 1 + lane;
  const bool holds = i < n_rows && __ldg(row_ptr + i + 1) > e;
  const unsigned ballot = __ballot_sync(kFull, holds);
  return ballot ? r + __ffs(ballot) : warp_lower_bound(row_ptr, n_rows, e + 1, lane) - 1;
}

// The row that holds edge e < nnz, from first_row's row f of e's softmax
// chunk (the first row starting at or after the chunk's first edge): f - 1
// when f starts past e, else the first row from f on that ends past e
// (mostly one ballot of 32 row ends; a search of row_ptr only past 32 rows).
__device__ __forceinline__ int row_of_edge(const int* __restrict__ row_ptr, const int* __restrict__ first_row,
                                           int n_rows, int e, int lane) {
  const int f = __ldg(first_row + e / kSoftmaxChunk);
  return __ldg(row_ptr + f) > e ? f - 1 : next_row(row_ptr, n_rows, f - 1, e, lane);
}

// 4-byte asynchronous copy from global to shared memory, and the wait for
// all of this thread's copies (as in spmm_csr.cu).
__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gptr) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// -- sddmm_csr --------------------------------------------------------------------

// A group's H dot products summed over its G lanes: each round a lane keeps
// half of its heads and sends the other half to its partner, then plain
// rounds for the head it keeps. Returns the first head whose sum the lane
// holds in s[0, kKept) (kKept = H / G when H > G, else 1; each team of G / H
// lanes holds the same).
template <int G, int H>
__device__ __forceinline__ int halve_heads(float (&s)[H], int gl) {
  int head = 0;
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
  return head;
}

// 16-byte path: G lanes of 4 columns cover dv <= 4 G; a[r] in registers;
// H >= h heads' registers (h in (H / 2, H]). At most 64 registers a thread
// (4 blocks an SM): the loop is bound by the latency of its gathers.
template <int G, int H>
__global__ void __launch_bounds__(kThreads, 4)
sddmm_vec_kernel(const int* __restrict__ row_ptr, const int* __restrict__ first_row, const int* __restrict__ col,
                 const float* __restrict__ a, const float* __restrict__ x, const float* __restrict__ b,
                 float* __restrict__ out, int n_rows, int nnz, int h, int dv, int n_chunks) {
  constexpr int P = 32 / G;
  constexpr int kKept = H > G ? H / G : 1, kTeam = H < G ? G / H : 1;
  __shared__ int s_cols[kWarpsPerBlock][kEdgesPerWarp];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;  // whole warps leave together
  int* s_col = s_cols[warp];
  const int group = lane / G, gl = lane % G, col0 = gl * 4;
  const bool active = col0 < dv;
  const int cs = c * kEdgesPerWarp;
  const int ce = cs + min(nnz - cs, kEdgesPerWarp);
  // stage the chunk's columns while the warp finds its first row
  for (int i = lane; i < ce - cs; i += 32) cp_async4(s_col + i, col + cs + i);
  int r = row_of_edge(row_ptr, first_row, n_rows, cs, lane);
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
        const int head = halve_heads<G, H>(s, gl);
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
sddmm_scalar_kernel(const int* __restrict__ row_ptr, const int* __restrict__ first_row, const int* __restrict__ col,
                    const float* __restrict__ a, const float* __restrict__ x, const float* __restrict__ b,
                    float* __restrict__ out, int n_rows, int nnz, int h, int dv, int n_chunks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;
  const int cs = c * kEdgesPerWarp;
  const int ce = cs + min(nnz - cs, kEdgesPerWarp);
  int r = row_of_edge(row_ptr, first_row, n_rows, cs, lane);
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

// -- the row softmax and its backward: statistics and apply passes ----------------

// 16-byte asynchronous copy from global to shared memory.
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gptr) : "memory");
}

// H contiguous floats at p, in the widest access their alignment allows
// (the caller checks 4 H-byte alignment, capped at 16).
template <int H>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* v) {
  if constexpr (H == 1) {
    v[0] = __ldg(p);
  } else if constexpr (H == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

template <int H>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (H == 1) {
    p[0] = v[0];
  } else if constexpr (H == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < H / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// A row segment's statistics of each of H >= h heads. Forward (kBwd false):
// a = the max m of its scores, b = s, the sum of exp((x - m) / T) over them;
// no edge, or only -inf scores, is m = -inf, s = 0. Backward: a = c, the sum
// of p g; b unused. inv_t is 1 / T.
template <bool kBwd, int H>
struct Stat {
  float a[H], b[H];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      a[j] = kBwd ? 0.f : -INFINITY;
      b[j] = 0.f;
    }
  }

  // One more edge: x its H values (scores; backward p), g its cotangent.
  __device__ __forceinline__ void add(const float* x, float g, float inv_t) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if constexpr (kBwd) {
        a[j] = fmaf(x[j], g, a[j]);
      } else {
        // exp(-|x - m| / T) is the rescale of the old sum when x is the new
        // max, else x's own term; an x of -inf adds nothing (and m = -inf
        // with it would give NaN)
        const float d = x[j] - a[j];
        const float e = x[j] == -INFINITY ? 0.f : __expf(-fabsf(d) * inv_t);
        if (d > 0.f) {
          b[j] = b[j] * e + 1.f;
          a[j] = x[j];
        } else {
          b[j] += e;
        }
      }
    }
  }

  // this = o (+) this, o holding the earlier edges of the same row.
  __device__ __forceinline__ void prepend(const Stat& o, float inv_t) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if constexpr (kBwd) {
        a[j] = o.a[j] + a[j];
      } else {
        // the factor of a segment whose max is -inf is 0 (its sum is 0)
        const float d = o.a[j] - a[j];
        const float e = o.a[j] == -INFINITY || a[j] == -INFINITY ? 0.f : __expf(-fabsf(d) * inv_t);
        if (d > 0.f) {
          b[j] = o.b[j] + b[j] * e;
          a[j] = o.a[j];
        } else {
          b[j] = o.b[j] * e + b[j];
        }
      }
    }
  }

  __device__ __forceinline__ Stat shfl_up(int d) const {
    Stat o;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      o.a[j] = __shfl_up_sync(kFull, a[j], d);
      o.b[j] = kBwd ? 0.f : __shfl_up_sync(kFull, b[j], d);
    }
    return o;
  }

  // Row i of the [., h] arrays out_a (m; backward c) and out_b (s).
  template <bool kVec>
  __device__ __forceinline__ void store(float* out_a, float* out_b, size_t i, int h) const {
    if constexpr (kVec) {
      store_vec<H>(out_a + i * H, a);
      if constexpr (!kBwd) store_vec<H>(out_b + i * H, b);
    } else {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        if (j < h) {
          out_a[i * h + j] = a[j];
          if constexpr (!kBwd) out_b[i * h + j] = b[j];
        }
      }
    }
  }

  // carry is [chunk][side][a, b][h]
  __device__ __forceinline__ void store_carry(float* carry, int c, int side, int h) const {
    float* p = carry + ((size_t)c * 2 + side) * 2 * h;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (j < h) {
        p[j] = a[j];
        p[h + j] = b[j];
      }
    }
  }

  __device__ __forceinline__ void load_carry(const float* carry, int c, int side, int h) {
    const float* p = carry + ((size_t)c * 2 + side) * 2 * h;
    clear();
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (j < h) {
        a[j] = p[j];
        b[j] = p[h + j];
      }
    }
  }
};

// One warp's shared memory in the softmax passes: its chunk's H values an
// edge (lane l's run of kSoftmaxLane edges at l * kStride, 16 bytes of pad
// between runs, so that the coalesced copies in and out and each lane's
// reads of its own run are free of bank conflicts), one float an edge (g;
// attn) laid out alike, and the row marks.
template <int H>
struct SoftmaxTile {
  static constexpr int kRun = kSoftmaxLane * H;
  static constexpr int kStride = kRun + 4;
  static constexpr int kEdgeStride = kSoftmaxLane + 4;
  float x[32 * kStride];
  float e[32 * kEdgeStride];
  int head[kSoftmaxChunk];
};

// Float i of the chunk's edges-by-H values, in the tile (run of edge i / H).
template <int H>
__device__ __forceinline__ int tile_pos(int i) {
  using Tile = SoftmaxTile<H>;
  return (i / Tile::kRun) * Tile::kStride + i % Tile::kRun;
}

__device__ __forceinline__ int edge_pos(int i) {
  return (i / kSoftmaxLane) * (kSoftmaxLane + 4) + i % kSoftmaxLane;
}

// Starts the copy of the chunk's values (in: [nnz, h]) and, when g is not
// null, its cotangents into the tile: 16-byte cp.async copies across the
// warp when kVec and the chunk is whole, else 4-byte loads (fill past h and
// past the last edge). The caller waits (cp_async_wait_all) and syncs.
template <bool kVec, int H>
__device__ __forceinline__ void stage_chunk(SoftmaxTile<H>& t, const float* __restrict__ in,
                                            const float* __restrict__ g, int cs, int n, int h, float fill,
                                            int lane) {
  if (kVec && n == kSoftmaxChunk) {
#pragma unroll
    for (int q = 0; q < kSoftmaxChunk * H / 128; ++q) {
      const int i = (q * 32 + lane) * 4;
      cp_async16(t.x + tile_pos<H>(i), in + (size_t)cs * H + i);
    }
    if (g != nullptr) {
#pragma unroll
      for (int q = 0; q < kSoftmaxChunk / 128; ++q) {
        const int i = (q * 32 + lane) * 4;
        cp_async16(t.e + edge_pos(i), g + cs + i);
      }
    }
  } else {
    for (int i = lane; i < kSoftmaxChunk * H; i += 32) {
      const int e = i / H, j = i % H;
      t.x[tile_pos<H>(i)] = e < n && j < h ? __ldg(in + (size_t)(cs + e) * h + j) : fill;
    }
    if (g != nullptr) {
      for (int i = lane; i < kSoftmaxChunk; i += 32) t.e[edge_pos(i)] = i < n ? __ldg(g + cs + i) : 0.f;
    }
  }
}

// Writes the tile's values (out: [nnz, h]) and, when attn is not null, its
// per-edge floats for the chunk's n edges: 16-byte stores across the warp
// when kVec and the chunk is whole, else 4-byte ones.
template <bool kVec, int H>
__device__ __forceinline__ void unstage_chunk(const SoftmaxTile<H>& t, float* __restrict__ out,
                                              float* __restrict__ attn, int cs, int n, int h, int lane) {
  if (kVec && n == kSoftmaxChunk) {
#pragma unroll
    for (int q = 0; q < kSoftmaxChunk * H / 128; ++q) {
      const int i = (q * 32 + lane) * 4;
      *reinterpret_cast<float4*>(out + (size_t)cs * H + i) = *reinterpret_cast<const float4*>(t.x + tile_pos<H>(i));
    }
    if (attn != nullptr) {
#pragma unroll
      for (int q = 0; q < kSoftmaxChunk / 128; ++q) {
        const int i = (q * 32 + lane) * 4;
        *reinterpret_cast<float4*>(attn + cs + i) = *reinterpret_cast<const float4*>(t.e + edge_pos(i));
      }
    }
  } else {
    for (int i = lane; i < n * H; i += 32) {
      const int e = i / H, j = i % H;
      if (j < h) out[(size_t)(cs + e) * h + j] = t.x[tile_pos<H>(i)];
    }
    if (attn != nullptr) {
      for (int i = lane; i < n; i += 32) attn[cs + i] = t.e[edge_pos(i)];
    }
  }
}

// The rows of chunk c = [cs, ce) (the last chunk also owns the trailing rows
// with row_ptr[r] == nnz): marks in head[p] the row whose first edge is
// cs + p (-1 where no row starts), calls empty(r) for each row without edges
// that starts in the chunk, and returns the row that runs into the chunk from
// an earlier one (-1 if none); cut gets the row that starts in the chunk and
// runs past ce (-1 if none). first_row[c] is the chunk's first row starting
// at or after cs. All lanes call it together.
template <typename Empty>
__device__ __forceinline__ int chunk_rows(const int* __restrict__ row_ptr, const int* __restrict__ first_row,
                                          int n_rows, int c, int cs, int ce, bool last, int lane, int* head, int& cut,
                                          Empty&& empty) {
#pragma unroll
  for (int i = 0; i < kSoftmaxLane; ++i) head[i * 32 + lane] = -1;
  const int r0 = __ldg(first_row + c);
  const int r_in = r0 > 0 && __ldg(row_ptr + r0) > cs ? r0 - 1 : -1;
  __syncwarp();
  int my_cut = -1;
  for (int rb = r0; rb < n_rows; rb += 32) {  // 32 rows at a time; starts do not decrease
    const int r = rb + lane;
    bool owned = false;
    if (r < n_rows) {
      const int start = __ldg(row_ptr + r), end = __ldg(row_ptr + r + 1);
      owned = start < ce || (last && start == ce);
      if (owned) {
        if (start == end) {
          empty(r);
        } else {
          head[start - cs] = r;  // one row with edges starts at a position
          if (end > ce) my_cut = r;
        }
      }
    }
    if (__ballot_sync(kFull, owned) != kFull) break;
  }
  const unsigned has = __ballot_sync(kFull, my_cut >= 0);
  cut = has ? __shfl_sync(kFull, my_cut, __ffs(has) - 1) : -1;
  __syncwarp();
  return r_in;
}

// This lane's kSoftmaxLane row marks, and the row of its first edge: its own
// mark, else the last mark of the lanes before it, else r_in. All lanes call
// it together.
__device__ __forceinline__ int lane_rows(const int* head, int lane, int r_in, int (&f)[kSoftmaxLane]) {
  static_assert(kSoftmaxLane == 8, "two int4 reads of the marks");
  const int4 f0 = reinterpret_cast<const int4*>(head + lane * kSoftmaxLane)[0];
  const int4 f1 = reinterpret_cast<const int4*>(head + lane * kSoftmaxLane)[1];
  f[0] = f0.x, f[1] = f0.y, f[2] = f0.z, f[3] = f0.w, f[4] = f1.x, f[5] = f1.y, f[6] = f1.z, f[7] = f1.w;
  int mark = -1;  // rows increase with their start: the last mark is the largest
#pragma unroll
  for (int k = 0; k < kSoftmaxLane; ++k) mark = max(mark, f[k]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, mark, d);
    if (lane >= d) mark = max(mark, o);
  }
  int before = __shfl_up_sync(kFull, mark, 1);
  if (lane == 0) before = -1;
  return f[0] >= 0 ? f[0] : max(before, r_in);
}

// The lane's run from the tile: its kSoftmaxLane edges' H values (x, edge k
// at k * H) and, when kG, their per-edge floats.
template <int H, bool kG>
__device__ __forceinline__ void lane_read(const SoftmaxTile<H>& t, int lane, float* x, float* gv) {
  using Tile = SoftmaxTile<H>;
#pragma unroll
  for (int q = 0; q < Tile::kRun / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(t.x + lane * Tile::kStride + 4 * q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
  if constexpr (kG) {
#pragma unroll
    for (int q = 0; q < kSoftmaxLane / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(t.e + lane * Tile::kEdgeStride + 4 * q);
      gv[4 * q] = v.x;
      gv[4 * q + 1] = v.y;
      gv[4 * q + 2] = v.z;
      gv[4 * q + 3] = v.w;
    }
  }
}

// The statistics of every row: forward m into out_a and s into out_b,
// backward c = sum p g into out_a; rows cut by a chunk boundary leave their
// parts in carry (and cut_row) for softmax_stats_carry_kernel.
template <bool kBwd, bool kVec, int H>
__global__ void __launch_bounds__(kSoftmaxThreads)
softmax_stats_chunk_kernel(const int* __restrict__ row_ptr, const int* __restrict__ first_row,
                           const float* __restrict__ in, const float* __restrict__ g,
                           float* __restrict__ out_a, float* __restrict__ out_b, float* __restrict__ carry,
                           int* __restrict__ cut_row, int n_rows, int nnz, int h, float inv_t, int n_chunks) {
  using S = Stat<kBwd, H>;
  __shared__ __align__(16) SoftmaxTile<H> tiles[kSoftmaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kSoftmaxWarps + warp;
  if (c >= n_chunks) return;  // whole warps leave together
  SoftmaxTile<H>& t = tiles[warp];
  const int cs = c * kSoftmaxChunk;
  const int ce = cs + min(nnz - cs, kSoftmaxChunk);
  const bool last = c == n_chunks - 1;
  // the chunk's values come in while the warp finds its rows
  stage_chunk<kVec, H>(t, in, kBwd ? g : nullptr, cs, ce - cs, h, kBwd ? 0.f : -INFINITY, lane);
  int cut;
  const int r_in = chunk_rows(row_ptr, first_row, n_rows, c, cs, ce, last, lane, t.head, cut, [&](int r) {
    S z;
    z.clear();
    z.template store<kVec>(out_a, out_b, (size_t)r, h);
  });
  cp_async_wait_all();
  __syncwarp();
  // where a finished segment goes: a cut row's and the run-in row's parts to
  // the carries, every other row to its statistics
  auto finish = [&](int r, const S& st) {
    if (r == r_in) {
      st.store_carry(carry, c, 0, h);
    } else if (r == cut) {
      st.store_carry(carry, c, 1, h);
    } else {
      st.template store<kVec>(out_a, out_b, (size_t)r, h);
    }
  };
  const int n_e = max(0, min(kSoftmaxLane, ce - cs - lane * kSoftmaxLane));
  float x[kSoftmaxLane * H], gv[kSoftmaxLane];
  lane_read<H, kBwd>(t, lane, x, gv);
  int f[kSoftmaxLane];
  const int first = lane_rows(t.head, lane, r_in, f);
  // the lane's edges in order: its first segment kept (it may have begun in
  // an earlier lane), the rows that start and end here written, the last
  // one left for the scan
  int cur = first, head_row = -1;
  S st, head;
  st.clear();
  head.clear();
#pragma unroll
  for (int k = 0; k < kSoftmaxLane; ++k) {
    if (k < n_e) {
      if (k > 0 && f[k] >= 0) {
        if (head_row < 0) {
          head = st;
          head_row = cur;
        } else {
          finish(cur, st);
        }
        cur = f[k];
        st.clear();
      }
      st.add(x + k * H, kBwd ? gv[k] : 0.f, inv_t);
    }
  }
  // segmented inclusive scan of the lanes' last segments, rows as keys (a
  // lane without edges has a key of its own)
  const int key = n_e > 0 ? cur : -2 - lane;
  S sc = st;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int k_o = __shfl_up_sync(kFull, key, d);
    const S o = sc.shfl_up(d);
    if (lane >= d && k_o == key) sc.prepend(o, inv_t);
  }
  const int k_before = __shfl_up_sync(kFull, key, 1);
  const S before = sc.shfl_up(1);
  const int next_first = __shfl_down_sync(kFull, n_e > 0 ? first : -1, 1);
  if (head_row >= 0) {  // the first segment ends here: with the lanes before it, if its row began there
    if (lane > 0 && k_before == head_row) head.prepend(before, inv_t);
    finish(head_row, head);
  }
  // the last segment, if its row does not go on in the next lane
  if (n_e > 0 && (lane == 31 || next_first != cur)) finish(cur, sc);
  if (!last && lane == 0) cut_row[c] = cut;
}

// The statistics of each row cut by a chunk boundary, one warp a boundary:
// lane l combines the carries of the chunks c + 1 + l, c + 33 + l, ... in
// order, lane 0 starting from the cut row's own part, and the lanes meet in
// a fixed tree (the combine commutes in exact arithmetic; a fixed order
// keeps the bits).
template <bool kBwd, int H>
__global__ void __launch_bounds__(kThreads)
softmax_stats_carry_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cut_row,
                           const float* __restrict__ carry, float* __restrict__ out_a, float* __restrict__ out_b,
                           int h, float inv_t, int n_bounds) {
  using S = Stat<kBwd, H>;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= n_bounds) return;  // whole warps leave together
  const int r = cut_row[c];
  if (r < 0) return;
  const int c1 = (__ldg(row_ptr + r + 1) - 1) / kSoftmaxChunk;  // the chunk of r's last edge
  S acc;
  acc.clear();
  if (lane == 0) acc.load_carry(carry, c, 1, h);
  for (int k = c + 1 + lane; k <= c1; k += 32) {
    S part;
    part.load_carry(carry, k, 0, h);
    part.prepend(acc, inv_t);
    acc = part;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    S o;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      o.a[j] = __shfl_xor_sync(kFull, acc.a[j], m);
      o.b[j] = kBwd ? 0.f : __shfl_xor_sync(kFull, acc.b[j], m);
    }
    acc.prepend(o, inv_t);
  }
  if (lane == 0) acc.template store<false>(out_a, out_b, (size_t)r, h);
}

// The row statistics of the apply pass with the plain version's rules:
// forward ra = m (0 where not finite) and rb = 1 / s (1 where s is not > 0),
// backward ra = c.
template <bool kBwd, bool kVec, int H>
__device__ __forceinline__ void row_stats(const float* __restrict__ stat_a, const float* __restrict__ stat_b,
                                          size_t r, int h, float* ra, float* rb) {
#pragma unroll
  for (int j = 0; j < H; ++j) ra[j] = rb[j] = 0.f;
  if constexpr (kVec) {
    load_vec<H>(stat_a + r * H, ra);
    if constexpr (!kBwd) load_vec<H>(stat_b + r * H, rb);
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (j < h) {
        ra[j] = __ldg(stat_a + r * h + j);
        if constexpr (!kBwd) rb[j] = __ldg(stat_b + r * h + j);
      }
    }
  }
  if constexpr (!kBwd) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (!isfinite(ra[j])) ra[j] = 0.f;  // a row with no finite max uses 0
      rb[j] = rb[j] > 0.f ? 1.f / rb[j] : 1.f;  // a zero sum is taken as 1
    }
  }
}

// Forward: p[e] and attn[e] from the scores and the row statistics m
// (stat_a) and s (stat_b). Backward: g_s[e] from p, g and c (stat_a).
// scale is 1 / T forward, 1 / (h T) backward.
template <bool kBwd, bool kVec, int H>
__global__ void __launch_bounds__(kSoftmaxThreads)
softmax_apply_kernel(const int* __restrict__ row_ptr, const int* __restrict__ first_row,
                     const float* __restrict__ in, const float* __restrict__ g,
                     const float* __restrict__ stat_a, const float* __restrict__ stat_b, float* __restrict__ out,
                     float* __restrict__ attn, int n_rows, int nnz, int h, float scale, int n_chunks) {
  __shared__ __align__(16) SoftmaxTile<H> tiles[kSoftmaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kSoftmaxWarps + warp;
  if (c >= n_chunks) return;
  SoftmaxTile<H>& t = tiles[warp];
  const int cs = c * kSoftmaxChunk;
  const int n = min(nnz - cs, kSoftmaxChunk);
  stage_chunk<kVec, H>(t, in, kBwd ? g : nullptr, cs, n, h, 0.f, lane);
  int cut;
  const int r_in = chunk_rows(row_ptr, first_row, n_rows, c, cs, cs + n, c == n_chunks - 1, lane, t.head, cut,
                              [](int) {});
  int f[kSoftmaxLane];
  const int first = lane_rows(t.head, lane, r_in, f);
  const int n_e = max(0, min(kSoftmaxLane, n - lane * kSoftmaxLane));
  // the statistics of the lane's first row and of the first row that starts
  // in its run, both loaded before any is needed; any later row on demand
  int second = -1;
#pragma unroll
  for (int k = kSoftmaxLane - 1; k > 0; --k) {
    if (k < n_e && f[k] >= 0) second = f[k];
  }
  float ra[H], rb[H], ra2[H], rb2[H];
  if (n_e > 0) row_stats<kBwd, kVec, H>(stat_a, stat_b, (size_t)first, h, ra, rb);
  if (second >= 0) row_stats<kBwd, kVec, H>(stat_a, stat_b, (size_t)second, h, ra2, rb2);
  cp_async_wait_all();
  __syncwarp();
  float x[kSoftmaxLane * H], gv[kSoftmaxLane];
  lane_read<H, kBwd>(t, lane, x, gv);
  const float inv_h = 1.f / static_cast<float>(h);
  float mean[kSoftmaxLane];
#pragma unroll
  for (int k = 0; k < kSoftmaxLane; ++k) {
    mean[k] = 0.f;
    if (k < n_e) {
      if (k > 0 && f[k] >= 0) {  // a new row
        if (f[k] == second) {
#pragma unroll
          for (int j = 0; j < H; ++j) ra[j] = ra2[j], rb[j] = rb2[j];
        } else {
          row_stats<kBwd, kVec, H>(stat_a, stat_b, (size_t)f[k], h, ra, rb);
        }
      }
#pragma unroll
      for (int j = 0; j < H; ++j) {
        float& v = x[k * H + j];
        if (kBwd) {
          v = v * (gv[k] - ra[j]) * scale;
        } else {
          v = __expf((v - ra[j]) * scale) * rb[j];
          if (j < h) mean[k] += v;
        }
      }
      mean[k] *= inv_h;
    }
  }
  // back through the tile (the lane's own run), then out in whole rows of 16 bytes
  using Tile = SoftmaxTile<H>;
#pragma unroll
  for (int q = 0; q < Tile::kRun / 4; ++q) {
    *reinterpret_cast<float4*>(t.x + lane * Tile::kStride + 4 * q) =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
  if (!kBwd) {
#pragma unroll
    for (int q = 0; q < kSoftmaxLane / 4; ++q) {
      *reinterpret_cast<float4*>(t.e + lane * Tile::kEdgeStride + 4 * q) =
          make_float4(mean[4 * q], mean[4 * q + 1], mean[4 * q + 2], mean[4 * q + 3]);
    }
  }
  __syncwarp();
  unstage_chunk<kVec, H>(t, out, kBwd ? nullptr : attn, cs, n, h, lane);
}

// -- sddmm_csr_backward --------------------------------------------------------------

template <int VW>
struct Vec;

template <>
struct Vec<4> {
  float4 v;
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = v; }
  __device__ __forceinline__ void add(const Vec& o) {
    v.x += o.v.x;
    v.y += o.v.y;
    v.z += o.v.z;
    v.w += o.v.w;
  }
  __device__ __forceinline__ void fma(float w, const Vec& o) {
    v.x = fmaf(w, o.v.x, v.x);
    v.y = fmaf(w, o.v.y, v.y);
    v.z = fmaf(w, o.v.z, v.z);
    v.w = fmaf(w, o.v.w, v.w);
  }
  __device__ __forceinline__ void add_xor(int mask) {
    v.x += __shfl_xor_sync(kFull, v.x, mask);
    v.y += __shfl_xor_sync(kFull, v.y, mask);
    v.z += __shfl_xor_sync(kFull, v.z, mask);
    v.w += __shfl_xor_sync(kFull, v.w, mask);
  }
};

template <>
struct Vec<1> {
  float v;
  __device__ __forceinline__ void zero() { v = 0.f; }
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ void store(float* p) const { *p = v; }
  __device__ __forceinline__ void add(const Vec& o) { v += o.v; }
  __device__ __forceinline__ void fma(float w, const Vec& o) { v = fmaf(w, o.v, v); }
  __device__ __forceinline__ void add_xor(int mask) { v += __shfl_xor_sync(kFull, v, mask); }
};

// The sums over the chunk-local edges [lo, hi) of one row: acc[j] = sum
// g[., j] x[col, col0 .. col0 + VW) and bs[j] = sum g[., j], each lane's
// group taking every P-th edge, reduced over the P groups: every lane
// returns the sums of its columns. All lanes of the warp call it together
// (lo and hi are uniform; an empty row takes no shuffle).
template <int G, int VW, int H>
__device__ __forceinline__ void bwd_row_sum(const int* s_col, const float* s_g, int lo, int hi,
                                            const float* __restrict__ x, int dv, int col0, bool active, int group,
                                            int h, Vec<VW> (&acc)[H], float (&bs)[H]) {
  constexpr int P = 32 / G;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    acc[j].zero();
    bs[j] = 0.f;
  }
  if (lo >= hi) return;
  for (int e = lo + group; e < hi; e += kUnroll * P) {
    Vec<VW> xv[kUnroll];
    float w[kUnroll][H];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = e + u * P;
#pragma unroll
      for (int j = 0; j < H; ++j) w[u][j] = i < hi && j < h ? s_g[i * h + j] : 0.f;
      if (active && i < hi) {
        xv[u].load(x + (size_t)s_col[i] * dv + col0);
      } else {
        xv[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        acc[j].fma(w[u][j], xv[u]);
        bs[j] += w[u][j];
      }
    }
  }
#pragma unroll
  for (int m = G; m < 32; m <<= 1) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      acc[j].add_xor(m);
      bs[j] += __shfl_xor_sync(kFull, bs[j], m);
    }
  }
}

// Launch 1: every row with all its edges in the chunk; the parts of the rows
// cut by its ends to carry_a / carry_b ([chunk][run-in, cut][h][dv] and
// [chunk][run-in, cut][h]) and the cut row to cut_row.
template <int G, int VW, int H>
__global__ void __launch_bounds__(kBwdWarps * 32)
sddmm_bwd_chunk_kernel(const int* __restrict__ row_ptr, const int* __restrict__ first_row,
                       const int* __restrict__ col, const float* __restrict__ g, const float* __restrict__ x,
                       float* __restrict__ d_a, float* __restrict__ d_b, float* __restrict__ carry_a,
                       float* __restrict__ carry_b, int* __restrict__ cut_row, int n_rows, int nnz, int h, int dv,
                       int n_chunks) {
  __shared__ __align__(16) int s_cols[kBwdWarps][kSoftmaxChunk];
  __shared__ __align__(16) float s_gs[kBwdWarps][kSoftmaxChunk * H];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kBwdWarps + warp;
  if (c >= n_chunks) return;  // whole warps leave together
  int* s_col = s_cols[warp];
  float* s_g = s_gs[warp];
  const int group = lane / G;
  const int col0 = blockIdx.y * (G * VW) + (lane % G) * VW;
  const bool active = col0 < dv;
  const bool writer = active && lane < G;  // group 0 writes the reduced sums
  const bool first_tile = blockIdx.y == 0;  // its lane 0 writes d_b and cut_row
  const int cs = c * kSoftmaxChunk;
  const int ce = cs + min(nnz - cs, kSoftmaxChunk);
  const bool last = c == n_chunks - 1;
  // the chunk's columns and cotangents come in while the warp finds its first row
  for (int i = lane; i < ce - cs; i += 32) cp_async4(s_col + i, col + cs + i);
  const int ng = (ce - cs) * h;
  const float* gc = g + (size_t)cs * h;
  const int ng4 = (reinterpret_cast<uintptr_t>(gc) & 15) == 0 ? ng / 4 : 0;
  for (int i = lane; i < ng4; i += 32) cp_async16(s_g + 4 * i, gc + 4 * i);
  for (int i = 4 * ng4 + lane; i < ng; i += 32) cp_async4(s_g + i, gc + i);
  int r = __ldg(first_row + c);  // the first row starting at or after cs
  int start = __ldg(row_ptr + r);
  cp_async_wait_all();
  __syncwarp();
  Vec<VW> acc[H];
  float bs[H];
  auto store = [&](float* pa, float* pb) {  // a row's [h][dv] and [h]
    if (writer) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        if (j < h) acc[j].store(pa + (size_t)j * dv + col0);
      }
    }
    if (first_tile && lane == 0) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        if (j < h) pb[j] = bs[j];
      }
    }
  };
  if (r > 0 && start > cs) {  // row r - 1 runs into this chunk from an earlier one
    bwd_row_sum<G, VW, H>(s_col, s_g, 0, min(start, ce) - cs, x, dv, col0, active, group, h, acc, bs);
    store(carry_a + (size_t)c * 2 * h * dv, carry_b + (size_t)c * 2 * h);
  }
  int cut = -1;
  bool more = r < n_rows && (last || start < ce);
  while (more) {
    const int nb = min(32, n_rows - r);
    const int my_end = lane < nb ? __ldg(row_ptr + r + 1 + lane) : 0;
    for (int j = 0; j < nb; ++j) {
      const int end = __shfl_sync(kFull, my_end, j);
      bwd_row_sum<G, VW, H>(s_col, s_g, start - cs, min(end, ce) - cs, x, dv, col0, active, group, h, acc, bs);
      if (end > ce) {  // a row that runs past the chunk leaves its part for the carry pass
        cut = r + j;
        store(carry_a + ((size_t)c * 2 + 1) * h * dv, carry_b + ((size_t)c * 2 + 1) * h);
      } else {
        store(d_a + (size_t)(r + j) * h * dv, d_b + (size_t)(r + j) * h);
      }
      start = end;
      if (!last && start >= ce) {
        more = false;
        break;
      }
    }
    r += nb;
    more = more && r < n_rows;
  }
  if (!last && lane == 0 && first_tile) cut_row[c] = cut;
}

// Launch 2: each row cut by a chunk boundary, its parts added in chunk order;
// a group of G lanes a boundary, head j = blockIdx.z.
template <int G, int VW>
__global__ void __launch_bounds__(kThreads)
sddmm_bwd_carry_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cut_row,
                       const float* __restrict__ carry_a, const float* __restrict__ carry_b, float* __restrict__ d_a,
                       float* __restrict__ d_b, int h, int dv, int n_bounds) {
  constexpr int P = 32 / G;
  constexpr int kBatch = 16;
  const int lane = threadIdx.x & 31;
  const int c = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * P + lane / G;
  const int j = blockIdx.z;
  const int col0 = blockIdx.y * (G * VW) + (lane % G) * VW;
  if (c >= n_bounds || col0 >= dv) return;  // no shuffles below: lanes may leave alone
  const int r = cut_row[c];
  if (r < 0) return;
  const int c1 = (__ldg(row_ptr + r + 1) - 1) / kSoftmaxChunk;  // the chunk of r's last edge
  auto part = [&](int k, int side) { return carry_a + (((size_t)k * 2 + side) * h + j) * dv + col0; };
  Vec<VW> sum;
  sum.load(part(c, 1));
  for (int k = c + 1; k <= c1; k += kBatch) {
    // unconditional loads (past c1 they repeat c1's) keep all kBatch in flight
    Vec<VW> parts[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) parts[u].load(part(min(k + u, c1), 0));
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k + u <= c1) sum.add(parts[u]);
    }
  }
  sum.store(d_a + ((size_t)r * h + j) * dv + col0);
  if (col0 == 0) {  // one lane a boundary and head: d_b
    float sb = carry_b[((size_t)c * 2 + 1) * h + j];
    for (int k = c + 1; k <= c1; ++k) sb += carry_b[(size_t)k * 2 * h + j];
    d_b[(size_t)r * h + j] = sb;
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

// Calls f(Int<G>(), Int<VW>()) with sddmm_csr_backward's lane layout of width
// dv: 16-byte loads by groups of G = 4..32 lanes when vec, else one float a
// lane over 32 lanes (as spmm_csr.cu).
template <typename F>
void with_layout(int dv, bool vec, F&& f) {
  if (!vec) {
    f(Int<32>(), Int<1>());
  } else if (dv <= 16) {
    f(Int<4>(), Int<4>());
  } else if (dv <= 32) {
    f(Int<8>(), Int<4>());
  } else if (dv <= 64) {
    f(Int<16>(), Int<4>());
  } else {
    f(Int<32>(), Int<4>());
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Rows of H floats at p take H-float accesses (16-byte ones at most).
bool aligned_rows(const void* p, int H) { return (reinterpret_cast<uintptr_t>(p) & (4 * (H < 4 ? H : 4) - 1)) == 0; }

unsigned blocks_for(long long units) { return (unsigned)((units + kWarpsPerBlock - 1) / kWarpsPerBlock); }

unsigned softmax_blocks(int n_chunks) { return (unsigned)((n_chunks + kSoftmaxWarps - 1) / kSoftmaxWarps); }

}  // namespace

// K1: out[e, j] = a[r_e, j, :] . x[col[e], :] (+ b[r_e, j]); b may be null.
// first_row is the softmax passes' table; the chunks are kEdgesPerWarp edges.
extern "C" int sddmm_csr(const void* row_ptr, const void* first_row, const void* col, const void* a, const void* x,
                         const void* b, void* out, int n_rows, int nnz, int h, int dv, void* stream) {
  if (nnz > 0 && n_rows > 0 && h >= 1 && h <= kMaxHeads) {
    const int n_chunks = (nnz + kEdgesPerWarp - 1) / kEdgesPerWarp;
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto kernel) {
      kernel<<<blocks_for(n_chunks), kThreads, 0, s>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(first_row), static_cast<const int*>(col),
          static_cast<const float*>(a), static_cast<const float*>(x), static_cast<const float*>(b),
          static_cast<float*>(out), n_rows, nnz, h, dv, n_chunks);
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

// The scores' gradient: d_a[r, j, :] = sum_e g[e, j] x[col[e], :] and d_b[r,
// j] = sum_e g[e, j] over each row's edges. Two launches when there is more
// than one chunk: the chunks, then the cut rows.
extern "C" int sddmm_csr_backward(const void* row_ptr, const void* first_row, const void* col, const void* g,
                                  const void* x, void* d_a, void* d_b, void* carry_a, void* carry_b, void* cut_row,
                                  int n_rows, int nnz, int h, int dv, int n_chunks, void* stream) {
  if (n_rows > 0 && dv > 0 && h >= 1 && h <= kMaxHeads) {
    auto s = static_cast<cudaStream_t>(stream);
    const bool vec = dv % 4 == 0 && aligned16(x) && aligned16(d_a) && aligned16(carry_a);
    with_layout(dv, vec, [&](auto gg, auto vw) {
      constexpr int G = decltype(gg)::value, VW = decltype(vw)::value;
      const unsigned tiles = (unsigned)((dv + G * VW - 1) / (G * VW));
      with_heads(h, [&](auto hh) {
        constexpr int H = decltype(hh)::value;
        const dim3 grid((unsigned)((n_chunks + kBwdWarps - 1) / kBwdWarps), tiles);
        sddmm_bwd_chunk_kernel<G, VW, H><<<grid, kBwdWarps * 32, 0, s>>>(
            static_cast<const int*>(row_ptr), static_cast<const int*>(first_row), static_cast<const int*>(col),
            static_cast<const float*>(g), static_cast<const float*>(x), static_cast<float*>(d_a),
            static_cast<float*>(d_b), static_cast<float*>(carry_a), static_cast<float*>(carry_b),
            static_cast<int*>(cut_row), n_rows, nnz, h, dv, n_chunks);
      });
      const int n_bounds = n_chunks - 1;
      if (n_bounds > 0 && cudaPeekAtLastError() == cudaSuccess) {
        constexpr int per_block = kWarpsPerBlock * (32 / G);  // boundaries a block sums
        const dim3 grid((unsigned)((n_bounds + per_block - 1) / per_block), tiles, (unsigned)h);
        sddmm_bwd_carry_kernel<G, VW><<<grid, kThreads, 0, s>>>(
            static_cast<const int*>(row_ptr), static_cast<const int*>(cut_row), static_cast<const float*>(carry_a),
            static_cast<const float*>(carry_b), static_cast<float*>(d_a), static_cast<float*>(d_b), h, dv, n_bounds);
      }
    });
  }
  return (int)cudaGetLastError();
}

// The statistics pass. Forward (backward 0): m into out_a and s into out_b
// from the scores in; backward: c = sum p g into out_a from p (in) and g.
// Two launches when there is more than one chunk: the chunks, then the cut
// rows.
extern "C" int softmax_stats(const void* row_ptr, const void* first_row, const void* in, const void* g, void* out_a,
                             void* out_b, void* carry, void* cut_row, int n_rows, int nnz, int h, float T,
                             int n_chunks, int backward, void* stream) {
  if (n_rows > 0 && h >= 1 && h <= kMaxHeads) {
    auto s = static_cast<cudaStream_t>(stream);
    const bool bwd = backward != 0;
    const float inv_t = 1.f / T;
    with_heads(h, [&](auto hh) {
      constexpr int H = decltype(hh)::value;
      const bool vec = h == H && aligned16(in) && (!bwd || aligned16(g)) && aligned_rows(out_a, H) &&
                       (bwd || aligned_rows(out_b, H));
      auto chunks = [&](auto kernel) {
        kernel<<<softmax_blocks(n_chunks), kSoftmaxThreads, 0, s>>>(
            static_cast<const int*>(row_ptr), static_cast<const int*>(first_row), static_cast<const float*>(in),
            static_cast<const float*>(g), static_cast<float*>(out_a), static_cast<float*>(out_b),
            static_cast<float*>(carry), static_cast<int*>(cut_row), n_rows, nnz, h, inv_t, n_chunks);
      };
      if (bwd) {
        chunks(vec ? softmax_stats_chunk_kernel<true, true, H> : softmax_stats_chunk_kernel<true, false, H>);
      } else {
        chunks(vec ? softmax_stats_chunk_kernel<false, true, H> : softmax_stats_chunk_kernel<false, false, H>);
      }
      const int n_bounds = n_chunks - 1;
      if (n_bounds > 0 && cudaPeekAtLastError() == cudaSuccess) {
        auto kernel = bwd ? softmax_stats_carry_kernel<true, H> : softmax_stats_carry_kernel<false, H>;
        kernel<<<blocks_for(n_bounds), kThreads, 0, s>>>(
            static_cast<const int*>(row_ptr), static_cast<const int*>(cut_row), static_cast<const float*>(carry),
            static_cast<float*>(out_a), static_cast<float*>(out_b), h, inv_t, n_bounds);
      }
    });
  }
  return (int)cudaGetLastError();
}

// The apply pass. Forward (backward 0): p into out and attn from the scores
// in and the statistics m (stat_a), s (stat_b); backward: g_s into out from
// p (in), g and c (stat_a).
extern "C" int softmax_apply(const void* row_ptr, const void* first_row, const void* in, const void* g,
                             const void* stat_a, const void* stat_b, void* out, void* attn, int n_rows, int nnz,
                             int h, float T, int n_chunks, int backward, void* stream) {
  if (n_rows > 0 && nnz > 0 && h >= 1 && h <= kMaxHeads) {
    const bool bwd = backward != 0;
    const float scale = bwd ? 1.f / (static_cast<float>(h) * T) : 1.f / T;
    with_heads(h, [&](auto hh) {
      constexpr int H = decltype(hh)::value;
      const bool vec = h == H && aligned16(in) && aligned16(out) && (bwd ? aligned16(g) : aligned16(attn)) &&
                       aligned_rows(stat_a, H) && (bwd || aligned_rows(stat_b, H));
      auto args = [&](auto kernel) {
        kernel<<<softmax_blocks(n_chunks), kSoftmaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(row_ptr), static_cast<const int*>(first_row), static_cast<const float*>(in),
            static_cast<const float*>(g), static_cast<const float*>(stat_a), static_cast<const float*>(stat_b),
            static_cast<float*>(out),
            static_cast<float*>(attn), n_rows, nnz, h, scale, n_chunks);
      };
      if (bwd) {
        args(vec ? softmax_apply_kernel<true, true, H> : softmax_apply_kernel<true, false, H>);
      } else {
        args(vec ? softmax_apply_kernel<false, true, H> : softmax_apply_kernel<false, false, H>);
      }
    });
  }
  return (int)cudaGetLastError();
}
