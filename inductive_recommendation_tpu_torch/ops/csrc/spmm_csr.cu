// CSR sparse x dense product for Hopper (sm_90a): out[r] = sum_e val[e] * x[col[e]]
// over the edges e in [row_ptr[r], row_ptr[r+1]).
//
// Replaces: inductive_recommendation_tpu/ops/pallas_spmm.py::_kernel (driven by
// spmm_ell_pallas), the TPU's ELL gather-reduce SpMM. That kernel fetched each
// neighbour row with its own DMA inside a 128-row tile; here warps gather the
// neighbour rows with ordinary 16-byte loads out of L2.
//
// What bounds it: bytes. The work is 2 * nnz * d flops against at least
// 8 B/edge of CSR (col + val), x read once and out written once, so the byte
// floor is far above the flop floor. The gathered traffic is nnz * d * 4 B
// (459 MB at the Gowalla-scale adjacency, d = 64), which can come largely from
// the 50 MB L2 since x (18 MB there) fits in it: the kernel is bound by the
// L2 gather rate, if it keeps enough gathers in flight and splits power-law
// rows (a 12,745-edge row walked by one warp took as long as the whole
// launch). On an H100 80GB HBM3 at 700 W launch 1 gathers at 6.9-7.3 TB/s,
// above the 3.35 TB/s HBM peak (chip_smoke.py).
//
// Design: two launches, both deterministic (no atomics, a fixed order of sums).
//
// 1. spmm_chunk_kernel: [0, nnz) is cut into chunks of E = kEdgesPerChunk
//    edges, one warp each, so every warp has the same number of edges whatever
//    the row degrees. Chunk c = [cs, ce) = [c*E, min((c+1)*E, nnz)) owns
//      * the rows that start in it, cs <= row_ptr[r] < ce (the last chunk also
//        the trailing rows with row_ptr[r] == nnz): each is written to out[r]
//        when it ends inside the chunk (empty rows as zeros), else its part in
//        the chunk goes to carry[c][1] and its index to cut_row[c] (-1 when
//        no row runs past the chunk);
//      * the part in [cs, ce) of the row that started before cs and runs into
//        the chunk, which goes to carry[c][0].
//    A warp stages the chunk's col/val in shared memory with coalesced
//    cp.async copies, finds its first row by a 32-way search of row_ptr while
//    they are in flight, and walks its rows with the row ends loaded 32 at a
//    time. Within a row the lanes form
//    P = 32 / G groups of G lanes; each group takes every P-th edge and each
//    lane gathers VW = 4 floats (one 16-byte load) of the edge's x row, U edges
//    a group at a time, so a warp has U * P edges (U * 32 loads) in flight
//    before its FMAs. At d = 64 a half-warp covers a 256 B row of x: two edges
//    a step, eight in flight. The groups' sums meet by __shfl_xor_sync at the
//    row's end. Any d % 4 == 0 with a 16-byte aligned x takes this path (wider
//    than 32 * 4 columns: more column tiles along grid.y); other d take VW = 1,
//    one float a lane, 32 columns a tile.
// 2. spmm_carry_kernel: for each chunk c but the last with r = cut_row[c] >= 0,
//    out[r] = carry[c][1] + carry[c+1][0] + ... + carry[c1][0], c1 the chunk of
//    r's last edge: the partials of each cut row, added in chunk order. One
//    group of G lanes per chunk, the same VW-float loads as launch 1, in
//    batches of 16 partials.
//
// Edge dropout (training): given an eid array, launch 1 also stages each
// chunk's edge ids and rewrites the staged values before any gather: edge e
// keeps val[e] / (1 - p) when u >= p, else 0, with u the top 24 bits of the
// first word of Philox4x32-10 keyed by the 64-bit seed at the counter
// (eid[e], 0, 0, 0), times 2^-24 (exact in fp32, so u >= p compares as the
// plain version's edge_uniform does). The draw depends on the edge id alone,
// so the transpose layout (same eids) drops the same edges in the backward.
// It is a compile-time variant (kDrop): the serving instantiation is the
// same code as without it. Launch 2 does not read edges and is unchanged.
// The training backward runs both launches on the transpose CSR. The seed
// is a launch argument, or, given seed_ptr, the 64-bit word there, read
// when the kernel runs: a training step captured in a CUDA graph keeps its
// seeds in a table on the card that the host rewrites before each replay.
//
// Contract (checked by the Python wrapper before the call): every pointer is
// on the current device, row_ptr/col/eid are int32, val/x/out/carry are fp32
// and contiguous, eid is null or holds nnz ids in [0, 2^31), seed_ptr is
// null or points to 8 bytes on the device, 0 <= p < 1, x has d columns,
// nnz = row_ptr[n_rows] < 2^31, n_chunks = max(1, ceil(nnz / E)) (the
// wrapper's n_chunks, with EDGES_PER_CHUNK = E),
// and carry holds 2 * d floats and cut_row one int32 per chunk when there is
// more than one chunk. The carry buffer is [chunk][2][d] whatever lane layout
// either launch takes, so each picks its own. The launches go on the given
// stream, allocate nothing and do not synchronise. Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// Edges per warp in launch 1 (E above; EDGES_PER_CHUNK in csr_spmm.py). Of
// 64-512, 192 was the fastest on the Gowalla-scale products (PERF.md).
constexpr int kEdgesPerChunk = 192;

// The first i in [0, n] with a[i] >= v, for a nondecreasing a[0..n] with
// a[n] >= v. Each round the 32 lanes probe 32 evenly spaced points, so a
// search over 70,000 rows takes five dependent loads. Uniform across the warp.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n, int v, int lane) {
  int lo = 0, hi = n;  // the answer is in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + 31) / 32;
    const int p = lo + lane * stride;
    const bool ge = p >= hi || __ldg(a + p) >= v;
    // k: the first probe at or above v, 32 (hi) when every probe is below it
    const unsigned ballot = __ballot_sync(kFull, ge);
    const int k = ballot ? __ffs(ballot) - 1 : 32;
    if (k == 0) {
      hi = lo;
    } else {
      const int nlo = lo + (k - 1) * stride + 1;  // just past the last probe below v
      if (k < 32) hi = min(lo + k * stride, hi);
      lo = nlo;
    }
  }
  return lo;
}

// 4-byte asynchronous copy from global to shared memory, and the wait for
// all of this thread's copies.
__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gptr) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The first output word of Philox4x32-10 (Salmon et al., SC'11) at the
// counter (c0, 0, 0, 0) under the key (k0, k1): philox_word0 in csr_spmm.py.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t k0, uint32_t k1) {
  uint32_t c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

template <int VW>
struct Vec;

template <>
struct Vec<4> {
  float4 v;
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = v; }
  __device__ __forceinline__ void add(const Vec& x) {
    v.x += x.v.x;
    v.y += x.v.y;
    v.z += x.v.z;
    v.w += x.v.w;
  }
  __device__ __forceinline__ void fma(float w, const Vec& x) {
    v.x = fmaf(w, x.v.x, v.x);
    v.y = fmaf(w, x.v.y, v.y);
    v.z = fmaf(w, x.v.z, v.z);
    v.w = fmaf(w, x.v.w, v.w);
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
  __device__ __forceinline__ void add(const Vec& x) { v += x.v; }
  __device__ __forceinline__ void fma(float w, const Vec& x) { v = fmaf(w, x.v, v); }
  __device__ __forceinline__ void add_xor(int mask) { v += __shfl_xor_sync(kFull, v, mask); }
};

// Edges each group keeps in flight before its FMAs.
constexpr int kUnroll = 4;

// The sum over the chunk-local edges [a, b) of s_val * x[s_col], for this
// lane's VW columns at col0, reduced over the P groups: every lane returns
// the same sum for its columns. All lanes of the warp call it together.
template <int G, int VW>
__device__ __forceinline__ Vec<VW> row_sum(const int* s_col, const float* s_val, int a, int b,
                                           const float* __restrict__ x, int d, int col0,
                                           bool active, int group) {
  constexpr int P = 32 / G;
  Vec<VW> acc;
  acc.zero();
  for (int e = a + group; e < b; e += kUnroll * P) {
    Vec<VW> xv[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = e + u * P;
      if (active && i < b) {
        w[u] = s_val[i];
        xv[u].load(x + (size_t)s_col[i] * d + col0);
      } else {
        w[u] = 0.f;
        xv[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc.fma(w[u], xv[u]);
  }
#pragma unroll
  for (int m = G; m < 32; m <<= 1) acc.add_xor(m);
  return acc;
}

template <int G, int VW, bool kDrop>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_chunk_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                  const float* __restrict__ val, const int* __restrict__ eid,
                  unsigned long long seed, const unsigned long long* __restrict__ seed_ptr, float p,
                  const float* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ carry, int* __restrict__ cut_row,
                  int n_rows, int nnz, int d, int n_chunks) {
  __shared__ int s_cols[kWarpsPerBlock][kEdgesPerChunk];
  __shared__ float s_vals[kWarpsPerBlock][kEdgesPerChunk];
  __shared__ int s_eids[kDrop ? kWarpsPerBlock : 1][kDrop ? kEdgesPerChunk : 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;  // whole warps leave together
  int* s_col = s_cols[warp];
  float* s_val = s_vals[warp];

  const int group = lane / G;
  const int col0 = blockIdx.y * (G * VW) + (lane % G) * VW;
  const bool active = col0 < d;
  const bool writer = active && lane < G;  // group 0 writes the reduced sums
  const int cs = c * kEdgesPerChunk;
  const int ce = cs + min(nnz - cs, kEdgesPerChunk);  // no int32 overflow near nnz = 2^31
  const bool last = c == n_chunks - 1;

  for (int i = lane; i < ce - cs; i += 32) {
    cp_async4(s_col + i, col + cs + i);
    cp_async4(s_val + i, val + cs + i);
    if constexpr (kDrop) cp_async4(s_eids[warp] + i, eid + cs + i);
  }
  int r = warp_lower_bound(row_ptr, n_rows, cs, lane);  // the first row starting at or after cs
  int start = __ldg(row_ptr + r);
  cp_async_wait_all();
  if constexpr (kDrop) {
    // each lane rewrites the values it staged itself, before the warp syncs
    const unsigned long long key = seed_ptr ? __ldg(seed_ptr) : seed;
    const uint32_t k0 = static_cast<uint32_t>(key), k1 = static_cast<uint32_t>(key >> 32);
    for (int i = lane; i < ce - cs; i += 32) {
      const uint32_t bits = philox_word0(static_cast<uint32_t>(s_eids[warp][i]), k0, k1);
      const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-8f;  // 2^-24
      s_val[i] = u >= p ? s_val[i] / (1.0f - p) : 0.0f;
    }
  }
  __syncwarp();
  if (r > 0 && start > cs) {  // row r - 1 runs into this chunk from an earlier one
    const Vec<VW> s = row_sum<G, VW>(s_col, s_val, 0, min(start, ce) - cs, x, d, col0, active, group);
    if (writer) s.store(carry + ((size_t)c * 2) * d + col0);
  }
  int cut = -1;
  bool more = r < n_rows && (last || start < ce);
  while (more) {
    const int nb = min(32, n_rows - r);
    const int my_end = lane < nb ? __ldg(row_ptr + r + 1 + lane) : 0;
    for (int j = 0; j < nb; ++j) {
      const int end = __shfl_sync(kFull, my_end, j);
      const Vec<VW> s = row_sum<G, VW>(s_col, s_val, start - cs, min(end, ce) - cs, x, d, col0, active, group);
      if (end > ce) cut = r + j;  // a row that runs past the chunk leaves its part for the carry pass
      if (writer) s.store(end <= ce ? out + (size_t)(r + j) * d + col0 : carry + ((size_t)c * 2 + 1) * d + col0);
      start = end;
      if (!last && start >= ce) {
        more = false;
        break;
      }
    }
    r += nb;
    more = more && r < n_rows;
  }
  if (!last && lane == 0 && blockIdx.y == 0) cut_row[c] = cut;
}

// Adds the carries of every row cut by a chunk boundary, in chunk order.
template <int G, int VW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_carry_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cut_row,
                  const float* __restrict__ carry, float* __restrict__ out, int d, int n_bounds) {
  constexpr int P = 32 / G;
  constexpr int kBatch = 16;
  const int lane = threadIdx.x & 31;
  const int c = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * P + lane / G;
  const int col0 = blockIdx.y * (G * VW) + (lane % G) * VW;
  if (c >= n_bounds || col0 >= d) return;  // no shuffles below: lanes may leave alone
  const int r = cut_row[c];
  if (r < 0) return;
  const int c1 = (__ldg(row_ptr + r + 1) - 1) / kEdgesPerChunk;
  Vec<VW> sum;
  sum.load(carry + ((size_t)c * 2 + 1) * d + col0);
  for (int k = c + 1; k <= c1; k += kBatch) {
    // unconditional loads (past c1 they repeat c1's) keep all kBatch in flight
    Vec<VW> part[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) part[u].load(carry + ((size_t)min(k + u, c1) * 2) * d + col0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k + u <= c1) sum.add(part[u]);
    }
  }
  sum.store(out + (size_t)r * d + col0);
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<G>, Int<VW>) for the lane layout of width d: 16-byte loads by
// groups of G = 4..32 lanes when vec, else one float a lane over 32 lanes.
template <typename F>
void with_layout(int d, bool vec, F&& f) {
  if (!vec) {
    f(Int<32>(), Int<1>());
  } else if (d <= 16) {
    f(Int<4>(), Int<4>());
  } else if (d <= 32) {
    f(Int<8>(), Int<4>());
  } else if (d <= 64) {
    f(Int<16>(), Int<4>());
  } else {
    f(Int<32>(), Int<4>());
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launch 1: every row with all its edges in one chunk, and the carries of the
// others; with edge dropout when eid is not null, keyed by *seed_ptr when
// that is not null, else by seed.
extern "C" int spmm_csr_chunks(const void* row_ptr, const void* col, const void* val, const void* eid,
                               unsigned long long seed, const void* seed_ptr, float p, const void* x, void* out,
                               void* carry, void* cut_row, int n_rows, int nnz, int d, int n_chunks,
                               void* stream) {
  if (n_rows > 0 && d > 0) {
    const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(carry);
    with_layout(d, vec, [&](auto g, auto vw) {
      constexpr int G = decltype(g)::value, VW = decltype(vw)::value;
      const dim3 grid((unsigned)((n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock), (unsigned)((d + G * VW - 1) / (G * VW)));
      auto kernel = eid ? spmm_chunk_kernel<G, VW, true> : spmm_chunk_kernel<G, VW, false>;
      kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col), static_cast<const float*>(val),
          static_cast<const int*>(eid), seed, static_cast<const unsigned long long*>(seed_ptr), p,
          static_cast<const float*>(x), static_cast<float*>(out),
          static_cast<float*>(carry), static_cast<int*>(cut_row), n_rows, nnz, d, n_chunks);
    });
  }
  return (int)cudaGetLastError();
}

// Launch 2, when there is more than one chunk: the rows cut by a chunk
// boundary, from the carries of launch 1.
extern "C" int spmm_csr_carries(const void* row_ptr, const void* cut_row, const void* carry,
                                void* out, int n_rows, int d, int n_chunks, void* stream) {
  const int n_bounds = n_chunks - 1;
  if (n_rows > 0 && d > 0 && n_bounds > 0) {
    const bool vec = d % 4 == 0 && aligned16(carry) && aligned16(out);
    with_layout(d, vec, [&](auto g, auto vw) {
      constexpr int G = decltype(g)::value, VW = decltype(vw)::value;
      constexpr int per_block = kWarpsPerBlock * (32 / G);  // chunks a block sums
      const dim3 grid((unsigned)((n_bounds + per_block - 1) / per_block), (unsigned)((d + G * VW - 1) / (G * VW)));
      spmm_carry_kernel<G, VW><<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(cut_row), static_cast<const float*>(carry),
          static_cast<float*>(out), d, n_bounds);
    });
  }
  return (int)cudaGetLastError();
}
