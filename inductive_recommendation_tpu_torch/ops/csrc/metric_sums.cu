// The evaluation's ranking-metric sums for Hopper (sm_90a): a batch of users'
// ranked ids against their ground truth, reduced to Precision, Recall and NDCG
// summed over the batch at every cutoff.
//
//   rows:  vals[o][u] = user u's masked value o: Precision, Recall, NDCG at each
//          cutoff (o = 3 t + metric), then o = 3 n the valid flag
//   sums:  out[o] = sum_u vals[o][u]
//
// with the rules of eval/device_metrics.py::batch_metric_sums_reference (and
// eval/metrics.py): hits[u, j] = rec[u, j] in gt[u]; at cutoff k, with
// kk = min(k, K), Precision = hits_1..kk / k, Recall = hits_1..kk / max(|gt|, 1),
// NDCG = DCG@kk / IDCG(clamp(min(|gt|, k), 1, K)); each masked to 0 where
// |gt| = 0 or the user is padding. The discount 1 / log2(j + 2) and the ideal
// cumulative are computed in double and rounded to float, the float values
// the plain version takes from numpy; the DCG is summed in double (exact: the
// float discounts share a scale of 2^-28 for any K under 2^24) and rounded, as
// PyTorch's CPU cumsum does.
//
// Replaces: no TPU kernel. The JAX package computes these sums with XLA ops
// (inductive_recommendation_tpu/eval/device_metrics.py::batch_metric_sums).
// The port first ran them as plain PyTorch ops: a membership test, two
// cumsums, about 19 small ops for each of the 21 cutoffs, then stacks and a
// sum, about 422 launches a batch, and two tables copied from pageable host
// memory each batch, which made the host wait for the batch's score product
// and top-k. These two launches take their place; they copy nothing from the
// host and never synchronise.
//
// What bounds it: launch latency. At the evaluation's shape (B 512 users,
// K 100 ranked ids, ground-truth rows of 512, 21 cutoffs) it reads 0.4 MB of
// ids and at most 1 MB of ground truth and writes 128 KB of per-user values:
// under 1 us at 3.35 TB/s. The work of a user is a few thousand instructions.
//
// Design.
// - metric_rows_kernel: one warp a user. The lanes take the ranks in chunks
//   of 32, kChunks chunks at a time, and test each id's membership in the
//   user's ground-truth row by one of two routes:
//   * sorted rows (the evaluator sorts rows wider than 256): a branchless
//     binary search in global memory, the kChunks searches of a lane in
//     lockstep so that their loads are in flight together;
//   * other rows: the row staged in shared memory, kTile ids at a time, each
//     id compared with every staged one (the reads are broadcasts).
//   The running hit count is a ballot and a popcount, the DCG and the ideal
//   cumulative a warp scan each (shuffles), all three carried from chunk to
//   chunk, so any K works. Lane l keeps cutoffs l and l + 32 and picks its
//   positions' values out of each chunk by shuffles; it writes its cutoffs'
//   masked values to vals, each user its own column: nothing is shared.
// - metric_sums_kernel: one warp an output; its lanes sum the users' values
//   in double in a fixed order, then a fixed shuffle tree, and round once.
//   No atomics, so a second launch on the same input is bitwise the first.
// The cutoffs come by value in the launch's parameters (at most kMaxCutoffs).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCutoffs = 64;  // MAX_CUTOFFS in eval/device_metrics.py
constexpr int kWarps = 4;        // users (or outputs) a block takes, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 4;       // 32-rank chunks a lane tests at once
constexpr int kTile = 256;       // ground-truth ids a warp stages (compare route)

struct Cutoffs {
  int n;
  int k[kMaxCutoffs];
};

// inclusive sum over the warp's lanes
__device__ __forceinline__ double warp_scan(double x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// hit[c] = ids[c] in row[0, m), m >= 1, row sorted ascending: the lower bound
// of each id (the searches in lockstep), then an equality test
__device__ __forceinline__ void member_sorted(const int* __restrict__ row, int m, const long long (&ids)[kChunks],
                                              bool (&hit)[kChunks]) {
  int base[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) base[c] = 0;
  for (int n = m; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if ((long long)__ldg(row + base[c] + half) < ids[c]) base[c] += half;
    }
    n -= half;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int pos = base[c] + ((long long)__ldg(row + base[c]) < ids[c] ? 1 : 0);
    hit[c] = pos < m && (long long)__ldg(row + pos) == ids[c];
  }
}

// hit[c] |= ids[c] in tile[0, n)
__device__ __forceinline__ void member_tile(const int* tile, int n, const long long (&ids)[kChunks],
                                            bool (&hit)[kChunks]) {
  for (int e = 0; e < n; ++e) {
    const long long g = tile[e];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) hit[c] |= ids[c] == g;
  }
}

// one warp a user: its masked values at every cutoff into vals[o * B + u]
template <bool kSorted>
__global__ void __launch_bounds__(kThreads)
metric_rows_kernel(const long long* __restrict__ rec, const int* __restrict__ gt_rows, const int* __restrict__ gt_len,
                   const bool* __restrict__ valid, float* __restrict__ vals, int B, int K, int m, Cutoffs cut) {
  __shared__ int tiles[kWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= B) return;  // the whole warp
  const long long* r = rec + (long long)u * K;
  const int* row = gt_rows + (long long)u * m;
  int* tile = tiles[warp];
  const int len = gt_len[u];
  const bool keep = len > 0 && valid[u];
  const int n_slots = cut.n > 32 ? 2 : 1;

  // slot s: cutoff lane + 32 s; p its last rank (saturated at K), q the ideal's
  int p[2], q[2], hit_at[2] = {0, 0};
  double dcg_at[2] = {0.0, 0.0}, ideal_at[2] = {1.0, 1.0};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = lane + 32 * s;
    const int k = t < cut.n ? cut.k[t] : 1;
    p[s] = min(k, K) - 1;
    q[s] = max(0, min(min(len, k), K) - 1);
  }
  // the running values through the previous chunk
  int hits = 0;
  double dcg = 0.0, ideal = 0.0;
  const bool staged = !kSorted && m <= kTile;
  if (staged) {
    for (int e = lane; e < m; e += 32) tile[e] = row[e];
    __syncwarp();
  }

  for (int j0 = 0; j0 < K; j0 += 32 * kChunks) {
    long long ids[kChunks];
    bool hit[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = j0 + 32 * c + lane;
      ids[c] = j < K ? r[j] : -1;
      hit[c] = false;
    }
    if (m > 0) {
      if constexpr (kSorted) {
        member_sorted(row, m, ids, hit);
      } else if (staged) {
        member_tile(tile, m, ids, hit);
      } else {
        for (int t0 = 0; t0 < m; t0 += kTile) {
          const int n = min(kTile, m - t0);
          __syncwarp();
          for (int e = lane; e < n; e += 32) tile[e] = row[t0 + e];
          __syncwarp();
          member_tile(tile, n, ids, hit);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int base = j0 + 32 * c;
      if (base >= K) break;  // the whole warp
      const int j = base + lane;
      const bool in = j < K;
      const double disc = in ? 1.0 / log2((double)(j + 2)) : 0.0;
      const bool h = in && hit[c];
      const int hit_incl = hits + __popc(__ballot_sync(kFull, h) & (kFull >> (31 - lane)));
      const double dcg_incl = dcg + warp_scan(h ? (double)(float)disc : 0.0, lane);
      const double ideal_incl = ideal + warp_scan(disc, lane);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < n_slots) {
          const int hs = __shfl_sync(kFull, hit_incl, p[s] & 31);
          const double ds = __shfl_sync(kFull, dcg_incl, p[s] & 31);
          const double is = __shfl_sync(kFull, ideal_incl, q[s] & 31);
          if (p[s] >= base && p[s] < base + 32) {
            hit_at[s] = hs;
            dcg_at[s] = ds;
          }
          if (q[s] >= base && q[s] < base + 32) ideal_at[s] = is;
        }
      }
      hits = __shfl_sync(kFull, hit_incl, 31);
      dcg = __shfl_sync(kFull, dcg_incl, 31);
      ideal = __shfl_sync(kFull, ideal_incl, 31);
    }
  }

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = lane + 32 * s;
    if (t < cut.n) {
      const float hit_f = (float)hit_at[s];
      const float idcg = (float)ideal_at[s];
      const float precision = hit_f / (float)cut.k[t];
      const float recall = hit_f / fmaxf((float)len, 1.f);
      const float ndcg = idcg > 0.f ? (float)dcg_at[s] / idcg : 0.f;
      float* out = vals + (long long)(3 * t) * B + u;
      out[0] = keep ? precision : 0.f;
      out[B] = keep ? recall : 0.f;
      out[2LL * B] = keep ? ndcg : 0.f;
    }
  }
  if (lane == 0) vals[(long long)(3 * cut.n) * B + u] = keep ? 1.f : 0.f;
}

// one warp an output: out[o] = sum_u vals[o * B + u], in double, in a fixed order
__global__ void __launch_bounds__(kThreads)
metric_sums_kernel(const float* __restrict__ vals, float* __restrict__ out, int B, int n_out) {
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (o >= n_out) return;  // the whole warp
  const float* v = vals + (long long)o * B;
  double acc = 0.0;
  for (int u = lane; u < B; u += 32) acc += v[u];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kFull, acc, d);
  if (lane == 0) out[o] = (float)acc;
}

}  // namespace

// rec [B, K] int64, gt_rows [B, m] int32, gt_len [B] int32, valid [B] bool;
// vals [3 n + 1, B] fp32 scratch; out [3 n + 1] fp32: the [n, 3] sums, then the
// valid count. topks: n host ints, 1 <= n <= 64.
extern "C" int metric_sums(const void* rec, const void* gt_rows, const void* gt_len, const void* valid, void* vals,
                           void* out, int B, int K, int m, const int* topks, int n_topks, int sorted, void* stream) {
  if (n_topks < 1 || n_topks > kMaxCutoffs || K < 1) return (int)cudaErrorInvalidValue;
  Cutoffs cut;
  cut.n = n_topks;
  for (int t = 0; t < kMaxCutoffs; ++t) cut.k[t] = t < n_topks ? topks[t] : 1;
  auto s = static_cast<cudaStream_t>(stream);
  const int n_out = 3 * n_topks + 1;
  if (B > 0) {
    auto kernel = sorted != 0 ? metric_rows_kernel<true> : metric_rows_kernel<false>;
    kernel<<<(unsigned)((B + kWarps - 1) / kWarps), kThreads, 0, s>>>(
        static_cast<const long long*>(rec), static_cast<const int*>(gt_rows), static_cast<const int*>(gt_len),
        static_cast<const bool*>(valid), static_cast<float*>(vals), B, K, m, cut);
    if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  }
  metric_sums_kernel<<<(unsigned)((n_out + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<float*>(out), B, n_out);
  return (int)cudaGetLastError();
}
