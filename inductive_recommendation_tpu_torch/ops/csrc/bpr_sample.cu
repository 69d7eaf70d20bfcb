// The BPR batch draw for Hopper (sm_90a): the users, positives and negatives of
// a training batch from the three uniform draws the generator made for it.
//
//   users[b] = valid_users[ud[b]]
//   pos[b]   = items_flat[offsets[u] + pd[b] % deg[u]]                   u = users[b]
//   neg[i]   = min(r + j, n_items - 1), r = rd[i] % max(n_items - deg[u], 1),
//              j the first in [0, deg[u]] with items_flat[offsets[u] + j] - j > r
//                                                                         b = i / neg_ratio
//
// with the rules of data/sampling.py::sample_bpr_batch_reference: each user's
// train items sorted, no duplicates, so items_flat[off + j] - j (the non-positive
// ids below the j-th positive) never decreases along the slice and j is unique;
// r + j is then the r-th non-positive id. A user who holds the whole catalog has
// no negative: its r is 0, j its degree, and the id is clamped to n_items - 1.
// Everything is int64, as the state and torch.randint hold it, so the batch is
// bitwise the plain version's from the same draws.
//
// Replaces: no TPU kernel. The JAX package draws the batch with XLA ops
// (inductive_recommendation_tpu/data/sampling.py::sample_bpr_batch, a
// fori_loop binary search). The port first ran them as plain PyTorch ops: the
// gathers, the modulos and ceil(log2(max degree)) + 1 rounds of about 12 small
// ops for the search, about 170 launches a draw, each paid for in host time.
// This one launch takes their place after the generator's three draws.
//
// What bounds it: launch latency. A batch of 2,048 pairs reads 48 KB of draws
// and about 12 dependent 8-byte loads a negative from the state, and writes
// 48 KB: under 0.1 us at 3.35 TB/s.
//
// Design: one thread a negative (b = i / neg_ratio); the first thread of each
// user's negatives also writes its user and positive. The search is bounded by
// the user's own degree, not the largest one. Nothing is shared between
// threads, so two launches on the same draws write the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bpr_sample_kernel(const long long* __restrict__ valid_users, const long long* __restrict__ items,
                  const long long* __restrict__ offsets, const long long* __restrict__ deg, long long n_items,
                  const long long* __restrict__ ud, const long long* __restrict__ pd,
                  const long long* __restrict__ rd, long long* __restrict__ users_out,
                  long long* __restrict__ pos_out, long long* __restrict__ neg_out, int batch, int neg_ratio) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)batch * neg_ratio) return;
  const long long b = i / neg_ratio;
  const long long user = __ldg(valid_users + __ldg(ud + b));
  const long long off = __ldg(offsets + user);
  const long long d = __ldg(deg + user);
  if (i == b * neg_ratio) {
    users_out[b] = user;
    pos_out[b] = __ldg(items + off + __ldg(pd + b) % d);
  }
  const long long r = __ldg(rd + i) % max(n_items - d, 1LL);
  long long lo = 0, hi = d;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(items + off + mid) - mid <= r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  neg_out[i] = min(r + lo, n_items - 1);
}

}  // namespace

// valid_users [n_valid], items_flat [E], offsets [n_users + 1], deg [n_users]:
// the sampler's state, int64; ud [batch], pd [batch], rd [batch * neg_ratio]:
// the draws, int64; out [batch * (2 + neg_ratio)] int64: users, positives,
// then the negatives row by row. batch >= 0, neg_ratio >= 1.
extern "C" int bpr_sample(const void* valid_users, const void* items_flat, const void* offsets, const void* deg,
                          long long n_items, const void* ud, const void* pd, const void* rd, void* out, int batch,
                          int neg_ratio, void* stream) {
  if (batch < 0 || neg_ratio < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)batch * neg_ratio;
  if (n == 0) return (int)cudaSuccess;
  auto* users_out = static_cast<long long*>(out);
  bpr_sample_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(valid_users), static_cast<const long long*>(items_flat),
      static_cast<const long long*>(offsets), static_cast<const long long*>(deg), n_items,
      static_cast<const long long*>(ud), static_cast<const long long*>(pd), static_cast<const long long*>(rd),
      users_out, users_out + batch, users_out + 2LL * batch, batch, neg_ratio);
  return (int)cudaGetLastError();
}
