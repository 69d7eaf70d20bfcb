// The evaluation's masked top-k for Hopper (sm_90a): each row of a score
// block [rows, n_items] fp32, with the row's excluded ids and the banned
// columns set to -inf, reduced to its k largest scores and their ids, sorted
// by descending score, ties by the lower id first (the order of JAX's
// lax.top_k on the masked row).
//
//   out_val[r, j], out_id[r, j] = the j-th of row r's items ranked by
//   (score desc, id asc), where an id in exclude[r, :] (padded with any id
//   outside [0, n_items), the sentinel n_items) or with banned[id] scores -inf
//
// The selection is exact on the fp32 scores: each score becomes a uint32 key
// with the same order (-0 and +0 alike, -inf below every finite score), every
// key that can be among the first k is a candidate, and the candidates are
// ordered by (key desc, id asc). A row with fewer than k eligible items ends
// in its -inf entries, lowest ids first.
//
// Replaces: no TPU kernel. The JAX package masks with a scatter and selects
// with lax.top_k (inductive_recommendation_tpu/ops/topk.py::masked_topk). The
// port ran mask_scores (a sentinel column catted onto the 84 MB block, a
// scatter, a strided slice copied again) and torch.topk, whose multi-block
// radix select reads the block once a digit pass in about six launches.
// This kernel reads each row's scores from device memory once, in one
// launch where a row fits a block.
//
// What bounds it: device memory. The eval's batch (512 rows x 40,981 items)
// is 84 MB, 25 us at 3.35 TB/s. A row's 164 KB fill most of an SM's shared
// memory, so one block a row runs on each SM at a time and its work on chip
// does not overlap its loads: about 70 us a batch on an H100, where the
// plain path took 558 us (PERF.md, section 6).
//
// Design: one block of kThreads owns a row, or a chunk of a row.
// 1. The row's exclusion ids set bits of a bitmap in shared memory (atomicOr,
//    so duplicates and ids of other chunks or outside the row cost nothing).
// 2. Thread t loads the scores at positions t + j kThreads (each warp's load
//    128 contiguous bytes, kLoads in flight a thread); each becomes its key
//    (the -inf key where its bit or its banned flag is set), stored to shared
//    memory, and the thread keeps the largest.
// 3. tau = the k-th largest of the threads' maxima: at least k keys are
//    >= tau, since k threads each hold one. A histogram of the maxima's top
//    12 bits finds tau's bin, and a rank among the maxima in that bin finds
//    tau (where more than kRankCap share the bin, its lower edge, no larger).
//    The largest keys of a row seldom share a thread, even where they lie
//    at adjacent ids, so little more than k keys are >= tau.
// 4. The threads whose largest key is >= tau, and no other, go over their
//    keys again and append those >= tau to a buffer of kCandCap entries (a
//    shared counter), each entry the key above the position inverted, so that
//    one 64-bit compare orders two by (key desc, position asc).
// 5. If they do not fit (many keys tie at tau, say a row of equal scores),
//    the exact k-th largest key T is found by bisection over the key range
//    (each step a count of keys >= mid), and the keys above T plus the first
//    k - #(> T) keys equal to T in position order (contiguous segments a
//    thread, two block scans) make exactly k candidates.
// 6. Up to kRankCap candidates, each one's rank among them is its output
//    slot; more are sorted (bitonic) and the first k written.
// A chunk that the buffer holds whole skips 3: every key is a candidate.
// A row longer than a block's capacity is cut into n_chunks balanced chunks,
// each at least kMaxK long: a first launch writes each chunk's top k
// (ids global) and a second launch takes the top k of those n_chunks * k
// candidates, the same kernel reading explicit ids. Ties keep the lower id
// first across chunks, since the order (key desc, id asc) is total.
//
// No atomics on the outputs and no order from the candidate buffer's fill
// reaches them: a second launch on the same input is bitwise the first.

#include <cuda_runtime.h>

// a host emulation of this source may build smaller blocks
#ifndef MASKED_TOPK_THREADS
#define MASKED_TOPK_THREADS 1024
#endif
#ifndef MASKED_TOPK_ITEMS
#define MASKED_TOPK_ITEMS 49152
#endif

namespace {

typedef unsigned long long u64;

constexpr int kThreads = MASKED_TOPK_THREADS;  // a block's threads
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;            // MAX_K in ops/topk.py
constexpr int kMaxItems = MASKED_TOPK_ITEMS;  // BLOCK_ITEMS in ops/topk.py: the items a block holds
constexpr int kCandCap = 2048;        // the candidate buffer's entries
constexpr int kRankCap = 512;         // entries ranked one against another (more are sorted)
constexpr int kLoads = 16;            // a thread's loads in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfKey = 0x007fffffu;  // key_of(-inf)
static_assert(kMaxK <= kThreads && kThreads <= kCandCap, "the k candidates and the maxima fit the buffer");
static_assert(kMaxItems >= 2 * kMaxK, "a cut row's chunks hold k items each");

// an order-preserving map of fp32 to uint32: positives above negatives, -0 as +0
__device__ __forceinline__ unsigned key_of(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// an entry: its key above its position inverted, so that the larger entry
// ranks first by (key desc, position asc); 0 is below every entry
__device__ __forceinline__ u64 entry_of(unsigned key, int pos) { return ((u64)key << 32) | (kFull - (unsigned)pos); }
__device__ __forceinline__ unsigned key_at_entry(u64 e) { return (unsigned)(e >> 32); }
__device__ __forceinline__ int pos_at_entry(u64 e) { return (int)(kFull - (unsigned)e); }

// the shared words a block uses for a chunk of L items: the candidate
// buffer (kCandCap entries), the exclusion bitmap and the keys
__host__ __device__ constexpr int bitmap_words(int L) { return (L + 31) >> 5; }
__host__ __device__ constexpr int smem_words(int L) { return 2 * kCandCap + bitmap_words(L) + L; }
constexpr int kSmemCap = 4 * smem_words(kMaxItems);  // 219,136 bytes of the 232,448 a block may have
constexpr int kMaxDevices = 64;
static_assert(kSmemCap <= 232448, "a block of kMaxItems fits the card's shared memory");

// exclusive prefix sum over the block; *total gets the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  const int base = warp > 0 ? scratch[warp - 1] : 0;
  *total = scratch[kWarps - 1];
  __syncthreads();  // scratch is free again
  return base + x - v;
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  int total;
  block_exclusive_scan(v, &total, scratch);
  return total;
}

// how many of e[0, n) are larger than x (entries are distinct: its rank)
__device__ __forceinline__ int rank_of(u64 x, const u64* e, int n) {
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) r += e[j] > x;
  return r;
}

// bitonic sort of e[0, n) (n a power of two) into descending order
__device__ void sort_desc(u64* e, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const u64 a = e[i], b = e[j];
        if ((b > a) == ((i & size) == 0)) {
          e[i] = b;
          e[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// tau for the block: the k-th largest of the threads' largest keys tmax
// (k threads hold a key >= it). A histogram of their top 12 bits over buf
// (kCandCap entries, 4096 bins) finds its bin, then a rank among the maxima
// in that bin; where more than kRankCap share the bin, the bin's lower edge,
// which is no larger.
__device__ unsigned threshold(unsigned tmax, int k, u64* buf, int* scratch) {
  __shared__ int n_bin, need_s;
  __shared__ unsigned bin_s, tau_s;
  const int tid = threadIdx.x;
  unsigned* hist = reinterpret_cast<unsigned*>(buf);
  for (int b = tid; b < 2 * kCandCap; b += kThreads) hist[b] = 0u;
  if (tid == 0) n_bin = 0;
  __syncthreads();
  atomicAdd(&hist[tmax >> 20], 1u);
  __syncthreads();
  constexpr int kPer = 2 * kCandCap / kThreads;  // bins a thread sums
  int mine = 0;
#pragma unroll
  for (int b = 0; b < kPer; ++b) mine += hist[tid * kPer + b];
  int total;
  int above = block_exclusive_scan(mine, &total, scratch);
  above = total - above - mine;  // maxima in the bins above this thread's
  if (above < k && above + mine >= k) {
    for (int b = kPer - 1; b >= 0; --b) {
      const int h = hist[tid * kPer + b];
      if (above + h >= k) {
        bin_s = (unsigned)(tid * kPer + b);
        need_s = k - above;
        break;
      }
      above += h;
    }
  }
  __syncthreads();
  if ((tmax >> 20) == bin_s) buf[atomicAdd(&n_bin, 1)] = entry_of(tmax, tid);
  __syncthreads();
  const int nb = n_bin, need = need_s;
  if (nb <= kRankCap) {
    for (int i = tid; i < nb; i += kThreads) {
      if (rank_of(buf[i], buf, nb) == need - 1) tau_s = key_at_entry(buf[i]);
    }
  } else if (tid == 0) {
    tau_s = bin_s << 20;
  }
  __syncthreads();
  return tau_s;
}

// kCand false: vals is the score block [rows, row_len] (row_len = n_items),
// ids implicit, exclusions and bans applied. kCand true: vals and ids are
// the first launch's candidates [rows, row_len] (row_len = n_chunks * k).
// Block (row, chunk) writes its top k to out_*[(row * gridDim.y + chunk) * k].
template <bool kCand>
__global__ void __launch_bounds__(kThreads, 1)
masked_topk_kernel(const float* __restrict__ vals, const long long* __restrict__ ids, const int* __restrict__ excl,
                   const bool* __restrict__ banned, float* __restrict__ out_val, long long* __restrict__ out_id,
                   int row_len, int m, int k) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ int scratch[32];
  __shared__ int n_cand;
  const int tid = threadIdx.x;
  const int row = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int start = (int)((long long)chunk * row_len / n_chunks);
  const int L = (int)((long long)(chunk + 1) * row_len / n_chunks) - start;
  const float* src = vals + (long long)row * row_len + start;
  u64* cand = reinterpret_cast<u64*>(smem);
  unsigned* bitmap = smem + 2 * kCandCap;
  unsigned* keys = bitmap + bitmap_words(L);  // keys[p], p in [0, L)

  // 1. the exclusions' bitmap
  if (tid == 0) n_cand = 0;
  if (!kCand) {
    for (int w = tid; w < bitmap_words(L); w += kThreads) bitmap[w] = 0u;
    __syncthreads();
    if (excl != nullptr) {
      const int* e = excl + (long long)row * m;
      for (int j = tid; j < m; j += kThreads) {
        const long long p = (long long)e[j] - start;
        if (p >= 0 && p < L) atomicOr(&bitmap[p >> 5], 1u << (p & 31));
      }
    }
  }
  __syncthreads();

  // 2. keys into shared memory; thread t loads positions t + j kThreads and
  // keeps the largest key among them (so that a run of adjacent high scores,
  // as popular items with adjacent ids give, spreads over many threads). Its
  // kLoads loads are issued before any of their keys is stored.
  unsigned tmax = 0u;
  for (int p0 = tid; p0 < L; p0 += kLoads * kThreads) {
    float v[kLoads];
    bool ban[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = p0 + u * kThreads;
      v[u] = p < L ? src[p] : 0.f;
      ban[u] = !kCand && banned != nullptr && p < L && banned[start + p];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = p0 + u * kThreads;
      if (p < L) {
        const bool out = ban[u] || (!kCand && ((bitmap[p >> 5] >> (p & 31)) & 1u));
        const unsigned x = out ? kNegInfKey : key_of(v[u]);
        keys[p] = x;
        tmax = max(tmax, x);
      }
    }
  }

  // 3. tau: at most the k-th largest key, from the threads' maxima; a chunk
  // that the candidate buffer holds whole takes every key
  const unsigned tau = L > kCandCap ? threshold(tmax, k, cand, scratch) : 0u;

  // 4. the keys >= tau: only a thread whose largest key is >= tau holds any
  auto offer = [&](int p, unsigned x) {
    if (x >= tau) {
      const int slot = atomicAdd(&n_cand, 1);
      if (slot < kCandCap) cand[slot] = entry_of(x, p);
    }
  };
  if (tmax >= tau) {
    for (int p = tid; p < L; p += kThreads) offer(p, keys[p]);
  }
  __syncthreads();
  int c = n_cand;

  // 5. (rare) too many: exactly k candidates from the k-th largest key T
  if (c > kCandCap) {
    unsigned lo = tau, hi = 0xffffffffu;  // count(keys >= lo) >= k
    while (lo < hi) {
      const unsigned mid = lo + (unsigned)(((u64)hi - lo + 1ull) >> 1);
      int n = 0;
      for (int p = tid; p < L; p += kThreads) n += keys[p] >= mid;
      if (block_sum(n, scratch) >= k) {
        lo = mid;
      } else {
        hi = mid - 1u;
      }
    }
    const unsigned T = lo;
    const int seg = (L + kThreads - 1) / kThreads;
    const int p0 = min(L, tid * seg), p1 = min(L, p0 + seg);
    int gt = 0, eq = 0;
    for (int p = p0; p < p1; ++p) {
      gt += keys[p] > T;
      eq += keys[p] == T;
    }
    int n_gt, n_eq;
    int gt_at = block_exclusive_scan(gt, &n_gt, scratch);
    int eq_at = block_exclusive_scan(eq, &n_eq, scratch);
    const int need = k - n_gt;
    for (int p = p0; p < p1; ++p) {
      const unsigned x = keys[p];
      if (x > T) {
        cand[gt_at++] = entry_of(x, p);
      } else if (x == T) {
        if (eq_at < need) cand[n_gt + eq_at] = entry_of(x, p);
        ++eq_at;
      }
    }
    c = k;
    __syncthreads();
  }

  // 6. the first k by (key desc, position asc): each candidate's rank among
  // all of them where they are few, a bitonic sort where they are many
  const long long o = ((long long)row * n_chunks + chunk) * k;
  auto emit = [&](int r, u64 e) {
    const int p = pos_at_entry(e);
    out_val[o + r] = value_of(key_at_entry(e));
    out_id[o + r] = kCand ? ids[(long long)row * row_len + start + p] : (long long)(start + p);
  };
  if (c <= kRankCap) {
    for (int i = tid; i < c; i += kThreads) {
      const u64 e = cand[i];
      const int r = rank_of(e, cand, c);
      if (r < k) emit(r, e);
    }
  } else {
    const int n = pow2_at_least(c);
    for (int i = c + tid; i < n; i += kThreads) cand[i] = 0ull;
    __syncthreads();
    sort_desc(cand, n);
    for (int j = tid; j < k; j += kThreads) emit(j, cand[j]);
  }
}

template <bool kCand>
int launch(const float* vals, const long long* ids, const int* excl, const bool* banned, float* out_val,
           long long* out_id, int rows, int row_len, int n_chunks, int m, int k, cudaStream_t s) {
  const int longest = (int)(((long long)row_len + n_chunks - 1) / n_chunks);
  const int bytes = 4 * smem_words(longest);
  // over 48 KB of dynamic shared memory needs the kernel's attribute raised,
  // once a device: a host call at the first such launch, not at every one
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  if (bytes > 48 * 1024 && (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices || !raised[dev])) {
    const cudaError_t err =
        cudaFuncSetAttribute(masked_topk_kernel<kCand>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  masked_topk_kernel<kCand><<<dim3((unsigned)rows, (unsigned)n_chunks), kThreads, (size_t)bytes, s>>>(
      vals, ids, excl, banned, out_val, out_id, row_len, m, k);
  return (int)cudaGetLastError();
}

}  // namespace

// scores [rows, n_items] fp32; exclude [rows, m] int32 or null; banned
// [n_items] bool or null; out_val [rows, k] fp32, out_id [rows, k] int64.
// A row over kMaxItems is cut into n_chunks = ceil(n_items / kMaxItems)
// chunks, whose top k go to cand_val / cand_id [rows, n_chunks, k] before a
// second launch merges them; then n_chunks * k <= kMaxItems.
// 1 <= k <= min(kMaxK, n_items).
extern "C" int masked_topk(const void* scores, const void* exclude, const void* banned, void* cand_val,
                           void* cand_id, void* out_val, void* out_id, int rows, int n_items, int m, int k,
                           void* stream) {
  if (k < 1 || k > kMaxK || k > n_items || m < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (int)(((long long)n_items + kMaxItems - 1) / kMaxItems);
  if (n_chunks > 1 && ((long long)n_chunks * k > kMaxItems || cand_val == nullptr || cand_id == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* excl = static_cast<const int*>(exclude);
  const auto* ban = static_cast<const bool*>(banned);
  if (n_chunks == 1)
    return launch<false>(static_cast<const float*>(scores), nullptr, excl, ban, static_cast<float*>(out_val),
                         static_cast<long long*>(out_id), rows, n_items, 1, m, k, s);
  const int err = launch<false>(static_cast<const float*>(scores), nullptr, excl, ban, static_cast<float*>(cand_val),
                                static_cast<long long*>(cand_id), rows, n_items, n_chunks, m, k, s);
  if (err != 0) return err;
  return launch<true>(static_cast<const float*>(cand_val), static_cast<const long long*>(cand_id), nullptr, nullptr,
                      static_cast<float*>(out_val), static_cast<long long*>(out_id), rows, n_chunks * k, 1, 0, k, s);
}
