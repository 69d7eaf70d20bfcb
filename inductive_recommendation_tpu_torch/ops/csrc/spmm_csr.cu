// CSR sparse x dense product for Hopper (sm_90a): out[r] = sum_e val[e] * x[col[e]]
// over the edges e in [row_ptr[r], row_ptr[r+1]).
//
// Replaces: inductive_recommendation_tpu/ops/pallas_spmm.py::_kernel (driven by
// spmm_ell_pallas), the TPU's ELL gather-reduce SpMM. That kernel fetched each
// neighbour row with its own DMA inside a 128-row tile; here each output row is
// one warp, and the neighbour rows are gathered by ordinary coalesced loads.
//
// What bounds it: bytes. The work is 2 * nnz * d flops against at least
// 8 B/edge of CSR (col + val), x read once and out written once, so the byte
// floor is far above the flop floor. The gathered traffic is nnz * d * 4 B
// (459 MB at the Gowalla-scale adjacency, d = 64), which must come mostly from
// the 50 MB L2 since x (18 MB there) fits in it.
//
// Design (right and simple first):
//   * one warp per output row; lanes cover the row's d columns in steps of 32
//     (NC register accumulators a lane, NC = ceil(d_tile / 32)), so any d
//     works: columns beyond NC * 32 go to further blocks along grid.y;
//   * the warp loads col/val for 32 edges cooperatively (one coalesced load
//     each) and broadcasts them with __shfl_sync, then every lane reads its
//     columns of x[col] (coalesced across the warp);
//   * accumulation in fp32 registers, each output row written once, a row with
//     no edges writes zeros, no atomics: the result is deterministic.
// Power-law skew is not handled: one warp walks the longest row alone.
//
// Contract (checked by the Python wrapper before the call): every pointer is
// on the current device, row_ptr/col are int32, val/x/out are fp32 and
// contiguous, x has d columns, row_ptr[n_rows] < 2^31. The launch goes on the
// given stream, allocates nothing and does not synchronise. The return value
// is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const float* __restrict__ x,
                float* __restrict__ out, int n_rows, int d) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * (NC * 32) + lane;

  float acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = 0.f;

  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int base = start; base < end; base += 32) {
    const int e = base + lane;
    int my_col = 0;
    float my_val = 0.f;
    if (e < end) {
      my_col = col[e];
      my_val = val[e];
    }
    const int n = min(32, end - base);  // the same on every lane
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int c = __shfl_sync(0xffffffffu, my_col, j);
      const float v = __shfl_sync(0xffffffffu, my_val, j);
      const float* xr = x + (size_t)c * d;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int cc = c0 + k * 32;
        if (cc < d) acc[k] = fmaf(v, __ldg(xr + cc), acc[k]);
      }
    }
  }
  float* o = out + (size_t)row * d;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int cc = c0 + k * 32;
    if (cc < d) o[cc] = acc[k];
  }
}

template <int NC>
void launch(const int* row_ptr, const int* col, const float* val,
            const float* x, float* out, int n_rows, int d,
            cudaStream_t stream) {
  dim3 grid((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)((d + NC * 32 - 1) / (NC * 32)));
  spmm_csr_kernel<NC><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      row_ptr, col, val, x, out, n_rows, d);
}

}  // namespace

extern "C" int spmm_csr_forward(const void* row_ptr, const void* col,
                                const void* val, const void* x, void* out,
                                int n_rows, int d, void* stream) {
  const int* rp = static_cast<const int*>(row_ptr);
  const int* c = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0 && d > 0) {
    // registers per lane follow d: one accumulator per 32 columns, at most 4
    // (d > 128 takes further column tiles along grid.y)
    if (d <= 32) {
      launch<1>(rp, c, v, xs, o, n_rows, d, s);
    } else if (d <= 64) {
      launch<2>(rp, c, v, xs, o, n_rows, d, s);
    } else if (d <= 96) {
      launch<3>(rp, c, v, xs, o, n_rows, d, s);
    } else {
      launch<4>(rp, c, v, xs, o, n_rows, d, s);
    }
  }
  return (int)cudaGetLastError();
}
