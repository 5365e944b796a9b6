// CSR SpMM: out = S . dense for a CSR pattern S with per-entry values.
//
// Replaces sddmm_tpu/ops/spmm.py::csr_spmm_jax (an XLA take of the dense
// rows, a scale by the values and a segment_sum into rows there), the
// aggregation step of the attention models:
//   out[r, k] = sum_{e in [row_ptr[r], row_ptr[r+1])} values[e] * dense[cols[e], k]
// row_ptr (m+1,) int64, cols (nnz,) int32 and values (nnz,) fp32 are the
// CSR; dense (N, K) fp32 with row stride ldd; out (m, K) fp32 contiguous.
// Each product is rounded to fp32 and added in fp32 (no fused multiply-add),
// as the plain version's multiply and index_add_ do.
//
// Design.  One warp per (row, 128-column slice): lane j holds columns
// j, j+32, j+64 and j+96 of the slice in registers, walks the row's entries
// in CSR order, reads each dense row's slice in place (coalesced, 128 bytes
// per load instruction) and accumulates.  A row's sum is owned by one warp,
// so there are no atomics and the result is deterministic; an empty row
// writes zeros.  8 warps per block; grid (ceil(m/8), ceil(K/128)).
//
// What bounds it.  Each entry reads a K-wide dense row (4K bytes) for 2K
// flops: it is bound by device memory or L2 bandwidth and by the latency of
// the scattered row reads, never by arithmetic.  Rows of very unequal
// length leave warps idle (one warp per row); balancing them, and fusing
// the softmax that produces the values, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPerLane = 4;
constexpr int kSlice = 32 * kPerLane;  // columns per warp

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const long long* __restrict__ row_ptr,
                const int* __restrict__ cols,
                const float* __restrict__ values,
                const float* __restrict__ dense, long long ldd,
                float* __restrict__ out, long long m, int K) {
  const long long r =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= m) return;
  const int k0 = blockIdx.y * kSlice + lane;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  const long long end = row_ptr[r + 1];
  for (long long e = row_ptr[r]; e < end; ++e) {
    const float v = values[e];
    const float* d = dense + (long long)cols[e] * ldd;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int k = k0 + 32 * i;
      if (k < K) acc[i] = __fadd_rn(acc[i], __fmul_rn(v, d[k]));
    }
  }
  float* o = out + r * (long long)K;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int k = k0 + 32 * i;
    if (k < K) o[k] = acc[i];
  }
}

}  // namespace

// C interface (ctypes).  The wrapper (ops/spmm.py::csr_spmm_torch) has
// checked shapes, dtypes and contiguity; the caller guarantees that row_ptr
// is non-decreasing and that the column ids are in range.  Returns the
// launch's cudaGetLastError() code.
extern "C" int sddmm_csr_spmm_float32(const long long* row_ptr,
                                      const int* cols, const float* values,
                                      const float* dense, long long ldd,
                                      float* out, long long m, int K,
                                      void* stream) {
  if (m <= 0 || K <= 0) return 0;
  const long long blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long slices = (K + kSlice - 1) / kSlice;
  if (blocks > 2147483647LL || slices > 65535) return (int)cudaErrorInvalidValue;
  csr_spmm_kernel<<<dim3((unsigned)blocks, (unsigned)slices),
                    kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      row_ptr, cols, values, dense, ldd, out, m, K);
  return (int)cudaGetLastError();
}
