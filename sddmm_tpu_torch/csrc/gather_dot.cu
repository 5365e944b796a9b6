// Residual gather-dot: one exact fp32 dot per sparse entry.
//
// Replaces the residual block of sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit
// (an XLA take + elementwise multiply + row sum there; at G = 1 the one-hot
// member select is the identity):
//   out[i] = sum_k a[rows[i], k] * bt[gids[i], k]      (fp32, not bf16 split)
// a is the padded A (M+1, K), bt the grouped B^T rows (NG+1, K) at G = 1;
// rows and gids are int32.
//
// Design.  One warp per entry: lane j reads elements j, j+32, ... of both
// rows (coalesced 128-byte segments), multiplies and adds in fp32, and the
// warp reduces with shuffles.  8 warps per block.
//
// What bounds it.  Each entry moves 2*K*4 bytes of gathered rows for 2*K
// flops: it is bound by device memory and by the latency of the scattered
// row reads, never by arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_dot_kernel(const float* __restrict__ a, const float* __restrict__ bt,
                  const int* __restrict__ rows, const int* __restrict__ gids,
                  float* __restrict__ out, long long n, int K) {
  const long long e =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= n) return;
  const float* ar = a + (size_t)rows[e] * K;
  const float* br = bt + (size_t)gids[e] * K;
  float s = 0.0f;
  for (int k = lane; k < K; k += 32) s = fmaf(ar[k], br[k], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[e] = s;
}

}  // namespace

// C interface (ctypes).  Returns the launch's cudaGetLastError() code.
extern "C" int sddmm_gather_dot(const float* a, const float* bt,
                                const int* rows, const int* gids, float* out,
                                long long n, int K, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_dot_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, bt, rows, gids,
                                                           out, n, K);
  return (int)cudaGetLastError();
}
