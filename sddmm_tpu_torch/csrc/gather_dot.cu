// Residual gather-dot: one exact fp32 dot per sparse entry, at any gather
// group size G and K-chunk count C.
//
// Replaces the residual block of sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit
// (an XLA take, a one-hot member select and an elementwise multiply + row
// sum there) and sddmm_tpu/ops/csr_sddmm.py::csr_sddmm_jax /
// _csr_sddmm_blocked (the same dot with C = G = 1):
//   out[i] = sum_c sum_k a[rows[i], c*kc + k]
//                        * bt[c, gids[i], member[i]*kc + k]
// a is the padded A (M+1, C*kc) with row stride lda, bt the grouped,
// chunked B^T (C, NG+1, G*kc) contiguous; rows, gids and member are int32
// (member null means G = 1).  a and bt are stored as fp32/fp32, fp32/bf16,
// fp16/fp16 or bf16/bf16; every product and sum is fp32 (fp16 and bf16
// convert exactly).  The
// one-hot select of the JAX program is a direct index here: it picks the
// same values and adds only zeros.
//
// Design.  One warp per entry: lane j reads elements j, j+32, ... of the
// entry's A row and of the member's kc-wide slice of its group row, in each
// chunk (coalesced segments), multiplies and adds in fp32, and the warp
// reduces with shuffles.  8 warps per block.  The member slice is read in
// place, so no (nR, G*kc) gathered copy is ever written.
//
// What bounds it.  Each entry moves K*(storage bytes of A and B) bytes of
// gathered rows for 2*K flops: it is bound by device memory and by the
// latency of the scattered row reads, never by arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class TA, class TB>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_dot_kernel(const TA* __restrict__ a, long long lda,
                  const TB* __restrict__ bt, long long b_chunk,
                  long long ldb, const int* __restrict__ rows,
                  const int* __restrict__ gids,
                  const int* __restrict__ member, float* __restrict__ out,
                  long long n, int C, int kc) {
  const long long e =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= n) return;
  const TA* ar = a + (long long)rows[e] * lda;
  const TB* br = bt + (long long)gids[e] * ldb
                 + (member ? (long long)member[e] * kc : 0LL);
  float s = 0.0f;
  for (int c = 0; c < C; ++c) {
    const TA* ac = ar + (long long)c * kc;
    const TB* bc = br + (long long)c * b_chunk;
    for (int k = lane; k < kc; k += 32)
      s = fmaf(to_float(ac[k]), to_float(bc[k]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[e] = s;
}

template <class TA, class TB>
int launch(const void* a, long long lda, const void* bt, long long b_chunk,
           long long ldb, const int* rows, const int* gids,
           const int* member, float* out, long long n, int C, int kc,
           void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gather_dot_kernel<TA, TB><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(a), lda, static_cast<const TB*>(bt), b_chunk,
      ldb, rows, gids, member, out, n, C, kc);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), one entry point per (A storage, B storage) pair of
// the compute modes (ops/tile_dot.py STORAGE: "tf32" and "float32",
// "mixed", "float16", "bfloat16").  Other pairs are cast to one of these by
// the caller.  Strides are in elements: lda is A's row stride, b_chunk the
// stride of a
// chunk of bt and ldb its row stride.  The wrapper has checked shapes and
// dtypes; the caller guarantees the index ranges (the packing, or the CSR
// pattern).  Returns the launch's cudaGetLastError() code.
#define SDDMM_GATHER_DOT(NAME, TA, TB)                                       \
  extern "C" int sddmm_gather_dot_##NAME(                                    \
      const void* a, long long lda, const void* bt, long long b_chunk,       \
      long long ldb, const int* rows, const int* gids, const int* member,    \
      float* out, long long n, int C, int kc, void* stream) {                \
    return launch<TA, TB>(a, lda, bt, b_chunk, ldb, rows, gids, member, out, \
                          n, C, kc, stream);                                 \
  }

SDDMM_GATHER_DOT(float32_float32, float, float)
SDDMM_GATHER_DOT(float32_bfloat16, float, __nv_bfloat16)
SDDMM_GATHER_DOT(float16_float16, __half, __half)
SDDMM_GATHER_DOT(bfloat16_bfloat16, __nv_bfloat16, __nv_bfloat16)
