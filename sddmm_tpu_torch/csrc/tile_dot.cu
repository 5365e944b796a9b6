// Batched tile dot at tf32 class on Hopper tensor cores (bf16x3).
//
// Replaces sddmm_tpu/ops/pallas_tiles.py::_tile_dot_kernel (with its
// wrappers tile_dot_tf32 / tile_dot_padded): for every tile t,
//   out[t] = a[t] . b[t]^T,  a (nT, R, K), b (nT, L, K), out (nT, R, L),
// all float32, computed as ah.bh^T + ah.bl^T + al.bh^T where x = xh + xl is
// the bf16 hi/lo split (round to nearest even, as astype(bfloat16) in JAX
// and .to(torch.bfloat16) in PyTorch) and every product accumulates in fp32.
//
// Design.  One block of 4 warps computes a 64x64 (at most) output window of
// one tile: grid = (nT, ceil(L/64), ceil(R/64)), so blocks run in any order
// and no padding of nT is needed.  K is staged through shared memory in
// 32-wide slices; while staging, each fp32 element is split into its bf16
// hi and lo halves, so global memory is read once per block and in fp32.
// Each warp owns up to four 16x16 fp32 accumulator fragments and issues
// three wmma m16n16k16 bf16 mma_syncs per 16-deep k step.  Shared memory is
// 4 x 64 x 40 bf16 = 20 KB (static, under 48 KB at any K).
//
// What bounds it.  At the hybrid path's shapes (R 16..128, L = b*128,
// K = 128) a tile dot does 2*R*L*K*3 tensor-core flops for
// 4*(R*K + L*K + R*L) bytes, i.e. under 100 flops per byte: the kernel is
// bound by device memory, not by the tensor cores, and its time is the
// bytes it moves (each B row is read ceil(R/64) times, each A row
// ceil(L/64) times).  Fusing the A and B gathers into the load (so the
// gathered copies are never written) and TMA/wgmma pipelining are later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 64;     // output rows/cols per block
constexpr int kSlice = 32;    // K elements staged per pass
constexpr int kLd = kSlice + 8;  // smem row stride (bf16), multiple of 8
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void split_store(float x, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
  __nv_bfloat16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

// Stage rows [row0, row0+nrows) x cols [k0, k0+kSlice) of a row-major
// (rows, K) fp32 matrix into hi/lo smem tiles; rows past nrows and columns
// past K are zero.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int nrows, int K, int k0,
                                      __nv_bfloat16 (*hi)[kLd],
                                      __nv_bfloat16 (*lo)[kLd]) {
  constexpr int kVec = kSlice / 4;  // float4 per staged row
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    int r = i / kVec;
    int c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && k0 + c < K) {
      v = *reinterpret_cast<const float4*>(src + (size_t)r * K + k0 + c);
    }
    split_store(v.x, &hi[r][c + 0], &lo[r][c + 0]);
    split_store(v.y, &hi[r][c + 1], &lo[r][c + 1]);
    split_store(v.z, &hi[r][c + 2], &lo[r][c + 2]);
    split_store(v.w, &hi[r][c + 3], &lo[r][c + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
tile_dot_bf16x3_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       float* __restrict__ out, int R, int L, int K) {
  __shared__ __align__(128) __nv_bfloat16 a_hi[kTile][kLd];
  __shared__ __align__(128) __nv_bfloat16 a_lo[kTile][kLd];
  __shared__ __align__(128) __nv_bfloat16 b_hi[kTile][kLd];
  __shared__ __align__(128) __nv_bfloat16 b_lo[kTile][kLd];

  const size_t t = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int r0 = blockIdx.z * kTile;
  const int nrows = min(kTile, R - r0);   // multiple of 16
  const int ncols = min(kTile, L - c0);   // multiple of 16
  const int nfr = nrows / 16, nfc = ncols / 16;
  const int nfrag = nfr * nfc;
  const int warp = threadIdx.x / 32;

  const float* a_t = a + (t * R + r0) * (size_t)K;
  const float* b_t = b + (t * L + c0) * (size_t)K;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kSlice) {
    __syncthreads();  // previous slice fully consumed
    stage(a_t, nrows, K, k0, a_hi, a_lo);
    stage(b_t, ncols, K, k0, b_hi, b_lo);
    __syncthreads();
    const int ksteps = min(kSlice, K - k0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = warp + i * kWarps;
        if (f < nfrag) {
          const int fr = f / nfc, fc = f % nfc;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> ah, al;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bh, bl;
          // b tiles are (L, K) row-major = matrix_b (K x L) col-major
          wmma::load_matrix_sync(ah, &a_hi[fr * 16][ks * 16], kLd);
          wmma::load_matrix_sync(al, &a_lo[fr * 16][ks * 16], kLd);
          wmma::load_matrix_sync(bh, &b_hi[fc * 16][ks * 16], kLd);
          wmma::load_matrix_sync(bl, &b_lo[fc * 16][ks * 16], kLd);
          wmma::mma_sync(acc[i], ah, bh, acc[i]);
          wmma::mma_sync(acc[i], ah, bl, acc[i]);
          wmma::mma_sync(acc[i], al, bh, acc[i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = warp + i * kWarps;
    if (f < nfrag) {
      const int fr = f / nfc, fc = f % nfc;
      float* dst = out + (t * R + r0 + fr * 16) * (size_t)L + c0 + fc * 16;
      wmma::store_matrix_sync(dst, acc[i], L, wmma::mem_row_major);
    }
  }
}

}  // namespace

// C interface (ctypes).  The wrapper has checked shapes (R, L, K multiples
// of 16), dtypes, contiguity and 32-byte alignment.  Returns the launch's
// cudaGetLastError() code; 0 is success.
extern "C" int sddmm_tile_dot_bf16x3(const float* a, const float* b,
                                     float* out, long long nT, int R, int L,
                                     int K, void* stream) {
  if (nT <= 0) return 0;
  dim3 grid((unsigned)nT, (L + kTile - 1) / kTile, (R + kTile - 1) / kTile);
  tile_dot_bf16x3_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, b, out, R,
                                                                L, K);
  return (int)cudaGetLastError();
}
