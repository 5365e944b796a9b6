// Batched tile dot on Hopper tensor cores, one instance per compute mode.
//
// Replaces sddmm_tpu/ops/pallas_tiles.py::_tile_dot_kernel (with its
// wrappers tile_dot_tf32 / tile_dot_padded), and the XLA dots of
// sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit (dense segments at any G and
// C, hub slab, hot-row slab) and sddmm_tpu/ops/dense.py::_dense_full_jit:
// for every tile t,
//   out[t] (+)= a[t] . b[t]^T,  a (nT, R, K), b (nT, L, K), out (nT, R, L),
// accumulated in fp32.  Each mode is one instance of the same kernel; it
// differs only in the storage types and in how each value is split into
// bfloat16 planes (round to nearest even, as astype(bfloat16) in JAX and
// .to(torch.bfloat16) in PyTorch) before the bf16 products:
//
//   mode      A     B     A planes  B planes  products
//   tf32      fp32  fp32  hi lo     hi lo     hh hl lh           (XLA HIGH)
//   mixed     fp32  bf16  hi lo     b         hb lb
//   float16   fp16  fp16  hi lo     hi lo     hh hl lh           (_dot3)
//   bfloat16  bf16  bf16  a         b         ab
//   float32   fp32  fp32  hi mid lo hi mid lo hh hm mh hl mm lh  (XLA HIGHEST)
//
// Strides.  A and B rows may sit at any row stride (a multiple of 16
// bytes), so a K chunk is a column view of the full operand and the C
// chunks of one product are C launches, the later ones with `accumulate`.
// The output has its own tile and row strides and any alignment of 4
// bytes, so a slab writes straight into its place in the flat vector.
// R and L are any sizes >= 1; K is a multiple of 16.
//
// Design.  One block of 4 warps computes a 64x64 (at most) output window of
// one tile: grid = (nT, ceil(L/64), ceil(R/64)), so blocks run in any order
// and no padding of nT is needed.  K is staged through shared memory in
// 32-wide slices with 16-byte loads; while staging, each element is split
// into its bf16 planes, so global memory is read once per block in its
// storage type.  Each warp owns up to four 16x16 fp32 accumulator fragments
// and issues the mode's wmma m16n16k16 bf16 mma_syncs per 16-deep k step
// ("float32" sums each step's products apart first, see Float32).
// A whole accumulator fragment over aligned output rows is stored directly;
// any other (a ragged edge, unaligned rows, an accumulate) leaves through a
// per-warp 16x16 shared scratch, and each lane stores only the cells inside
// (R, L): ragged edges and unaligned output rows need no padding.  Shared
// memory is at most 6 planes x 64 x 40 bf16 + 4 KB scratch = 34 KB (static,
// under 48 KB at any K).
//
// What bounds it.  At the hybrid path's shapes (R 16..128, L = b*128,
// K 32..256) a tile dot does 2*R*L*K*(products) tensor-core flops for
// about (R*K + L*K)*(storage bytes) + 4*R*L bytes, well under 300 flops per
// byte in every mode: the kernel is bound by device memory, not by the
// tensor cores, and its time is the bytes it moves (each B row is read
// ceil(R/64) times, each A row ceil(L/64) times).  So the extra products of
// float32 cost little, and the 16-bit storage of the other modes halves
// the bytes of its operand.  Fusing the A and B gathers into the load and
// TMA/wgmma pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 64;     // output rows/cols per block
constexpr int kSlice = 32;    // K elements staged per pass
constexpr int kLd = kSlice + 8;  // smem row stride (bf16), multiple of 8
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

using bf16 = __nv_bfloat16;
using FragA =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
// b tiles are (L, K) row-major = matrix_b (K x L) col-major
using FragB =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// x -> NP bf16 planes whose sum carries x to about 8*NP mantissa bits.
template <int NP>
__device__ __forceinline__ void split(float x, bf16 (*planes)[kTile][kLd],
                                      int r, int c) {
  const bf16 h = __float2bfloat16_rn(x);
  planes[0][r][c] = h;
  if constexpr (NP >= 2) {
    const float r1 = x - __bfloat162float(h);
    const bf16 m = __float2bfloat16_rn(r1);
    planes[1][r][c] = m;
    if constexpr (NP >= 3) {
      planes[2][r][c] = __float2bfloat16_rn(r1 - __bfloat162float(m));
    }
  }
}

struct Tf32 {
  using TA = float;
  using TB = float;
  static constexpr int kPlanesA = 2, kPlanesB = 2;
  __device__ __forceinline__ static void mma(FragC& c, const FragA* a,
                                             const FragB* b) {
    wmma::mma_sync(c, a[0], b[0], c);
    wmma::mma_sync(c, a[0], b[1], c);
    wmma::mma_sync(c, a[1], b[0], c);
  }
};

struct Mixed {
  using TA = float;
  using TB = bf16;
  static constexpr int kPlanesA = 2, kPlanesB = 1;
  __device__ __forceinline__ static void mma(FragC& c, const FragA* a,
                                             const FragB* b) {
    wmma::mma_sync(c, a[0], b[0], c);
    wmma::mma_sync(c, a[1], b[0], c);
  }
};

struct Float16 {
  using TA = __half;
  using TB = __half;
  static constexpr int kPlanesA = 2, kPlanesB = 2;
  __device__ __forceinline__ static void mma(FragC& c, const FragA* a,
                                             const FragB* b) {
    wmma::mma_sync(c, a[0], b[0], c);
    wmma::mma_sync(c, a[0], b[1], c);
    wmma::mma_sync(c, a[1], b[0], c);
  }
};

struct Bfloat16 {
  using TA = bf16;
  using TB = bf16;
  static constexpr int kPlanesA = 1, kPlanesB = 1;
  __device__ __forceinline__ static void mma(FragC& c, const FragA* a,
                                             const FragB* b) {
    wmma::mma_sync(c, a[0], b[0], c);
  }
};

struct Float32 {
  using TA = float;
  using TB = float;
  static constexpr int kPlanesA = 3, kPlanesB = 3;
  // The six products whose plane orders sum to at most 2, smallest first,
  // go into a fresh fragment that is then added to the running sum with
  // fp32 adds (round to nearest).  Chained onto the running sum, as the
  // other modes are, every mma_sync's accumulation costs up to an ulp of
  // that growing sum: after the 96 mma_syncs of K = 256 the sum was 2.8e-6
  // (relative) off the exact product of the planes on the card, worse than
  // the three-product "tf32" split.  This way an mma_sync errs only on its
  // own 16-deep step.
  __device__ __forceinline__ static void mma(FragC& c, const FragA* a,
                                             const FragB* b) {
    FragC s;
    wmma::fill_fragment(s, 0.0f);
    wmma::mma_sync(s, a[2], b[0], s);
    wmma::mma_sync(s, a[1], b[1], s);
    wmma::mma_sync(s, a[0], b[2], s);
    wmma::mma_sync(s, a[1], b[0], s);
    wmma::mma_sync(s, a[0], b[1], s);
    wmma::mma_sync(s, a[0], b[0], s);
#pragma unroll
    for (int i = 0; i < s.num_elements; ++i) c.x[i] += s.x[i];
  }
};

// Stage rows [0, nrows) x cols [k0, k0+kSlice) of a (rows, K) matrix with
// row stride ld (elements) into NP bf16 planes; rows past nrows and columns
// past K are zero.  Only the 16-row fragments that hold a real row are
// staged.
template <class T, int NP>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld,
                                      int nrows, int K, int k0,
                                      bf16 (*planes)[kTile][kLd]) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int kVecs = kSlice / kVec;   // loads per staged row
  const int rows16 = (nrows + 15) & ~15;
  for (int i = threadIdx.x; i < rows16 * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && k0 + c < K) {
      raw = *reinterpret_cast<const uint4*>(src + r * ld + k0 + c);
    }
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      split<NP>(to_float(e[j]), planes, r, c + j);
  }
}

template <class Mode>
__global__ void __launch_bounds__(kThreads)
tile_dot_kernel(const typename Mode::TA* __restrict__ a, long long sa_t,
                long long sa_r, const typename Mode::TB* __restrict__ b,
                long long sb_t, long long sb_r, float* __restrict__ out,
                long long so_t, long long so_r, int R, int L, int K,
                int accumulate) {
  constexpr int PA = Mode::kPlanesA, PB = Mode::kPlanesB;
  __shared__ __align__(128) bf16 a_s[PA][kTile][kLd];
  __shared__ __align__(128) bf16 b_s[PB][kTile][kLd];
  __shared__ __align__(128) float scratch[kWarps][16 * 16];

  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int r0 = blockIdx.z * kTile;
  const int nrows = min(kTile, R - r0);
  const int ncols = min(kTile, L - c0);
  const int nfr = (nrows + 15) / 16, nfc = (ncols + 15) / 16;
  const int nfrag = nfr * nfc;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const typename Mode::TA* a_t = a + t * sa_t + r0 * sa_r;
  const typename Mode::TB* b_t = b + t * sb_t + c0 * sb_r;

  FragC acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kSlice) {
    __syncthreads();  // previous slice fully consumed
    stage<typename Mode::TA, PA>(a_t, sa_r, nrows, K, k0, a_s);
    stage<typename Mode::TB, PB>(b_t, sb_r, ncols, K, k0, b_s);
    __syncthreads();
    const int ksteps = min(kSlice, K - k0) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = warp + i * kWarps;
        if (f < nfrag) {
          const int fr = f / nfc, fc = f % nfc;
          FragA fa[PA];
          FragB fb[PB];
#pragma unroll
          for (int p = 0; p < PA; ++p)
            wmma::load_matrix_sync(fa[p], &a_s[p][fr * 16][ks * 16], kLd);
#pragma unroll
          for (int p = 0; p < PB; ++p)
            wmma::load_matrix_sync(fb[p], &b_s[p][fc * 16][ks * 16], kLd);
          Mode::mma(acc[i], fa, fb);
        }
      }
    }
  }

  float* out_t = out + t * so_t;
  // wmma stores a whole fragment to a 32-byte aligned row start with a row
  // stride of whole 32-byte sectors
  const bool aligned_rows =
      so_r % 8 == 0 && so_r <= 0x7fffffff &&
      reinterpret_cast<unsigned long long>(out_t) % 32 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = warp + i * kWarps;
    if (f < nfrag) {
      const int fr = f / nfc, fc = f % nfc;
      if (aligned_rows && !accumulate && (fr + 1) * 16 <= nrows &&
          (fc + 1) * 16 <= ncols) {
        wmma::store_matrix_sync(out_t + (r0 + fr * 16) * so_r + c0 + fc * 16,
                                acc[i], (unsigned)so_r, wmma::mem_row_major);
        continue;
      }
      wmma::store_matrix_sync(scratch[warp], acc[i], 16,
                              wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int rr = r0 + fr * 16 + e / 16;
        const int cc = c0 + fc * 16 + e % 16;
        if (rr < R && cc < L) {
          float* dst = out_t + rr * so_r + cc;
          *dst = accumulate ? *dst + scratch[warp][e] : scratch[warp][e];
        }
      }
      __syncwarp();
    }
  }
}

template <class Mode>
int launch(const void* a, long long sa_t, long long sa_r, const void* b,
           long long sb_t, long long sb_r, float* out, long long so_t,
           long long so_r, long long nT, int R, int L, int K, int accumulate,
           void* stream) {
  if (nT <= 0 || R <= 0 || L <= 0) return 0;
  const long long gy = (L + kTile - 1) / kTile, gz = (R + kTile - 1) / kTile;
  if (nT > 2147483647LL || gy > 65535 || gz > 65535 || K % 16)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)nT, (unsigned)gy, (unsigned)gz);
  tile_dot_kernel<Mode><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Mode::TA*>(a), sa_t, sa_r,
      static_cast<const typename Mode::TB*>(b), sb_t, sb_r, out, so_t, so_r,
      R, L, K, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), one entry point per mode.  Strides are in elements.
// The wrapper has checked shapes (K a multiple of 16), dtypes, unit inner
// strides, 16-byte aligned A and B rows and the grid limits.  Returns the
// launch's cudaGetLastError() code; 0 is success.
#define SDDMM_TILE_DOT(NAME, MODE)                                           \
  extern "C" int sddmm_tile_dot_##NAME(                                      \
      const void* a, long long sa_t, long long sa_r, const void* b,          \
      long long sb_t, long long sb_r, float* out, long long so_t,            \
      long long so_r, long long nT, int R, int L, int K, int accumulate,     \
      void* stream) {                                                        \
    return launch<MODE>(a, sa_t, sa_r, b, sb_t, sb_r, out, so_t, so_r, nT,   \
                        R, L, K, accumulate, stream);                        \
  }

SDDMM_TILE_DOT(tf32, Tf32)
SDDMM_TILE_DOT(mixed, Mixed)
SDDMM_TILE_DOT(float16, Float16)
SDDMM_TILE_DOT(bfloat16, Bfloat16)
SDDMM_TILE_DOT(float32, Float32)
