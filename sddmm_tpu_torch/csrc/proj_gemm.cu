// The attention layer's projection GEMM, forward and backward, in the port's
// "float32" arithmetic on Hopper's tensor cores.
//
// Replaces no TPU kernel: the JAX package leaves these products (the Q, K, V
// and output projections of sddmm_tpu/models/block_sparse_attention.py, and
// their gradients) to XLA at Precision.HIGHEST.  It was added because
// cuBLAS's fp32 GEMMs run them on the CUDA cores (FFMA), at about 3.9x the
// least time of their "float32" work, and they were the largest block of a
// Longformer training step's device time.
//
// What it computes.  C[m, n] = sum_k A[m, k] * B[n, k] with A (M x K) and
// B (N x K) both K-major, each fp32 value split into hi/mid/lo bfloat16
// planes (round to nearest even, as ops/tile_dot.py::split_bf16) and the six
// products of MODES["float32"]: lo.hi, mid.mid, hi.lo, mid.hi, hi.mid,
// hi.hi (A plane . B plane).  Two entry points:
//
//   sddmm_proj_split   the planes, from strided fp32 sources, as they are or
//                      transposed (a 64 x 64 tile through shared memory), up
//                      to two layouts of one source from one read;
//   sddmm_proj_gemm    the products over the planes, into C's layout: up to
//                      three column parts, each cut into chunks of its
//                      `chunk` columns that land `s_h` apart, rows `s_r`
//                      apart, times its `scale` (the heads of q_pad, k_pad
//                      and v, of any head counts and widths, V's value scale;
//                      or of a weight's gradient), with the zero sentinel row
//                      of q_pad and k_pad written.  A split job may scale its
//                      source first (V's cotangent by the value scale).
//
// The split is a pre-pass that writes the planes for TMA to read, rather
// than a step after an fp32 tile lands in shared memory: splitting in the
// GEMM would add the fp32 tile's reads and the planes' writes to the shared
// memory traffic that wgmma already loads near its limit (six products
// read each plane pair once per k step), and would need a transposing
// splitter warpgroup for the weight gradients' operands, which are M- and
// N-major.  The pre-pass moves 10 bytes an element through device memory
// (4 read, 6 written) and gives the GEMM one operand layout.
//
// Arithmetic.  Each 32-deep stage's products go into a fresh accumulator
// fragment (the first wgmma with scale-d 0): its ten small products first,
// then its two hi.hi products, so that the tensor cores' truncating
// accumulation errs only on the stage's own small sum; the fragment is then
// added to the running sum in fp32, rounded to nearest.  Chained onto one
// accumulator, every step's accumulation would truncate at the growing
// sum's alignment (2.8e-6 after K = 256 on an H100 for the tile kernel,
// worse than "tf32"); and an fp32 add a 16-deep step instead of a stage
// doubles the rounded adds along K (at K = 2304 on U[0,2) data, 8.7e-7
// against cuBLAS fp32's 5.1e-7).  The truncation is toward zero, so each
// fragment comes out short by a fixed share of itself, and so does the sum
// of them: C = (1 - beta) A.B with beta 4.2-5.1e-8 on an H100 (normal,
// U[0,2) and activation-like data, K = 32 to 4096), against cuBLAS's 0.
// Unlike rounding noise, that shrinks norms: a Longformer training step's
// loss read 6.6e-7 and its gradient norms 1.2e-6 off the fp64 reference,
// against 5e-8 and 1e-7 for cuBLAS fp32.  No order of the products avoids
// it: the truncation is in every tensor-core result, so a fragment of its
// own for hi.hi shrinks as well (the tile kernel's "float32" instance, whose
// hi.hi lands on a fresh 16-deep fragment of small products 2^-8 of it,
// reads 3.8-4.3e-8 on an H100).  So the add is an FMA, and three stages in
// eight (kb % 8 < 3) add their fragment times 1 + 2^-23, exactly before the
// add's one rounding: +3/8 * 1.19e-7 = +4.5e-8 of the sum, which leaves a
// bias within +-7e-9.  The plain version (ops/project.py::gemm_plain)
// rounds to nearest and has neither the shrink nor the correction.  A 96-column half at a time, so that the
// running sum (96 fp32 a thread) and the fresh fragment (48) fit the 168
// registers a thread of a 384-thread CTA has.
//
// Design (sm_90a).  A CTA computes a 128 x 192 tile of C with three
// warpgroups: a producer warp keeps a ring of 3 shared-memory stages full by
// TMA (one 4-D copy a stage and operand brings all three planes of a 32-deep
// k slice, 64-byte swizzled), and two consumer warpgroups each run
// wgmma.m64n96k16 on their 64 rows, two column halves a k step, with both operands read from shared
// memory.  Stage s is full when its mbarrier has counted the copy's bytes
// and empty when the 8 consumer warps have arrived.  128 x 192 fills the
// card at the layer's shapes (L = 4096 rows): 384 tiles (2.9 waves on 132
// SMs) for Q, K, V; 128 (0.97 wave) for the 768-wide products.  The weight
// gradients (768 x 2304 and 768 x 768 outputs, 72 and 24 tiles, over K =
// 4096) split K (blockIdx.z) as the wrapper's cost model chooses
// (ops/project.py::splits): each split writes its partial sums to a
// workspace, and the tile's last CTA to finish (a per-tile counter) adds
// them in the fixed order s = 0, 1, ... and writes C.  A tile's epilogue writes each accumulator straight from
// registers to C's layout, through a per-CTA table of column addresses.
//
// What bounds it.  Per 32-deep k slice a CTA reads 60 KB of planes (mostly
// from L2) and does 6 x 2 x 128 x 192 x 32 = 9.4 MFLOP on the tensor cores:
// 154 flops per byte of L2 traffic and, at the layer's shapes, over 700 per
// byte of device memory, well above the card's ~295.  So the tensor cores'
// bf16 rate bounds it: six bf16 products per useful product, 989 / 6 =
// 164.8 TFLOP/s of useful "float32" work.  The pre-pass is bound by bytes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // C rows of a CTA (two consumer warpgroups)
constexpr int kBN = 192;          // C columns of a CTA (the wgmma's N)
constexpr int kBK = 32;           // k slice of a stage: 64 bytes of bf16
constexpr int kStages = 3;
constexpr int kPlanes = 3;
constexpr int kConsumers = 2;     // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kATile = kBM * kBK * 2;                    // bytes a plane
constexpr int kBTile = kBN * kBK * 2;
constexpr int kStageBytes = kPlanes * (kATile + kBTile);  // 61440
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8 +
                           kBN * 8 + 4 + kBN + 3 + kBN * 8;
constexpr int kAcc = kBN / 2;     // fp32 accumulators a thread (m64n192)
constexpr int kHalf = kAcc / 2;   // those of one 96-column half (m64n96)
// 1 + 2^-23: three stages in eight add their fragment scaled by it (see
// Arithmetic)
constexpr float kUnbias = 1.00000011920928955078125f;
constexpr int kMaxSplitJobs = 8;
constexpr int kJobWords = 23;     // int64 words of a split job
constexpr int kSplitTile = 64;

// (A plane, B plane) of product q of the six, in ops/tile_dot.py MODES order
__host__ __device__ constexpr int prod_a(int q) {
  return q == 0 ? 2 : (q == 1 || q == 3) ? 1 : 0;
}
__host__ __device__ constexpr int prod_b(int q) {
  return q == 2 ? 2 : (q == 1 || q == 4) ? 1 : 0;
}

// C's layout: column n lies in part p, the first with n < end[p], at nn = n
// - end[p - 1] (0 for p = 0): chunk h = nn / chunk[p], d = nn % chunk[p];
// (m, n) holds scale[p] * C[m, n] at base[p] + h * s_h[p] + m * s_r[p] + d.
struct OutMap {
  float* base[3];
  long long s_h[3];
  long long s_r[3];
  int end[3];
  int chunk[3];
  float scale[3];
  int scaled;         // some part's scale is not 1
  int sentinel_row;   // a row of parts in sentinel_mask written 0, or -1
  int sentinel_mask;
};

struct GemmParams {
  CUtensorMap ta;     // A planes: (32, rows, K / 32, 3), box (32, 128, 1, 3)
  CUtensorMap tb;     // B planes: (32, rows, K / 32, 3), box (32, 192, 1, 3)
  OutMap out;
  float* ws;          // split partials (splits, M, N), ws_stride apart
  long long ws_stride;
  int* counters;      // a zero counter a tile, left zero
  int M, N;
  int nkb;            // 32-deep k slices
  int splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete.  A copy that never
// lands (a bad tensor map) traps after 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(addr, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// K-major operand in shared memory, 64-byte swizzle: rows of 64 bytes,
// 8-row groups 512 bytes apart (SBO); LBO unused for a swizzled K-major
// layout.  Every tile starts 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (static_cast<uint64_t>((addr & 0x3FFFF) >> 4)) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving register reads across a wgmma wait
__device__ __forceinline__ void fence_regs(float (&d)[kHalf]) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 96 fp32, the m64n96 fragment) (+)= A (64 x 16) . B (96 x 16)^T
__device__ __forceinline__ void wgmma_96(float (&d)[kHalf], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the address of column n of C (row 0), its part's row stride and scale,
// and whether its part has a sentinel
__device__ __forceinline__ float* column_ptr(const OutMap& o, int n,
                                             bool* sentinel, int* s_r,
                                             float* scale) {
  const int p = n < o.end[0] ? 0 : n < o.end[1] ? 1 : 2;
  const int nn = n - (p ? o.end[p - 1] : 0);
  const int h = nn / o.chunk[p];
  const int d = nn - h * o.chunk[p];
  *sentinel = (o.sentinel_mask >> p) & 1;
  *s_r = static_cast<int>(o.s_r[p]);
  *scale = o.scale[p];
  return o.base[p] + h * o.s_h[p] + d;
}

__global__ void __launch_bounds__(kThreads, 1)
    proj_gemm_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float** col = reinterpret_cast<float**>(empty + kStages);
  int* last = reinterpret_cast<int*>(col + kBN);
  uint8_t* col_sentinel = reinterpret_cast<uint8_t*>(last + 1);
  int* col_sr = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(col_sentinel + kBN) + 3) & ~uintptr_t(3));
  float* col_scale = reinterpret_cast<float*>(col_sr + kBN);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int kb0 = static_cast<int>(
      static_cast<long long>(split) * p.nkb / p.splits);
  const int kb1 = static_cast<int>(
      static_cast<long long>(split + 1) * p.nkb / p.splits);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kBN) {
    bool sent = false;
    int sr = 0;
    float sc = 1.0f;
    col[tid] = n0 + tid < p.N ? column_ptr(p.out, n0 + tid, &sent, &sr, &sc)
                              : nullptr;
    col_sentinel[tid] = sent;
    col_sr[tid] = sr;
    col_scale[tid] = sc;
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = smem + stage * kStageBytes;
        uint8_t* b = a + kPlanes * kATile;
        mbar_expect_tx(&full[stage], kStageBytes);
        tma_load_4d(a, &p.ta, &full[stage], 0, m0, kb, 0);
        tma_load_4d(b, &p.tb, &full[stage], 0, n0, kb, 0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[kAcc];
    float fresh[kHalf];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    const int lane = tid & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(smem + stage * kStageBytes) +
                         wg * 64 * kBK * 2;
      const uint32_t b = smem_u32(smem + stage * kStageBytes) +
                         kPlanes * kATile;
      const float up = (kb & 7) < 3 ? kUnbias : 1.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the stage's ten small products, then its two hi.hi products
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            wgmma_96(fresh, smem_desc(a + prod_a(q) * kATile + kk * 32),
                     smem_desc(b + prod_b(q) * kBTile + h * kBTile / 2 +
                               kk * 32),
                     kk + q > 0);
          }
        }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_96(fresh, smem_desc(a + kk * 32),
                   smem_desc(b + h * kBTile / 2 + kk * 32), 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(fresh);
#pragma unroll
        for (int i = 0; i < kHalf; ++i)
          acc[h * kHalf + i] = __fmaf_rn(fresh[i], up, acc[h * kHalf + i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: the m64n192 fragment, thread t holds rows r and r + 8 at
    // columns 8j + 2(t % 4) + {0, 1}
    const int warp = (tid % 128) / 32;
    const int r = m0 + wg * 64 + warp * 16 + lane / 4;
    if (p.splits > 1) {
      // this split's partial sums into the workspace; the tile's last CTA
      // to finish adds every split's in the order s = 0, 1, ...
      float* part = p.ws + split * p.ws_stride;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + j * 8 + (lane % 4) * 2;   // N % 4 == 0
        if (n >= p.N) continue;
        if (r < p.M)
          *reinterpret_cast<float2*>(
              part + static_cast<long long>(r) * p.N + n) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < p.M)
          *reinterpret_cast<float2*>(
              part + static_cast<long long>(r + 8) * p.N + n) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __threadfence();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128));
      int* count = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
      if (tid == 0) *last = atomicAdd(count, 1) == p.splits - 1;
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128));
      if (!*last) return;
      __threadfence();
      if (tid == 0) *count = 0;   // ready for the next launch
      // the tile's sums, float4 by float4 in row order, four in flight a
      // thread, each added in split order (this CTA's own partial read back
      // from L2 too)
      const int rows = min(kBM, p.M - m0), cols = min(kBN, p.N - n0);
      constexpr int kQuads = kBM * kBN / 4, kStep = kConsumers * 128;
      for (int i0 = tid; i0 < kQuads; i0 += 4 * kStep) {
        float4 sum[4];
#pragma unroll 4
        for (int q = 0; q < p.splits; ++q) {
          const float* src = p.ws + q * p.ws_stride;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kStep;
            const int rr = i / (kBN / 4), cc = (i % (kBN / 4)) * 4;
            if (i >= kQuads || rr >= rows || cc >= cols) continue;
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                src + static_cast<long long>(m0 + rr) * p.N + n0 + cc));
            if (q == 0) {
              sum[u] = v;
            } else {
              sum[u].x = __fadd_rn(sum[u].x, v.x);
              sum[u].y = __fadd_rn(sum[u].y, v.y);
              sum[u].z = __fadd_rn(sum[u].z, v.z);
              sum[u].w = __fadd_rn(sum[u].w, v.w);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kStep;
          const int rr = i / (kBN / 4), cc = (i % (kBN / 4)) * 4;
          if (i >= kQuads || rr >= rows || cc >= cols) continue;
          const float v[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            col[cc + e][static_cast<long long>(m0 + rr) * col_sr[cc + e]] =
                __fmul_rn(v[e], col_scale[cc + e]);
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      float* d0 = col[c];
      float* d1 = col[c + 1];
      const long long sr0 = col_sr[c], sr1 = col_sr[c + 1];
      const bool pair = d1 == d0 + 1 && d0 != nullptr && sr0 == sr1 &&
                        (reinterpret_cast<uintptr_t>(d0) & 7) == 0 &&
                        (sr0 & 1) == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r + 8 * half;
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (p.out.scaled) {
          v0 = __fmul_rn(v0, col_scale[c]);
          v1 = __fmul_rn(v1, col_scale[c + 1]);
        }
        if (row >= p.M) continue;
        if (pair) {
          *reinterpret_cast<float2*>(d0 + row * sr0) = make_float2(v0, v1);
        } else {
          if (d0 != nullptr) d0[row * sr0] = v0;
          if (d1 != nullptr) d1[row * sr1] = v1;
        }
      }
      if (p.out.sentinel_row >= 0 && m0 == 0 && wg == 0 && warp == 0 &&
          lane < 4) {
        if (d0 != nullptr && col_sentinel[c])
          d0[p.out.sentinel_row * sr0] = 0.0f;
        if (d1 != nullptr && col_sentinel[c + 1])
          d1[p.out.sentinel_row * sr1] = 0.0f;
      }
    }
  }
}

// One source (nb, nr, nc) fp32 at src + b * sb + r * sr + c, into up to two
// operands' planes.  An operand of R rows and K (a multiple of 32) is laid
// out in 32-deep k chunks, (row, k) at ((k / 32) * R + row) * 32 + k % 32,
// so that every TMA box of the GEMM is one contiguous block; its planes
// `plane` elements apart.  Element (b, r, c) lands at row row0 + b * row_b
// + r and k k0 + b * k_b + c, or transposed at row row0 + b * row_b + c and
// k k0 + b * k_b + r.
struct SplitDst {
  bf16* ptr;
  long long R, row0, k0, row_b, k_b, plane;
  int trans;
};

struct SplitJob {
  const float* src;
  long long nb, nr, nc, sb, sr;
  float scale;        // the source is split as scale * x
  SplitDst dst[2];
  int ndst;
  long long tiles_r, tiles_c, tile0;
};

struct SplitJobs {
  SplitJob job[kMaxSplitJobs];
  int njobs;
};

__device__ __forceinline__ void split3(float x, bf16* out) {
  out[0] = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(out[0]));
  out[1] = __float2bfloat16_rn(r);
  out[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(out[1])));
}

// four consecutive k of one destination, 8 bytes a plane if aligned
__device__ __forceinline__ void store4(bf16* o, long long plane,
                                       const float (&v)[4], int valid) {
  bf16 s[4][3];
#pragma unroll
  for (int e = 0; e < 4; ++e) split3(v[e], s[e]);
  if (valid == 4 && (reinterpret_cast<uintptr_t>(o) & 7) == 0 &&
      (plane & 3) == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      __nv_bfloat162 lo = __halves2bfloat162(s[0][q], s[1][q]);
      __nv_bfloat162 hi = __halves2bfloat162(s[2][q], s[3][q]);
      uint2 w;
      w.x = *reinterpret_cast<uint32_t*>(&lo);
      w.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o + q * plane) = w;
    }
  } else {
    for (int e = 0; e < valid; ++e)
#pragma unroll
      for (int q = 0; q < 3; ++q) o[e + q * plane] = s[e][q];
  }
}

__global__ void __launch_bounds__(256)
    proj_split_kernel(const __grid_constant__ SplitJobs js) {
  __shared__ float tile[kSplitTile][kSplitTile + 1];
  __shared__ SplitJob jb;
  if (threadIdx.x == 0) {
    int j = 0;
    while (j + 1 < js.njobs && blockIdx.x >= js.job[j + 1].tile0) ++j;
    jb = js.job[j];
  }
  __syncthreads();
  long long t = blockIdx.x - jb.tile0;
  const long long per_b = jb.tiles_r * jb.tiles_c;
  const long long b = t / per_b;
  t -= b * per_b;
  const long long r0 = (t / jb.tiles_c) * kSplitTile;
  const long long c0 = (t % jb.tiles_c) * kSplitTile;
  const float* src = jb.src + b * jb.sb;
  // (k0, k_b and the tile's corner are multiples of 4, so four consecutive
  // k of a store stay in one 32-deep chunk)
  for (int i = threadIdx.x; i < kSplitTile * kSplitTile / 4;
       i += blockDim.x) {
    const int rr = i / (kSplitTile / 4), cq = (i % (kSplitTile / 4)) * 4;
    const long long r = r0 + rr, c = c0 + cq;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < jb.nr) {
      const float* s = src + r * jb.sr + c;
      if (c + 3 < jb.nc && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        const float4 f = *reinterpret_cast<const float4*>(s);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else {
        for (int e = 0; e < 4; ++e)
          if (c + e < jb.nc) v[e] = s[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[rr][cq + e] = __fmul_rn(v[e], jb.scale);
  }
  __syncthreads();
  for (int d = 0; d < jb.ndst; ++d) {
    const SplitDst& o = jb.dst[d];
    for (int i = threadIdx.x; i < kSplitTile * kSplitTile / 4;
         i += blockDim.x) {
      const int outer = i / (kSplitTile / 4), q4 = (i % (kSplitTile / 4)) * 4;
      float v[4];
      long long row, k, left;
      if (!o.trans) {  // row r0 + outer, k along columns c0 + q4 ..
        const long long r = r0 + outer, c = c0 + q4;
        if (r >= jb.nr || c >= jb.nc) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = tile[outer][q4 + e];
        row = o.row0 + b * o.row_b + r;
        k = o.k0 + b * o.k_b + c;
        left = jb.nc - c;
      } else {  // row c0 + outer, k along rows r0 + q4 ..
        const long long c = c0 + outer, r = r0 + q4;
        if (c >= jb.nc || r >= jb.nr) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = tile[q4 + e][outer];
        row = o.row0 + b * o.row_b + c;
        k = o.k0 + b * o.k_b + r;
        left = jb.nr - r;
      }
      store4(o.ptr + ((k >> 5) * o.R + row) * 32 + (k & 31), o.plane, v,
             left < 4 ? static_cast<int>(left) : 4);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda the process already has loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// error codes of the entry points beyond cudaError_t's
constexpr int kNoEncoder = 10000;
constexpr int kEncodeFailed = 20000;  // + the CUresult

// d: [ptr, rows, K]: the planes of an operand in 32-deep k chunks (see
// SplitDst), viewed as (32, rows, K / 32, 3)
int make_map(CUtensorMap* map, const long long* d, int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t rows = static_cast<cuuint64_t>(d[1]);
  const cuuint64_t K = static_cast<cuuint64_t>(d[2]);
  const cuuint64_t dims[4] = {kBK, rows, K / kBK, kPlanes};
  const cuuint64_t strides[3] = {kBK * 2, rows * kBK * 2, rows * K * 2};
  const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(box_rows), 1,
                             kPlanes};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      reinterpret_cast<void*>(static_cast<uintptr_t>(d[0])), dims, strides,
      box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// a float passed as its bits in the low word
float word_float(long long w) {
  const uint32_t bits = static_cast<uint32_t>(w);
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}

// o (kOutWords): [base x 3, s_h x 3, s_r x 3, end x 3, chunk x 3, scale x 3
//                 (float bits), sentinel row, sentinel mask]
constexpr int kOutWords = 20;
OutMap out_map(const long long* o) {
  OutMap m;
  for (int i = 0; i < 3; ++i) {
    m.base[i] = reinterpret_cast<float*>(static_cast<uintptr_t>(o[i]));
    m.s_h[i] = o[3 + i];
    m.s_r[i] = o[6 + i];
    m.end[i] = static_cast<int>(o[9 + i]);
    m.chunk[i] = static_cast<int>(o[12 + i]);
    m.scale[i] = word_float(o[15 + i]);
  }
  m.sentinel_row = static_cast<int>(o[18]);
  m.sentinel_mask = static_cast<int>(o[19]);
  m.scaled = m.scale[0] != 1.0f || m.scale[1] != 1.0f || m.scale[2] != 1.0f;
  return m;
}

}  // namespace

// desc: [M, N, K, splits, A (3 words, make_map), B (3 words), C's layout
// (kOutWords, out_map), workspace, counters]: K a multiple of 32 that both
// operands share; with splits > 1 (N a multiple of 4, no sentinel row) the
// workspace holds splits x M x N fp32 and the counters a zero int a
// 128 x 192 tile
extern "C" int sddmm_proj_gemm(const long long* desc, void* stream) {
  const int M = static_cast<int>(desc[0]), N = static_cast<int>(desc[1]);
  const long long K = desc[2];
  const int splits = static_cast<int>(desc[3]);
  if (M <= 0 || N <= 0) return 0;
  if (K < kBK || K % kBK || desc[6] != K || desc[9] != K || splits < 1 ||
      splits > K / kBK ||
      (splits > 1 && (desc[10 + kOutWords] == 0 ||
                      desc[11 + kOutWords] == 0 || N % 4 ||
                      desc[10 + 18] >= 0)))
    return cudaErrorInvalidValue;
  GemmParams p;
  int rc = make_map(&p.ta, desc + 4, kBM);
  if (rc) return rc;
  rc = make_map(&p.tb, desc + 7, kBN);
  if (rc) return rc;
  p.out = out_map(desc + 10);
  for (int i = 0; i < 3; ++i)
    if (p.out.chunk[i] <= 0 || p.out.s_r[i] > 2147483647LL)
      return cudaErrorInvalidValue;
  p.ws = reinterpret_cast<float*>(
      static_cast<uintptr_t>(desc[10 + kOutWords]));
  p.ws_stride = static_cast<long long>(M) * N;
  p.counters = reinterpret_cast<int*>(
      static_cast<uintptr_t>(desc[11 + kOutWords]));
  p.M = M;
  p.N = N;
  p.nkb = static_cast<int>(K / kBK);
  p.splits = splits;
  int dev = 0;
  cudaGetDevice(&dev);
  static unsigned long long configured = 0;  // a bit a device
  if (dev < 64 && !(configured >> dev & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        proj_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << dev;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  proj_gemm_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// jobs: njobs x [src, nb, nr, nc, sb, sr, then two destinations of 8 words,
// ptr, R, row0, k0, row_b, k_b, transposed, plane (ptr 0: none), then the
// source's scale (float bits)]
extern "C" int sddmm_proj_split(const long long* jobs, int njobs,
                                void* stream) {
  if (njobs <= 0) return 0;
  if (njobs > kMaxSplitJobs) return cudaErrorInvalidValue;
  SplitJobs js;
  js.njobs = njobs;
  long long tiles = 0;
  for (int i = 0; i < njobs; ++i) {
    const long long* w = jobs + kJobWords * i;
    SplitJob& j = js.job[i];
    j.src = reinterpret_cast<const float*>(static_cast<uintptr_t>(w[0]));
    j.nb = w[1];
    j.nr = w[2];
    j.nc = w[3];
    j.sb = w[4];
    j.sr = w[5];
    j.scale = word_float(w[22]);
    j.ndst = 0;
    for (int d = 0; d < 2; ++d) {
      const long long* x = w + 6 + 8 * d;
      if (x[0] == 0) break;
      SplitDst& o = j.dst[j.ndst++];
      o.ptr = reinterpret_cast<bf16*>(static_cast<uintptr_t>(x[0]));
      o.R = x[1];
      o.row0 = x[2];
      o.k0 = x[3];
      o.row_b = x[4];
      o.k_b = x[5];
      o.trans = static_cast<int>(x[6]);
      o.plane = x[7];
      if ((o.k0 | o.k_b) & 3) return cudaErrorInvalidValue;
    }
    if (j.ndst == 0) return cudaErrorInvalidValue;
    j.tiles_r = (j.nr + kSplitTile - 1) / kSplitTile;
    j.tiles_c = (j.nc + kSplitTile - 1) / kSplitTile;
    j.tile0 = tiles;
    tiles += j.nb * j.tiles_r * j.tiles_c;
  }
  if (tiles == 0) return 0;
  proj_split_kernel<<<static_cast<unsigned>(tiles), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(js);
  return static_cast<int>(cudaGetLastError());
}
