// The tile kernel: every dense tile dot of one SDDMM call in one launch, on
// Hopper tensor cores, one instance per compute mode.
//
// Replaces sddmm_tpu/ops/pallas_tiles.py::_tile_dot_kernel (with its
// wrappers tile_dot_tf32 / tile_dot_padded), and the XLA programs around it
// in sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit: the A-row (or A-panel) and
// grouped-B^T gathers and the dots of every dense segment at any G and C,
// the hub slab and the hot-row slab; sddmm_tpu/ops/dense.py::_dense_full_jit;
// and the vmapped batch of sddmm_tpu/ops/batch.py (a head stride).
//
// What it computes.  A work table lists output blocks ("entries") of at most
// kRows A rows by kLanes B^T lanes.  For entry e and head h,
//   out[h][out_off + r * out_rs + l] (+)= sum_c dot_c(A row r, B^T lane l)
// for r < nrows, l < nlanes, where
//   A row r    = a + h * sa_h + row_ids[row_off + r] * sa_r + c * kc,
//   B^T lane l = b + (h >> kv_shift) * sb_h + c * sb_c
//                + gids[gid_off + (lane0 + l) / G] * sb_r
//                + ((lane0 + l) % G) * kc,
// each kc elements long.  kv_shift is 0 where every head has its own B^T;
// grouped-query attention reads the B^T (keys) of head h >> kv_shift in
// place, 2^kv_shift query heads a key head.  So the kernel reads the rows an entry names
// straight from the padded A and the grouped, chunked B^T: the gathers
// happen in its loads.  Each chunk's dot is summed apart in fp32 and added
// to the running sum in the order c = 0..C-1, as JAX's acc = acc + dot(c).
//
// Each mode differs only in the storage types and in how each value is split
// into bfloat16 planes (round to nearest even, as astype(bfloat16) in JAX and
// .to(torch.bfloat16) in PyTorch) before the bf16 products:
//
//   mode      A     B     A planes  B planes  products
//   tf32      fp32  fp32  hi lo     hi lo     hh hl lh           (XLA HIGH)
//   mixed     fp32  bf16  hi lo     b         hb lb
//   float16   fp16  fp16  hi lo     hi lo     hh hl lh           (_dot3)
//   bfloat16  bf16  bf16  a         b         ab
//   float32   fp32  fp32  hi mid lo hi mid lo hh hm mh hl mm lh  (XLA HIGHEST)
//
// Design.  One block of 8 warps per (entry, head): grid (entries, heads), so
// one call of a packing is one launch however many segments, slabs and
// heads it has.  The products run as mma.sync m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix, with the B^T lanes as the M side (each warp
// owns 16 of the 128 lanes) and the A rows as the N side in steps of 8, so
// a 16-row run wastes no products.  wgmma would need the rows of each
// operand in a shared-memory layout built by TMA or by one warpgroup's
// stores; with rows gathered by an index list and split into planes after
// they land, mma.sync keeps the fragments simple, and the kernel is bound by
// bytes, not by the tensor cores (below).  K is staged in 32-wide slices
// through a ring of kStages shared-memory stages filled by 16-byte cp.async
// copies (rows past the entry's edge are zero-filled), so the next slices
// are in flight while the current one is split and multiplied.  After a
// slice lands, each element is split into its bf16 planes once, with
// 8-byte shared-memory writes into rows 80 bytes apart (ldmatrix reads them
// without bank conflicts).  The accumulators go straight from registers to
// the flat output: a warp's store instruction covers 4 rows x 8 consecutive
// lanes, whole 32-byte sectors; only cells inside (nrows, nlanes) are
// written, at any alignment.  "float32" sums each 16-deep k step's six products in a
// fresh fragment and adds it to the running sum with fp32 adds (see
// Float32).
//
// What bounds it.  Per entry, (kRows + kLanes) * K storage elements are read
// (mostly from L2: A and B^T are 8-34 MB at the bench's shapes) and up to
// kRows * kLanes fp32 values are written.  At K = 128 a block does
// 2 * 64 * 128 * 128 * (products) flops for about 96 KB read and 32 KB
// written in fp32 storage: under 100 flops per byte in "float32", far below
// the card's ~295, so the kernel is bound by bytes (device memory for the
// output, L2 for the gathered rows), and the products overlap the loads
// through the stage ring.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // A rows per entry (mma N side)
constexpr int kLanes = 128;      // B^T lanes per entry (mma M side)
constexpr int kSlice = 32;       // K elements per stage
constexpr int kLd = kSlice + 8;  // bf16 plane row stride: 80 bytes
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEntryWords = 8;   // int64 words per table entry
constexpr int kNTiles = kRows / 8;  // n8 tiles of a warp

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// D (16x8 fp32) += A (16x16 bf16, row) . B (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The products of each mode, in the plain version's order (ops/tile_dot.py
// MODES).  l[j] is the warp's 16-lane fragment of B plane j, (r0[i], r1[i])
// its 8-row fragment of A plane i; product (i, j) is A plane i times B
// plane j.
struct Tf32 {
  using TA = float;
  using TB = float;
  static constexpr int kPlanesA = 2, kPlanesB = 2;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (*l)[4],
                                             const uint32_t* r0,
                                             const uint32_t* r1) {
    mma16816(c, l[0], r0[0], r1[0]);
    mma16816(c, l[1], r0[0], r1[0]);
    mma16816(c, l[0], r0[1], r1[1]);
  }
};

struct Mixed {
  using TA = float;
  using TB = bf16;
  static constexpr int kPlanesA = 2, kPlanesB = 1;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (*l)[4],
                                             const uint32_t* r0,
                                             const uint32_t* r1) {
    mma16816(c, l[0], r0[0], r1[0]);
    mma16816(c, l[0], r0[1], r1[1]);
  }
};

struct Float16 {
  using TA = __half;
  using TB = __half;
  static constexpr int kPlanesA = 2, kPlanesB = 2;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (*l)[4],
                                             const uint32_t* r0,
                                             const uint32_t* r1) {
    Tf32::mma(c, l, r0, r1);
  }
};

struct Bfloat16 {
  using TA = bf16;
  using TB = bf16;
  static constexpr int kPlanesA = 1, kPlanesB = 1;
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (*l)[4],
                                             const uint32_t* r0,
                                             const uint32_t* r1) {
    mma16816(c, l[0], r0[0], r1[0]);
  }
};

struct Float32 {
  using TA = float;
  using TB = float;
  static constexpr int kPlanesA = 3, kPlanesB = 3;
  // The six products whose plane orders sum to at most 2, smallest first,
  // go into a fresh fragment that is then added to the running sum with
  // fp32 adds (round to nearest).  Chained onto the running sum, every
  // mma's accumulation costs up to an ulp of that growing sum (2.8e-6
  // relative after K = 256 on the card, worse than "tf32"); this way an
  // mma errs only on its own 16-deep step.
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (*l)[4],
                                             const uint32_t* r0,
                                             const uint32_t* r1) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma16816(s, l[0], r0[2], r1[2]);
    mma16816(s, l[1], r0[1], r1[1]);
    mma16816(s, l[2], r0[0], r1[0]);
    mma16816(s, l[0], r0[1], r1[1]);
    mma16816(s, l[1], r0[0], r1[0]);
    mma16816(s, l[0], r0[0], r1[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], s[i]);
  }
};

// Shared-memory layout of one instance: the stages, the planes, and the
// entry's row and lane offsets.
template <class Mode>
struct Smem {
  using TA = typename Mode::TA;
  using TB = typename Mode::TB;
  static constexpr int kPA = Mode::kPlanesA, kPB = Mode::kPlanesB;
  // three stages, or two where six planes would leave one block per SM
  static constexpr int kStages = (kPA + kPB >= 6) ? 2 : 3;
  static constexpr int kStageA = kRows * kSlice * (int)sizeof(TA);
  static constexpr int kStageB = kLanes * kSlice * (int)sizeof(TB);
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kPlanes = (kPA * kRows + kPB * kLanes) * kLd * 2;
  static constexpr int kBody = kStages * kStage + kPlanes;
  static constexpr int kOffsets = (kRows + kLanes) * 8;
  static constexpr int kBytes = kBody + kOffsets;
};

// Split 4 consecutive storage elements into NP bf16 planes, 8 bytes each.
template <int NP, class T>
__device__ __forceinline__ void split4(const T* src, bf16* plane0,
                                       int plane_stride) {
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = to_float(src[j]);
  __align__(8) bf16 p[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bf16 h = __float2bfloat16_rn(x[j]);
    p[0][j] = h;
    if constexpr (NP >= 2) {
      const float r1 = x[j] - __bfloat162float(h);
      const bf16 m = __float2bfloat16_rn(r1);
      p[1][j] = m;
      if constexpr (NP >= 3) p[2][j] = __float2bfloat16_rn(r1 -
                                                         __bfloat162float(m));
    }
  }
#pragma unroll
  for (int q = 0; q < NP; ++q)
    *reinterpret_cast<uint2*>(plane0 + q * plane_stride) =
        *reinterpret_cast<const uint2*>(p[q]);
}

template <class Mode>
__global__ void __launch_bounds__(kThreads)
tile_table_kernel(const typename Mode::TA* __restrict__ a, long long sa_h,
                  long long sa_r, const typename Mode::TB* __restrict__ b,
                  long long sb_h, long long sb_c, long long sb_r,
                  const long long* __restrict__ table,
                  const int* __restrict__ row_ids,
                  const int* __restrict__ gids, float* __restrict__ out,
                  long long so_h, int C, int kc, int G, int kv_shift,
                  int accumulate) {
  using S = Smem<Mode>;
  using TA = typename Mode::TA;
  using TB = typename Mode::TB;
  constexpr int PA = S::kPA, PB = S::kPB, NST = S::kStages;
  constexpr int kVecA = 16 / sizeof(TA), kVecB = 16 / sizeof(TB);
  constexpr int kPiecesA = kRows * (kSlice / kVecA);
  constexpr int kPiecesB = kLanes * (kSlice / kVecB);

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;
  bf16* planes_a = reinterpret_cast<bf16*>(smem + NST * S::kStage);
  bf16* planes_b = planes_a + PA * kRows * kLd;
  long long* row_off = reinterpret_cast<long long*>(smem + S::kBody);
  long long* lane_off = row_off + kRows;

  const long long* ent = table + (long long)blockIdx.x * kEntryWords;
  const long long e_row = ent[0];
  const int nrows = (int)ent[1];
  const long long e_gid = ent[2];
  const long long lane0 = ent[3];
  const int nlanes = (int)ent[4];
  const long long e_out = ent[5];
  const long long out_rs = ent[6];
  const long long head = blockIdx.y;
  const TA* a_h = a + head * sa_h;
  const TB* b_h = b + (head >> kv_shift) * sb_h;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid < kRows) {
    row_off[tid] = tid < nrows ? (long long)row_ids[e_row + tid] * sa_r : 0;
  } else if (tid < kRows + kLanes) {
    const int l = tid - kRows;
    long long off = 0;
    if (l < nlanes) {
      const long long L = lane0 + l;
      off = (long long)gids[e_gid + L / G] * sb_r + (L % G) * (long long)kc;
    }
    lane_off[l] = off;
  }
  __syncthreads();

  const int spc = (kc + kSlice - 1) / kSlice;  // slices per chunk
  const int nslices = C * spc;

  // copy slice s (chunk s / spc, columns from (s % spc) * kSlice) into its
  // stage; rows and lanes past the entry and columns past kc read zeros
  auto issue = [&](int s) {
    if (s < nslices) {
      const int c = s / spc;
      const int k0 = (s % spc) * kSlice;
      unsigned char* st = stages + (s % NST) * S::kStage;
      TA* ra = reinterpret_cast<TA*>(st);
      TB* rb = reinterpret_cast<TB*>(st + S::kStageA);
      for (int i = tid; i < kPiecesA + kPiecesB; i += kThreads) {
        if (i < kPiecesA) {
          const int r = i / (kSlice / kVecA);
          const int k = (i % (kSlice / kVecA)) * kVecA;
          const bool ok = r < nrows && k0 + k < kc;
          const TA* src =
              ok ? a_h + row_off[r] + (long long)c * kc + k0 + k : a;
          cp_async16(ra + r * kSlice + k, src, ok ? 16 : 0);
        } else {
          const int j = i - kPiecesA;
          const int l = j / (kSlice / kVecB);
          const int k = (j % (kSlice / kVecB)) * kVecB;
          const bool ok = l < nlanes && k0 + k < kc;
          const TB* src =
              ok ? b_h + (long long)c * sb_c + lane_off[l] + k0 + k : b;
          cp_async16(rb + l * kSlice + k, src, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[kNTiles][4];
  float tot[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = tot[n][i] = 0.0f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) issue(s);

  const bool warp_on = warp * 16 < nlanes;
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<NST - 2>();
    // slice s has landed for every thread; the planes of slice s - 1 and
    // the stage of slice s - 1 are no longer read
    __syncthreads();
    issue(s + NST - 1);
    {
      const unsigned char* st = stages + (s % NST) * S::kStage;
      const TA* ra = reinterpret_cast<const TA*>(st);
      const TB* rb = reinterpret_cast<const TB*>(st + S::kStageA);
      constexpr int kGroupsA = kRows * kSlice / 4;
      constexpr int kGroupsB = kLanes * kSlice / 4;
      for (int i = tid; i < kGroupsA + kGroupsB; i += kThreads) {
        if (i < kGroupsA) {
          const int r = i / (kSlice / 4), k = (i % (kSlice / 4)) * 4;
          split4<PA>(ra + r * kSlice + k, planes_a + r * kLd + k,
                     kRows * kLd);
        } else {
          const int j = i - kGroupsA;
          const int l = j / (kSlice / 4), k = (j % (kSlice / 4)) * 4;
          split4<PB>(rb + l * kSlice + k, planes_b + l * kLd + k,
                     kLanes * kLd);
        }
      }
    }
    __syncthreads();
    const int k0 = (s % spc) * kSlice;
    const int ksteps = min(kSlice, kc - k0) / 16;
    if (warp_on) {
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t fl[PB][4];
#pragma unroll
        for (int p = 0; p < PB; ++p)
          ldsm_x4(fl[p], planes_b + p * kLanes * kLd +
                             (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLd +
                             ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          if (np * 16 < nrows) {
            uint32_t fr[PA][4];
#pragma unroll
            for (int p = 0; p < PA; ++p)
              ldsm_x4(fr[p], planes_a + p * kRows * kLd +
                                 (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     kLd +
                                 ks * 16 + ((lane >> 3) & 1) * 8);
            uint32_t lo0[PA], lo1[PA], hi0[PA], hi1[PA];
#pragma unroll
            for (int p = 0; p < PA; ++p) {
              lo0[p] = fr[p][0];
              lo1[p] = fr[p][1];
              hi0[p] = fr[p][2];
              hi1[p] = fr[p][3];
            }
            Mode::mma(acc[2 * np], fl, lo0, lo1);
            Mode::mma(acc[2 * np + 1], fl, hi0, hi1);
          }
        }
      }
    }
    if (s % spc == spc - 1) {
      // chunk done: add its dot to the running sum, c = 0..C-1 in order
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[n][i] = __fadd_rn(tot[n][i], acc[n][i]);
          acc[n][i] = 0.0f;
        }
    }
  }
  cp_async_wait<0>();
  if (!warp_on) return;
  // Fragment element (lane 16w + g (+8), row 8n + 2t (+1)) goes straight
  // out: one store instruction of the warp covers 4 rows x 8 consecutive
  // lanes, whole 32-byte sectors, so nothing is staged.
  float* o = out + head * so_h + e_out;
  const int g = lane / 4, t = lane % 4;
  const int l = warp * 16 + g;
  auto put = [&](int r, int col, float v) {
    if (r < nrows && col < nlanes) {
      float* d = o + r * out_rs + col;
      *d = accumulate ? __fadd_rn(*d, v) : v;
    }
  };
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
    const int r = n * 8 + 2 * t;
    put(r, l, tot[n][0]);
    put(r + 1, l, tot[n][1]);
    put(r, l + 8, tot[n][2]);
    put(r + 1, l + 8, tot[n][3]);
  }
}

template <class Mode>
int launch(const void* a, long long sa_h, long long sa_r, const void* b,
           long long sb_h, long long sb_c, long long sb_r,
           const long long* table, long long n_entries, const int* row_ids,
           const int* gids, float* out, long long so_h, int heads, int C,
           int kc, int G, int kv_shift, int accumulate, void* stream) {
  if (n_entries <= 0 || heads <= 0 || C <= 0) return 0;
  if (n_entries > 2147483647LL || heads > 65535 || kc <= 0 || kc % 16 ||
      G <= 0 || kv_shift < 0 || kv_shift > 16)
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = Smem<Mode>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_table_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)n_entries, (unsigned)heads);
  tile_table_kernel<Mode><<<grid, kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Mode::TA*>(a), sa_h, sa_r,
      static_cast<const typename Mode::TB*>(b), sb_h, sb_c, sb_r, table,
      row_ids, gids, out, so_h, C, kc, G, kv_shift, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), one entry point per mode.  Strides are in elements.
// The wrapper (ops/tile_dot.py::tile_table) has checked dtypes, unit inner
// strides, 16-byte aligned rows, kc a multiple of 16, indices in range and a
// table of (n_entries, 8) int64 entries [row_off, nrows <= 64, gid_off,
// lane0, nlanes <= 128, out_off, out_rs, 0].  Returns the launch's
// cudaGetLastError() code; 0 is success.
#define SDDMM_TILE_DOT(NAME, MODE)                                            \
  extern "C" int sddmm_tile_dot_##NAME(                                       \
      const void* a, long long sa_h, long long sa_r, const void* b,           \
      long long sb_h, long long sb_c, long long sb_r, const long long* table, \
      long long n_entries, const int* row_ids, const int* gids, float* out,   \
      long long so_h, int heads, int C, int kc, int G, int kv_shift,          \
      int accumulate, void* stream) {                                         \
    return launch<MODE>(a, sa_h, sa_r, b, sb_h, sb_c, sb_r, table,            \
                        n_entries, row_ids, gids, out, so_h, heads, C, kc, G, \
                        kv_shift, accumulate, stream);                        \
  }

SDDMM_TILE_DOT(tf32, Tf32)
SDDMM_TILE_DOT(mixed, Mixed)
SDDMM_TILE_DOT(float16, Float16)
SDDMM_TILE_DOT(bfloat16, Bfloat16)
SDDMM_TILE_DOT(float32, Float32)
