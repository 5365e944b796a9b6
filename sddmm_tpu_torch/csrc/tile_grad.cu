// The hybrid SDDMM's backward (B1) over the tile kernel's work table, on
// Hopper tensor cores.
//
// Replaces the VJP of sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit
// (:135-327) and of device_bt_phys (:366-377), which jax.value_and_grad
// builds (sddmm_tpu/models/factorization.py:94): the cotangent of the
// packed flat vector reaching the A rows and the grouped B^T lanes that
// the dense tiles read.  For a table entry e (csrc/tile_dot.cu: at most
// kRows A rows by kLanes B^T lanes, its slot (r, l) at out_off + r *
// out_rs + l) and head h, with dO[r][l] the cotangent at that slot,
//   dA[h][row(r)][k]   += sum_l dO[r][l] * Bt[h][lane(l)][k]
//   dBt[h][lane(l)][k] += sum_r dO[r][l] * A[h][row(r)][k]
// for every column k of K = C * kc (column k of a lane is chunk k / kc,
// element k % kc of the lane's kc; of an A row simply k).  The residual's
// entries are not here: the wrapper runs them through the SpMM kernel.
//
// Design.  Two kernels, a fixed order throughout, no atomics, so a repeat
// backward is bit-equal:
// - tile_grad_kernel, one launch: every block is one "unit", a walk over
//   table entries that share their rows (a dA unit: the lane windows of
//   one row window, built by ops/tile_dot.py::grad_index) or their lanes (a
//   dB^T unit: the row windows of one lane window), at most a fixed number
//   of entries each, so the hub slab's 512 row windows against one lane
//   window become parts that run side by side.  A unit sums its products
//   in registers and writes one partial, kRows (or kLanes) rows of K,
//   into a workspace.  grid.y cuts K into slices of KS columns (at most
//   64, to bound registers and shared memory; a dA block takes two slices
//   where K allows, so its cotangent is split once for 128 columns), grid.z
//   is the head.
// - tile_grad_reduce_kernel, one launch: a warp per output row (an A row,
//   or a B^T lane) adds its partials in the index's order (units in table
//   order) and writes the row, or adds it to what is there (the
//   residual's SpMM, which ran first).  Rows with no partial are written
//   as zeros.
// The products run as mma.sync m16n8k16 (bf16 in, fp32 accumulate) on the
// six products of the hi/mid/lo bf16 split of both operands, each 16-deep
// k step summed in a fresh fragment and added to the running sum with fp32
// adds: the "float32" instance's math of csrc/tile_dot.cu, within about one
// fp32 rounding of the exact product whatever the forward's mode (the
// wrapper hands fp32 operands; fp16 and bf16 storage converts exactly).
// The reduction dimension (the lanes for dA, the rows for dB^T) is staged
// 32 at a time through a 2-stage cp.async ring: the cotangent tile is a
// strided 2-D window of the flat vector (16-byte copies where an entry's
// rows are 16-byte aligned, as the packings' are, else 4-byte ones), the A
// rows and B^T lanes are gathered through the table's row ids and group
// rows in 16-byte pieces (TMA cannot gather rows by an index list).
// After a stage lands each element is split into its planes once, into
// layouts with the reduction dimension contiguous (pairs along it), so
// ldmatrix loads every fragment without a transpose, rows 80 bytes apart
// (no bank conflicts), as in csrc/tile_dot.cu.
//
// What bounds it.  The work reads each slot's cotangent once per pass and
// K slice and the operands' rows from L2, and writes the partials (kRows
// or kLanes by K fp32 a unit) that the reduce reads back once.  At K = 128
// a dA block does 2 * 64 * 128 * 64 * 6 flops per entry and K slice for
// 32 KB of cotangent and 32 KB of B^T lanes: about 100 flops per byte,
// under the card's ~295 for bf16, so it is bound by bytes (mostly L2),
// as the forward tile kernel is; the six-product split costs 6x the
// tensor-core work of one bf16 product and stays under that line.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // A rows of a table entry
constexpr int kLanes = 128;      // B^T lanes of a table entry
constexpr int kStep = 32;        // reduction elements (lanes or rows) a stage
constexpr int kLd = kStep + 8;   // bf16 plane row stride: 80 bytes
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEntryWords = 8;   // int64 words of a table entry
constexpr int kUnitWords = 4;    // [walk start, entries, partial row, 0]
constexpr int kPlanes = 3;       // hi, mid, lo
constexpr int kStages = 2;

using bf16 = __nv_bfloat16;

// D (16x8 fp32) += A (16x16 bf16, row) . B (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 or 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// x0, x1 -> their hi, mid and lo bf16 planes (round to nearest even, as
// ops/tile_dot.py::split_bf16), each plane's pair packed into one word,
// x0 in the low half (the mma fragments' element order): one packed
// conversion a plane
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&w)[kPlanes]) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(x0, x1));
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __float22bfloat162_rn(make_float2(r0, r1));
  const float2 mf = __bfloat1622float2(m);
  w[0] = bits(h);
  w[1] = bits(m);
  w[2] = bits(__float22bfloat162_rn(make_float2(r0 - mf.x, r1 - mf.y)));
}

__device__ __forceinline__ void put_planes(bf16* plane0, int plane_stride,
                                           int at, float x0, float x1) {
  uint32_t w[kPlanes];
  split_pair(x0, x1, w);
#pragma unroll
  for (int q = 0; q < kPlanes; ++q)
    *reinterpret_cast<uint32_t*>(plane0 + q * plane_stride + at) = w[q];
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The A-side fragment (16 x 16) of rows m0.. at k0 of a [row][k] plane,
// rows kLd apart (csrc/tile_dot.cu's addressing)
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* pl,
                                       int m0, int k0, int lane) {
  ldsm_x4(r, pl + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + k0 +
                 (lane >> 4) * 8);
}

// The B-side fragments of the n8 tiles n0.. and n0 + 8.. at k0 of a
// [n][k] plane: r[0], r[1] the first tile's, r[2], r[3] the second's
__device__ __forceinline__ void frag_b2(uint32_t (&r)[4], const bf16* pl,
                                        int n0, int k0, int lane) {
  ldsm_x4(r, pl + (n0 + (lane & 7) + (lane >> 4) * 8) * kLd + k0 +
                 ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void frag_b1(uint32_t& b0, uint32_t& b1,
                                        const bf16* pl, int n0, int k0,
                                        int lane) {
  ldsm_x2(b0, b1, pl + (n0 + (lane & 7)) * kLd + k0 + ((lane >> 3) & 1) * 8);
}

// Copy one row piece of the cotangent: 4 floats at src (16 bytes, of which
// ``left`` floats are real, the rest zero-filled) where the rows are
// 16-byte aligned, else one float (4 bytes, or 0 where ``left`` <= 0)
__device__ __forceinline__ void copy_cot(float* dst, const float* src,
                                         const float* base, int left,
                                         bool vec) {
  if (vec) {
    const int n = left <= 0 ? 0 : (left >= 4 ? 4 : left);
    cp_async16(dst, n ? src : base, 4 * n);
  } else {
    cp_async4(dst, left > 0 ? src : base, left > 0 ? 4 : 0);
  }
}

// The six products of the "float32" split, smallest plane orders first (the
// order of csrc/tile_dot.cu Float32 and ops/tile_dot.py MODES), summed in a
// fresh fragment that is then added to c with fp32 adds.  a[i]: fragment of
// the A-side operand's plane i; (b0[j], b1[j]): of the B-side's plane j.
__device__ __forceinline__ void mma6(float (&c)[4],
                                     const uint32_t (&a)[kPlanes][4],
                                     const uint32_t (&b0)[kPlanes],
                                     const uint32_t (&b1)[kPlanes]) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma16816(s, a[2], b0[0], b1[0]);
  mma16816(s, a[1], b0[1], b1[1]);
  mma16816(s, a[0], b0[2], b1[2]);
  mma16816(s, a[1], b0[0], b1[0]);
  mma16816(s, a[0], b0[1], b1[1]);
  mma16816(s, a[0], b0[0], b1[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], s[i]);
}

// acc[n] (+)= a . (the n8 tiles n0 + 8n.. of the B-side planes), over the
// six products, for NT tiles: two tiles a fragment load where they pair up
template <int NT, int PS>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4],
                                          const uint32_t (&fa)[kPlanes][4],
                                          const bf16* planes, int n0,
                                          int k0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    uint32_t b0[kPlanes], b1[kPlanes], c0[kPlanes], c1[kPlanes];
    if (n + 1 < NT) {
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        uint32_t f[4];
        frag_b2(f, planes + q * PS, n0 + n * 8, k0, lane);
        b0[q] = f[0];
        b1[q] = f[1];
        c0[q] = f[2];
        c1[q] = f[3];
      }
      mma6(acc[n], fa, b0, b1);
      mma6(acc[n + 1], fa, c0, c1);
    } else {
#pragma unroll
      for (int q = 0; q < kPlanes; ++q)
        frag_b1(b0[q], b1[q], planes + q * PS, n0 + n * 8, k0, lane);
      mma6(acc[n], fa, b0, b1);
    }
  }
}

// Shared memory of a dA block for a K slice of KS columns: 2 stages of
// the cotangent [kRows][kStep] and B^T [kStep lanes][KS] fp32, and the
// planes
template <int KS>
struct SmemA {
  static constexpr int kStage = (kRows * kStep + kStep * KS) * 4;
  static constexpr int kBytes =
      kStages * kStage + kPlanes * (kRows + KS) * kLd * 2;
};
// and of a dB^T block: the cotangent [kStep rows][kLanes] and A [kStep
// rows][KS]
template <int KS>
struct SmemB {
  static constexpr int kStage = (kStep * kLanes + kStep * KS) * 4;
  static constexpr int kBytes =
      kStages * kStage + kPlanes * (kLanes + KS) * kLd * 2;
};

struct Args {
  const float* a;
  long long sa_h, sa_r;
  const float* b;
  long long sb_h, sb_c, sb_r;
  const float* g;
  long long sg_h;
  const long long* table;
  const int* row_ids;
  const int* gids;
  const long long* units;
  int n_units_a;
  const int* walk;
  float* ws;
  long long sw_h;
  int K, kc, G;
  int kv_shift;   // head h reads the B^T of head h >> kv_shift
};

// dA unit: its entries share their A rows; the block sums, over their
// lanes, dO (rows x lanes) . B^T lanes (lanes x KS columns) into a
// kRows x KS partial.  Warp w owns rows 16 (w % 4).. and half the columns.
template <int KS>
__device__ void grad_rows(const Args& p, const long long* unit,
                          unsigned char* smem, int k0) {
  using S = SmemA<KS>;
  constexpr int kSlices = kLanes / kStep;  // stages an entry
  constexpr int NT = KS / 16;              // n8 tiles of a warp
  const long long start = unit[0];
  const int count = (int)unit[1];
  const long long prow = unit[2];
  const long long head = blockIdx.z;
  const float* g_h = p.g + head * p.sg_h;
  const float* b_h = p.b + (head >> p.kv_shift) * p.sb_h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nrows = (int)p.table[(long long)p.walk[start] * kEntryWords + 1];
  bf16* planes_o = reinterpret_cast<bf16*>(smem + kStages * S::kStage);
  bf16* planes_b = planes_o + kPlanes * kRows * kLd;
  const int nsteps = count * kSlices;

  // the step's entry and its lane slice; false where the slice is past
  // the entry's lanes (nothing is loaded or multiplied)
  auto step_of = [&](int s, const long long*& ent, int& l0) {
    ent = p.table + (long long)p.walk[start + s / kSlices] * kEntryWords;
    l0 = (s % kSlices) * kStep;
    return l0 < (int)ent[4];
  };
  auto issue = [&](int s) {
    const long long* ent;
    int l0;
    if (s < nsteps && step_of(s, ent, l0)) {
      const int nlanes = (int)ent[4];
      const long long gid_off = ent[2], lane0 = ent[3];
      const long long out_off = ent[5], out_rs = ent[6];
      float* st_o = reinterpret_cast<float*>(smem + (s % kStages) *
                                             S::kStage);
      float* st_b = st_o + kRows * kStep;
      const float* o = g_h + out_off + l0;
      const bool vec = ((reinterpret_cast<uintptr_t>(o) & 15) |
                        (out_rs & 3)) == 0;
      const int w = vec ? 4 : 1;  // floats a copy
      for (int i = tid; i < kRows * kStep / w; i += kThreads) {
        const int r = i / (kStep / w), l = (i % (kStep / w)) * w;
        copy_cot(st_o + r * kStep + l, o + r * out_rs + l, g_h,
                 r < nrows ? nlanes - l0 - l : 0, vec);
      }
      for (int i = tid; i < kStep * KS / 4; i += kThreads) {
        const int l = i / (KS / 4), k = (i % (KS / 4)) * 4;
        const bool ok = l0 + l < nlanes;
        const float* src = b_h;
        if (ok) {
          const long long L = lane0 + l0 + l;
          const int col = k0 + k;
          src = b_h + (long long)(col / p.kc) * p.sb_c +
                (long long)p.gids[gid_off + L / p.G] * p.sb_r +
                (L % p.G) * (long long)p.kc + col % p.kc;
        }
        cp_async16(st_b + l * KS + k, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  issue(0);
  const int g = lane / 4, t = lane % 4;
  const int mr = (warp % 4) * 16;
  const int nc = (warp / 4) * (KS / 2);
  const bool warp_on = mr < nrows;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();
    // step s has landed; the planes and the stage of step s - 1 are free
    __syncthreads();
    issue(s + 1);
    const long long* ent;
    int l0;
    const bool on = step_of(s, ent, l0);
    if (on) {
      const float* st_o = reinterpret_cast<const float*>(
          smem + (s % kStages) * S::kStage);
      const float* st_b = st_o + kRows * kStep;
      // dO by rows, pairs along the lanes
      for (int i = tid; i < kRows * kStep / 2; i += kThreads) {
        const int r = i / (kStep / 2), lp = 2 * (i % (kStep / 2));
        put_planes(planes_o, kRows * kLd, r * kLd + lp, st_o[r * kStep + lp],
                   st_o[r * kStep + lp + 1]);
      }
      // B^T by columns, pairs along the lanes
      for (int i = tid; i < KS * kStep / 2; i += kThreads) {
        const int k = i % KS, lp = 2 * (i / KS);
        put_planes(planes_b, KS * kLd, k * kLd + lp, st_b[lp * KS + k],
                   st_b[(lp + 1) * KS + k]);
      }
    }
    __syncthreads();
    if (on && warp_on) {
#pragma unroll
      for (int ks = 0; ks < kStep / 16; ++ks) {
        uint32_t fa[kPlanes][4];
#pragma unroll
        for (int q = 0; q < kPlanes; ++q)
          frag_a(fa[q], planes_o + q * kRows * kLd, mr, ks * 16, lane);
        mma_tiles<NT, KS * kLd>(acc, fa, planes_b, nc, ks * 16, lane);
      }
    }
  }
  cp_async_wait_all();
  if (!warp_on) return;
  // fragment (row g (+8), columns 2t, 2t+1) of each n8 tile
  float* w = p.ws + head * p.sw_h + prow * p.K + k0 + nc + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = mr + g;
    if (r < nrows)
      *reinterpret_cast<float2*>(w + r * (long long)p.K + n * 8) =
          make_float2(acc[n][0], acc[n][1]);
    if (r + 8 < nrows)
      *reinterpret_cast<float2*>(w + (r + 8) * (long long)p.K + n * 8) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// dB^T unit: its entries share their B^T lanes; the block sums, over their
// rows, dO^T (lanes x rows) . A rows (rows x KS columns) into a kLanes x KS
// partial.  Warp w owns lanes 16w.. and every column.
template <int KS>
__device__ void grad_lanes(const Args& p, const long long* unit,
                           unsigned char* smem) {
  using S = SmemB<KS>;
  constexpr int kSlices = kRows / kStep;
  constexpr int NT = KS / 8;
  const long long start = unit[0];
  const int count = (int)unit[1];
  const long long prow = unit[2];
  const long long head = blockIdx.z;
  const int k0 = blockIdx.y * KS;
  const float* g_h = p.g + head * p.sg_h;
  const float* a_h = p.a + head * p.sa_h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nlanes = (int)p.table[(long long)p.walk[start] * kEntryWords + 4];
  bf16* planes_o = reinterpret_cast<bf16*>(smem + kStages * S::kStage);
  bf16* planes_a = planes_o + kPlanes * kLanes * kLd;
  const int nsteps = count * kSlices;

  auto step_of = [&](int s, const long long*& ent, int& r0) {
    ent = p.table + (long long)p.walk[start + s / kSlices] * kEntryWords;
    r0 = (s % kSlices) * kStep;
    return r0 < (int)ent[1];
  };
  auto issue = [&](int s) {
    const long long* ent;
    int r0;
    if (s < nsteps && step_of(s, ent, r0)) {
      const int nrows = (int)ent[1];
      const long long row_off = ent[0];
      const long long out_off = ent[5], out_rs = ent[6];
      float* st_o = reinterpret_cast<float*>(smem + (s % kStages) *
                                             S::kStage);
      float* st_a = st_o + kStep * kLanes;
      const float* o = g_h + out_off + r0 * out_rs;
      const bool vec = ((reinterpret_cast<uintptr_t>(o) & 15) |
                        (out_rs & 3)) == 0;
      const int w = vec ? 4 : 1;  // floats a copy
      for (int i = tid; i < kStep * kLanes / w; i += kThreads) {
        const int r = i / (kLanes / w), l = (i % (kLanes / w)) * w;
        copy_cot(st_o + r * kLanes + l, o + r * out_rs + l, g_h,
                 r0 + r < nrows ? nlanes - l : 0, vec);
      }
      for (int i = tid; i < kStep * KS / 4; i += kThreads) {
        const int r = i / (KS / 4), k = (i % (KS / 4)) * 4;
        const bool ok = r0 + r < nrows;
        const float* src =
            ok ? a_h + (long long)p.row_ids[row_off + r0 + r] * p.sa_r + k0 +
                     k
               : a_h;
        cp_async16(st_a + r * KS + k, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  issue(0);
  const int g = lane / 4, t = lane % 4;
  const int ml = warp * 16;
  const bool warp_on = ml < nlanes;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();
    __syncthreads();
    issue(s + 1);
    const long long* ent;
    int r0;
    const bool on = step_of(s, ent, r0);
    if (on) {
      const float* st_o = reinterpret_cast<const float*>(
          smem + (s % kStages) * S::kStage);
      const float* st_a = st_o + kStep * kLanes;
      // dO^T by lanes, pairs along the rows
      for (int i = tid; i < kLanes * kStep / 2; i += kThreads) {
        const int l = i % kLanes, rp = 2 * (i / kLanes);
        put_planes(planes_o, kLanes * kLd, l * kLd + rp,
                   st_o[rp * kLanes + l], st_o[(rp + 1) * kLanes + l]);
      }
      // A by columns, pairs along the rows
      for (int i = tid; i < KS * kStep / 2; i += kThreads) {
        const int k = i % KS, rp = 2 * (i / KS);
        put_planes(planes_a, KS * kLd, k * kLd + rp, st_a[rp * KS + k],
                   st_a[(rp + 1) * KS + k]);
      }
    }
    __syncthreads();
    if (on && warp_on) {
#pragma unroll
      for (int ks = 0; ks < kStep / 16; ++ks) {
        uint32_t fa[kPlanes][4];
#pragma unroll
        for (int q = 0; q < kPlanes; ++q)
          frag_a(fa[q], planes_o + q * kLanes * kLd, ml, ks * 16, lane);
        mma_tiles<NT, KS * kLd>(acc, fa, planes_a, 0, ks * 16, lane);
      }
    }
  }
  cp_async_wait_all();
  if (!warp_on) return;
  float* w = p.ws + head * p.sw_h + prow * p.K + k0 + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int l = ml + g;
    if (l < nlanes)
      *reinterpret_cast<float2*>(w + l * (long long)p.K + n * 8) =
          make_float2(acc[n][0], acc[n][1]);
    if (l + 8 < nlanes)
      *reinterpret_cast<float2*>(w + (l + 8) * (long long)p.K + n * 8) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// Units [0, n_units_a) are dA units, the others dB^T units; blockIdx.y is
// the K slice of KS columns.  kWideA: a dA block covers two slices (2 KS
// columns, the cotangent split once for both) and the odd slices' dA
// blocks have nothing to do.
template <int KS, bool kWideA>
__global__ void __launch_bounds__(kThreads) tile_grad_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long* unit = p.units + (long long)blockIdx.x * kUnitWords;
  if ((int)blockIdx.x >= p.n_units_a) {
    grad_lanes<KS>(p, unit, smem);
  } else if constexpr (kWideA) {
    if (blockIdx.y % 2 == 0) grad_rows<2 * KS>(p, unit, smem, blockIdx.y * KS);
  } else {
    grad_rows<KS>(p, unit, smem, blockIdx.y * KS);
  }
}

// A warp per output row t: rows [0, n_a) are A rows (da, K contiguous
// columns), the others B^T lanes t - n_a (db, column k in chunk k / kc at
// a chunk stride).  The row's partials (src[tptr[t]..tptr[t+1]), rows of
// the workspace) are added in that order; 4 columns a lane.  With kv_shift
// > 0 (grouped-query attention) the B^T rows are those of key head h >>
// kv_shift: the block of the group's first head adds the partials of the
// group's 2^kv_shift heads, head by head in order, and the others have no
// B^T row to write.
__global__ void __launch_bounds__(256) tile_grad_reduce_kernel(
    const float* __restrict__ ws, long long sw_h, int K,
    const long long* __restrict__ tptr, const int* __restrict__ src,
    long long n_a, long long n_targets, float* da, long long sda_h,
    float* db, long long sdb_h, long long sdb_c, int kc, int accumulate,
    int kv_shift) {
  const long long t = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (t >= n_targets) return;
  const int lane = threadIdx.x % 32;
  const long long head = blockIdx.y;
  const float* w = ws + head * sw_h;
  const long long e0 = tptr[t], e1 = tptr[t + 1];
  float* out;
  long long cstride;
  int heads_in = 1;
  if (t < n_a) {
    out = da + head * sda_h + t * K;
    cstride = kc;
  } else {
    if (head & ((1 << kv_shift) - 1)) return;
    heads_in = 1 << kv_shift;
    out = db + (head >> kv_shift) * sdb_h + (t - n_a) * kc;
    cstride = sdb_c;
  }
  for (int k = lane * 4; k < K; k += 128) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < heads_in; ++r) {
      const float* wr = w + r * sw_h;
#pragma unroll 4
      for (long long e = e0; e < e1; ++e) {
        const float4 x =
            *reinterpret_cast<const float4*>(wr + (long long)src[e] * K + k);
        v.x = __fadd_rn(v.x, x.x);
        v.y = __fadd_rn(v.y, x.y);
        v.z = __fadd_rn(v.z, x.z);
        v.w = __fadd_rn(v.w, x.w);
      }
    }
    float4* d = reinterpret_cast<float4*>(out + (k / kc) * cstride + k % kc);
    if (accumulate) {
      const float4 o = *d;
      v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                      __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
    }
    *d = v;
  }
}

template <int KS, bool kWideA>
int launch_grad(const Args& p, long long n_units, int heads,
                cudaStream_t stream) {
  constexpr int a_bytes = SmemA<kWideA ? 2 * KS : KS>::kBytes;
  constexpr int bytes =
      a_bytes > SmemB<KS>::kBytes ? a_bytes : SmemB<KS>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_grad_kernel<KS, kWideA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)n_units, (unsigned)(p.K / KS), (unsigned)heads);
  tile_grad_kernel<KS, kWideA><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes).  Strides are in elements.  The wrapper
// (ops/tile_dot.py::tile_table_grad) has checked fp32 operands, a (H, M,
// C*kc) and b (H, C, NB, G*kc) contiguous and 16-byte aligned, g (H, F)
// with contiguous rows covering the table, kc a multiple of 16, the table
// and its grad index (units (n_units, 4) int64, the first n_units_a of
// them dA units; walk int32 entry ids; tptr (n_targets + 1,) int64 and
// src int32 partial rows) in range, and the workspace ws (H, rows, K)
// contiguous.  Each returns the launch's cudaGetLastError() code; 0 is
// success.
extern "C" int sddmm_tile_grad_float32(
    const float* a, long long sa_h, long long sa_r, const float* b,
    long long sb_h, long long sb_c, long long sb_r, const float* g,
    long long sg_h, const long long* table, const int* row_ids,
    const int* gids, const long long* units, long long n_units,
    long long n_units_a, const int* walk, float* ws, long long sw_h,
    int heads, int K, int kc, int G, int kv_shift, void* stream) {
  if (n_units <= 0 || heads <= 0) return 0;
  if (n_units > 2147483647LL || heads > 65535 || kc <= 0 || kc % 16 ||
      K % kc || G <= 0 || kv_shift < 0 || kv_shift > 16)
    return (int)cudaErrorInvalidValue;
  const Args p{a, sa_h, sa_r, b, sb_h, sb_c, sb_r, g, sg_h, table,
               row_ids, gids, units, (int)n_units_a, walk, ws, sw_h,
               K, kc, G, kv_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 128 == 0) return launch_grad<64, true>(p, n_units, heads, st);
  if (K % 64 == 0) return launch_grad<64, false>(p, n_units, heads, st);
  if (K % 32 == 0) return launch_grad<32, false>(p, n_units, heads, st);
  return launch_grad<16, false>(p, n_units, heads, st);
}

extern "C" int sddmm_tile_grad_reduce_float32(
    const float* ws, long long sw_h, int K, const long long* tptr,
    const int* src, long long n_a, long long n_targets, float* da,
    long long sda_h, float* db, long long sdb_h, long long sdb_c, int kc,
    int heads, int accumulate, int kv_shift, void* stream) {
  if (n_targets <= 0 || heads <= 0) return 0;
  if (heads > 65535 || kc <= 0 || kc % 4 || K % kc ||
      (n_targets + 7) / 8 > 2147483647LL || kv_shift < 0 || kv_shift > 16 ||
      heads % (1 << kv_shift))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n_targets + 7) / 8), (unsigned)heads);
  tile_grad_reduce_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, sw_h, K, tptr, src, n_a, n_targets, da, sda_h, db, sdb_h, sdb_c,
      kc, accumulate, kv_shift);
  return (int)cudaGetLastError();
}
