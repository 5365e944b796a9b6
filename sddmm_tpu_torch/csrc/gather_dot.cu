// Gather-dot: one exact fp32 dot per sparse entry, at any gather group size
// G and K-chunk count C, for H heads in one launch.
//
// Replaces the residual block of sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit
// (an XLA take, a one-hot member select and an elementwise multiply + row
// sum there), sddmm_tpu/ops/csr_sddmm.py::csr_sddmm_jax / _csr_sddmm_blocked
// (the same dot with C = G = 1) and its vmapped batch
// (sddmm_tpu/ops/batch.py):
//   out[h, i] = sum_c sum_k a[h, rows[i], c*kc + k]
//                           * bt[h, c, gids[i], member[i]*kc + k]
// a is the padded A (H, M+1, C*kc) with row stride lda and head stride
// a_head, bt the grouped, chunked B^T (H, C, NG+1, G*kc) with chunk stride
// b_chunk, row stride ldb and head stride b_head, out (H, n) with head
// stride o_head.  a and bt are stored as fp32/fp32, fp32/bf16, fp16/fp16
// or bf16/bf16; every product and sum is fp32 (fp16 and bf16 convert
// exactly).  The one-hot select of the JAX program is a direct index here:
// it picks the same values and adds only zeros.
//
// What bounds it.  Counted once, the distinct A rows and B^T rows an entry
// list touches are small (a few MB); every entry needs a K-wide A row and
// B^T row for 2K flops.  So the kernel is bound by the gathered-row reads
// it makes from L2, and by their latency; the design cuts their number.
//
// Design.  Two walks, both one launch for all heads (grid.y), with every
// product and sum in fp32 in a fixed order and no atomics (the result is
// deterministic), the C chunks' sums added in the order c = 0..C-1 (JAX's
// acc = acc + dot(c)).
//
// Planned (a GatherPlan built once per pattern on the host,
// ops/gather_plan.py): rows that share columns go in groups of GR (2, 4, 8
// or 16); a group's items are its distinct B^T rows (keys), each with the
// entry of every row of the group there.  A block of 4 warps takes one task
// (a group, or a run of up to 512 of its items) and stages the group's GR A
// rows in shared memory as fp32 once.  A warp then takes 32 items at a
// time, lane j item j: per slab of 32 columns it copies their B^T slices
// into shared memory with 16-byte loads, so a B^T row shared by the
// group's rows is read from L2 once for all of them, each lane takes its
// slice into registers, and every lane dots it with each A row that some
// item of the 32 holds (a broadcast read): no shuffle, and each A value
// read serves 32 items.
//
// Entry order (no plan, or a plan that found no sharing): a sub-warp of LPI
// lanes (8, 16 or 32: the fewest whose 16-byte loads cover a dot in at most
// two slices a lane; 32 lanes of scalar loads where kc or a stride is not a
// multiple of 8) computes one dot: each lane loads 8 elements of the A row
// and of the B^T slice a slice (fp32: elements t*4 and 4*LPI + t*4 of each
// 8*LPI step, so that neighbouring lanes read neighbouring 16 bytes; 16-bit
// B: 8 elements at t*8), and the sub-warp sums its lanes with an
// xor-shuffle tree.  Each sub-warp walks a run of up to 16 consecutive
// entries in the order given (one entry a sub-warp for a short list, so
// that a small residual is not a chain of dependent loads) and keeps the A
// and B^T slices in registers while
// rows[e] (and gids[e], member[e]) repeat, so a CSR-ordered list reads each
// A row once per run and a list sorted by group row (sort_res="gid") each
// B^T row once per run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kWarps = 4;           // warps per block
constexpr int kRun = 16;            // most entries a sub-warp walks in order
// sub-warps that a short entry list spreads over before runs grow past one
// entry (a run is walked one entry after another)
constexpr long long kRunSpread = 1LL << 15;
constexpr int kCache = 2;           // A/B slices a lane keeps in registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float2 pair(unsigned v, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}
__device__ __forceinline__ float2 pair(unsigned v, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 4 consecutive elements at p (16 bytes of fp32, 8 of fp16/bf16), as fp32
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
template <class T>
__device__ __forceinline__ void load4(const T* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = pair(v.x, T()), hi = pair(v.y, T());
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

// 8 consecutive elements at p (two 16-byte loads of fp32, one of fp16/bf16)
__device__ __forceinline__ void load8(const float* p, float* x) {
  load4(p, x);
  load4(p + 4, x + 4);
}
template <class T>
__device__ __forceinline__ void load8(const T* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const float2 a = pair(v.x, T()), b = pair(v.y, T()), c = pair(v.z, T()),
               d = pair(v.w, T());
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  x[4] = c.x; x[5] = c.y; x[6] = d.x; x[7] = d.y;
}

// Lane t's EPL elements of step `step` of one kc-wide slice starting at p,
// as fp32, zero past kc.  EPL = 8: SPLIT (fp32 B) takes elements
// [t*4, t*4+4) and [4*lpi + t*4, +4) of the step's 8*lpi, else [t*8,
// t*8+8); both A and B of a dot use the B side's mapping.  EPL = 1: element
// step*lpi + t.
template <int EPL, bool SPLIT, class T>
__device__ __forceinline__ void load_lane(const T* p, int step, int t,
                                          int lpi, int kc, float (&x)[EPL]) {
  if constexpr (EPL == 1) {
    const int k = step * lpi + t;
    x[0] = k < kc ? to_float(p[k]) : 0.0f;
  } else if constexpr (SPLIT) {
    const int k0 = step * 8 * lpi + t * 4, k1 = k0 + 4 * lpi;
    if (k0 < kc) {
      load4(p + k0, x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = 0.0f;
    }
    if (k1 < kc) {
      load4(p + k1, x + 4);
    } else {
#pragma unroll
      for (int j = 4; j < 8; ++j) x[j] = 0.0f;
    }
  } else {
    const int k0 = step * 8 * lpi + t * 8;
    if (k0 < kc) {
      load8(p + k0, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.0f;
    }
  }
}

// the sum over the lpi lanes of a sub-warp (aligned at multiples of lpi),
// in a fixed tree order; every lane of the warp calls it
__device__ __forceinline__ float sub_sum(float v, int lpi) {
  for (int o = lpi / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int EPL>
__device__ __forceinline__ float dot_lane(const float (&x)[EPL],
                                          const float (&y)[EPL], float acc) {
#pragma unroll
  for (int j = 0; j < EPL; ++j) acc = fmaf(x[j], y[j], acc);
  return acc;
}

// 4 (VEC = 4) or 1 elements at p as fp32, zero where `ok` is false
template <int VEC, class T>
__device__ __forceinline__ void load_vec(const T* p, bool ok,
                                         float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    if (ok) {
      load4(p, x);
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.0f;
    }
  } else {
    x[0] = ok ? to_float(*p) : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void store_smem(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_smem(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

constexpr int kSlab = 32;  // B^T columns a warp stages per item at a time

// Planned walk.  A block of kWarps warps takes one task: its group's GR A
// rows go to shared memory as fp32 once (rows K + kSlab floats apart, the
// tail zero); then each warp takes batches of 32 items, lane j item j.  Per
// K slab of kSlab columns (inside one chunk), the warp copies its 32 items'
// B^T slices into its shared buffer (16-byte loads, 8 a lane in flight)
// and each lane takes its own slice into registers; then, for each row of
// the group that some item of the batch holds, every lane dots that row
// (broadcast reads of A) with its slice, summing even and odd columns in
// two registers.  No shuffles and no atomics; the order of every sum is
// fixed: a slab's two partial sums, then the slabs of a chunk, then the
// chunks (c = 0..C-1).
template <class TA, class TB, int GR, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
gather_dot_plan_kernel(const TA* __restrict__ a, long long lda,
                       long long a_head, const TB* __restrict__ bt,
                       long long b_chunk, long long ldb, long long b_head,
                       const int* __restrict__ tasks,
                       const int* __restrict__ groups,
                       const int* __restrict__ items, int G,
                       float* __restrict__ out, long long o_head, int C,
                       int kc, int kv_shift) {
  constexpr int kRow = kSlab + VEC;  // a staged B^T slice's stride
  extern __shared__ __align__(16) float smem[];
  __shared__ long long b_off[kWarps][32];
  const int K = C * kc, a_row = K + kSlab;
  float* a_s = smem;                                  // GR x a_row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* b_s = smem + GR * a_row + warp * 32 * kRow;  // 32 x kRow, this warp's
  a += blockIdx.y * a_head;
  bt += (long long)(blockIdx.y >> kv_shift) * b_head;
  out += blockIdx.y * o_head;
  const int* task = tasks + 3LL * blockIdx.x;
  const int g = task[0], i0 = task[1], i1 = task[2];
  const int* grow = groups + (long long)g * (2 + GR) + 2;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < GR * a_row; idx += blockDim.x) {
    const int r = idx / a_row, k = idx - r * a_row;
    const int row = grow[r];
    a_s[idx] = row >= 0 && k < K ? to_float(a[row * lda + k]) : 0.0f;
  }
  __syncthreads();
  for (int base = i0 + warp * 32; base < i1; base += kWarps * 32) {
    const int i = base + lane;
    const bool ok = i < i1;
    const int* rec = items + (long long)i * (1 + GR);
    int key = 0;
    unsigned mine = 0;
    if (ok) {
      key = rec[0];
#pragma unroll
      for (int r = 0; r < GR; ++r) mine |= (rec[1 + r] >= 0 ? 1u : 0u) << r;
    }
    const unsigned any = __reduce_or_sync(kFull, mine);
    const int gid = key / G;
    b_off[warp][lane] =
        ok ? (long long)gid * ldb + (long long)(key - gid * G) * kc : -1LL;
    __syncwarp();
    float part[GR];
    for (int c = 0; c < C; ++c) {
      for (int k0 = 0; k0 < kc; k0 += kSlab) {
        const int width = min(kSlab, kc - k0);
        // stage the 32 items' slices [k0, k0 + width) of chunk c
        constexpr int kParts = kSlab / VEC;
#pragma unroll
        for (int f = lane; f < 32 * kParts; f += 32) {
          const int j = f / kParts, k = (f - j * kParts) * VEC;
          const long long off = b_off[warp][j];
          float x[VEC];
          load_vec<VEC>(bt + c * b_chunk + off + k0 + k,
                        off >= 0 && k < width, x);
          store_smem<VEC>(b_s + j * kRow + k, x);
        }
        __syncwarp();
        float b[kSlab];
#pragma unroll
        for (int k = 0; k < kSlab; k += VEC) {
          float y[VEC];
          load_smem<VEC>(b_s + lane * kRow + k, y);
#pragma unroll
          for (int v = 0; v < VEC; ++v) b[k + v] = y[v];
        }
        __syncwarp();
        const float* a_c = a_s + c * kc + k0;
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          if ((any >> r) & 1u) {  // warp-uniform
            float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
            for (int k = 0; k < kSlab; k += VEC) {
              float x[VEC];
              load_smem<VEC>(a_c + r * a_row + k, x);
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                if ((k + v) % 2 == 0) {
                  s0 = fmaf(x[v], b[k + v], s0);
                } else {
                  s1 = fmaf(x[v], b[k + v], s1);
                }
              }
            }
            part[r] = k0 ? part[r] + (s0 + s1) : s0 + s1;
          }
        }
      }
      // chunk c's sums are added to the entries' totals in order, in the
      // output itself (each entry's slot is this lane's alone)
      if (ok) {
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const int e = rec[1 + r];
          if (e >= 0) out[e] = c ? out[e] + part[r] : part[r];
        }
      }
    }
  }
}

template <class TA, class TB, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
gather_dot_entries_kernel(const TA* __restrict__ a, long long lda,
                          long long a_head, const TB* __restrict__ bt,
                          long long b_chunk, long long ldb, long long b_head,
                          const int* __restrict__ rows,
                          const int* __restrict__ gids,
                          const int* __restrict__ member,
                          float* __restrict__ out, long long o_head,
                          long long n, int C, int kc, int lpi, int run,
                          int kv_shift) {
  constexpr bool SPLIT = sizeof(TB) == 4;
  a += blockIdx.y * a_head;
  bt += (long long)(blockIdx.y >> kv_shift) * b_head;
  out += blockIdx.y * o_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ipw = 32 / lpi, sub = lane / lpi, t = lane % lpi;
  const int steps = (kc + EPL * lpi - 1) / (EPL * lpi);
  const int ns = C * steps;  // slices of a dot
  const long long e0 =
      (((long long)blockIdx.x * kWarps + warp) * ipw + sub) * run;
  float ac[kCache][EPL], bc[kCache][EPL];
#pragma unroll
  for (int q = 0; q < kCache; ++q)
#pragma unroll
    for (int j = 0; j < EPL; ++j) ac[q][j] = bc[q][j] = 0.0f;
  int prow = -1, pgid = -1, pmem = -1;
  // the next entry's ids are loaded while this one is dotted
  int nrow = -1, ngid = -1, nmem = -1;
  if (e0 < n) {
    nrow = rows[e0];
    ngid = gids[e0];
    nmem = member ? member[e0] : 0;
  }
  for (int j = 0; j < run; ++j) {
    const long long e = e0 + j;
    const bool ok = e < n;
    int row = prow, gid = pgid, mem = pmem;
    if (ok) {
      row = nrow;
      gid = ngid;
      mem = nmem;
    }
    if (j + 1 < run && e + 1 < n) {
      nrow = rows[e + 1];
      ngid = gids[e + 1];
      nmem = member ? member[e + 1] : 0;
    }
    const bool new_a = row != prow, new_b = gid != pgid || mem != pmem;
    prow = row;
    pgid = gid;
    pmem = mem;
    const TA* ar = a + (long long)row * lda;
    const TB* br = bt + (long long)gid * ldb + (long long)mem * kc;
    float tot = 0.0f, acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kCache; ++q) {
      if (q < ns) {
        const int c = q / steps, st = q - c * steps;
        if (new_a) load_lane<EPL, SPLIT>(ar + c * kc, st, t, lpi, kc, ac[q]);
        if (new_b)
          load_lane<EPL, SPLIT>(br + c * b_chunk, st, t, lpi, kc, bc[q]);
        acc = dot_lane<EPL>(ac[q], bc[q], acc);
        if (st == steps - 1) {
          const float v = sub_sum(acc, lpi);
          tot = c ? tot + v : v;
          acc = 0.0f;
        }
      }
    }
    for (int q = kCache; q < ns; ++q) {
      // past the cached slices: read again for every entry (zeros past n)
      const int c = q / steps, st = q - c * steps;
      float x[EPL], y[EPL];
      load_lane<EPL, SPLIT>(ar + c * kc, st, t, lpi, ok ? kc : 0, x);
      load_lane<EPL, SPLIT>(br + c * b_chunk, st, t, lpi, ok ? kc : 0, y);
      acc = dot_lane<EPL>(x, y, acc);
      if (st == steps - 1) {
        const float v = sub_sum(acc, lpi);
        tot = c ? tot + v : v;
        acc = 0.0f;
      }
    }
    if (ok && t == 0) out[e] = tot;
  }
}

template <class TA, class TB, int GR, int VEC>
int launch_plan(const TA* a, long long lda, long long a_head, const TB* bt,
                long long b_chunk, long long ldb, long long b_head,
                const int* tasks, long long n_tasks, const int* groups,
                const int* items, int G, float* out, long long o_head,
                int heads, int C, int kc, int kv_shift, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)GR * ((size_t)C * kc + kSlab)
                       + (size_t)kWarps * 32 * (kSlab + VEC));
  auto kernel = gather_dot_plan_kernel<TA, TB, GR, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)n_tasks, (unsigned)heads), kWarps * 32, smem,
           stream>>>(a, lda, a_head, bt, b_chunk, ldb, b_head, tasks, groups,
                     items, G, out, o_head, C, kc, kv_shift);
  return (int)cudaGetLastError();
}

template <class TA, class TB, int VEC>
int launch_group(int group_rows, const TA* a, long long lda, long long a_head,
                 const TB* bt, long long b_chunk, long long ldb,
                 long long b_head, const int* tasks, long long n_tasks,
                 const int* groups, const int* items, int G, float* out,
                 long long o_head, int heads, int C, int kc, int kv_shift,
                 cudaStream_t s) {
#define SDDMM_PLAN_CASE(GR)                                                 \
  case GR:                                                                  \
    return launch_plan<TA, TB, GR, VEC>(a, lda, a_head, bt, b_chunk, ldb,   \
                                        b_head, tasks, n_tasks, groups,     \
                                        items, G, out, o_head, heads, C, kc, \
                                        kv_shift, s);
  switch (group_rows) {
    SDDMM_PLAN_CASE(2)
    SDDMM_PLAN_CASE(4)
    SDDMM_PLAN_CASE(8)
    SDDMM_PLAN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDDMM_PLAN_CASE
}

template <class TA, class TB, int EPL>
int launch_entries(const TA* a, long long lda, long long a_head,
                   const TB* bt, long long b_chunk, long long ldb,
                   long long b_head, const int* rows, const int* gids,
                   const int* member, float* out, long long o_head,
                   long long n, int heads, int C, int kc, int lpi,
                   int kv_shift, cudaStream_t stream) {
  const long long spread = n / kRunSpread;
  const int run = spread >= kRun ? kRun : spread < 1 ? 1 : (int)spread;
  const long long subs = (n + run - 1) / run;
  const long long per_block = (long long)kWarps * (32 / lpi);
  const long long blocks = (subs + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gather_dot_entries_kernel<TA, TB, EPL>
      <<<dim3((unsigned)blocks, (unsigned)heads), kWarps * 32, 0, stream>>>(
          a, lda, a_head, bt, b_chunk, ldb, b_head, rows, gids, member, out,
          o_head, n, C, kc, lpi, run, kv_shift);
  return (int)cudaGetLastError();
}

template <class TA, class TB>
int launch(const void* a_, long long lda, long long a_head, const void* bt_,
           long long b_chunk, long long ldb, long long b_head,
           const int* rows, const int* gids, const int* member,
           const int* tasks, long long n_tasks, const int* groups,
           const int* items, int group_rows, int G, float* out,
           long long o_head, long long n, int heads, int C, int kc, int vec,
           int lpi, int kv_shift, void* stream) {
  const TA* a = static_cast<const TA*>(a_);
  const TB* bt = static_cast<const TB*>(bt_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || heads > 65535 || (vec != 1 && vec != 8) ||
      (lpi != 8 && lpi != 16 && lpi != 32) || (vec == 1 && lpi != 32) ||
      G < 1 || C < 1 || kc < 1 || kv_shift < 0 || kv_shift > 16)
    return (int)cudaErrorInvalidValue;
  if (tasks) {
    // 16-byte staging of 4-element parts where the entry walk may take
    // 8-element loads (kc, the strides and the pointers multiples of 8)
    if (n_tasks <= 0) return 0;
    if (n_tasks > 2147483647LL) return (int)cudaErrorInvalidValue;
    return vec == 8
               ? launch_group<TA, TB, 4>(group_rows, a, lda, a_head, bt,
                                         b_chunk, ldb, b_head, tasks, n_tasks,
                                         groups, items, G, out, o_head, heads,
                                         C, kc, kv_shift, s)
               : launch_group<TA, TB, 1>(group_rows, a, lda, a_head, bt,
                                         b_chunk, ldb, b_head, tasks, n_tasks,
                                         groups, items, G, out, o_head, heads,
                                         C, kc, kv_shift, s);
  }
  if (n <= 0) return 0;
  return vec == 8 ? launch_entries<TA, TB, 8>(a, lda, a_head, bt, b_chunk,
                                              ldb, b_head, rows, gids, member,
                                              out, o_head, n, heads, C, kc,
                                              lpi, kv_shift, s)
                  : launch_entries<TA, TB, 1>(a, lda, a_head, bt, b_chunk,
                                              ldb, b_head, rows, gids, member,
                                              out, o_head, n, heads, C, kc,
                                              lpi, kv_shift, s);
}

}  // namespace

// C interface (ctypes), one entry point per (A storage, B storage) pair of
// the compute modes (ops/tile_dot.py STORAGE: "tf32" and "float32",
// "mixed", "float16", "bfloat16").  Other pairs are cast to one of these by
// the caller.  Strides are in elements.  With tasks non-null the kernel
// walks the plan (ops/gather_plan.py GatherPlan: tasks (n_tasks, 3), groups
// (NG, 2 + group_rows), items (I, 1 + group_rows), int32) and ignores rows,
// gids and member; else it walks the n entries in order (member null means
// G = 1).  vec is 8 (16-byte loads: kc, the strides and the pointers
// multiples of 8 elements / 16 bytes) or 1; lpi the lanes of a dot (8, 16
// or 32; 32 at vec 1; at least group_rows).  The wrapper
// (ops/hybrid.py::residual_gather_dot) has checked shapes and dtypes; the
// caller guarantees the index ranges.  Returns the launch's
// cudaGetLastError() code.  Head h reads the B^T of head h >> kv_shift (0:
// its own; grouped-query attention's query heads share a key head in place).
#define SDDMM_GATHER_DOT(NAME, TA, TB)                                        \
  extern "C" int sddmm_gather_dot_##NAME(                                     \
      const void* a, long long lda, long long a_head, const void* bt,         \
      long long b_chunk, long long ldb, long long b_head, const int* rows,    \
      const int* gids, const int* member, const int* tasks,                   \
      long long n_tasks, const int* groups, const int* items,                 \
      int group_rows, int G, float* out, long long o_head, long long n,       \
      int heads, int C, int kc, int vec, int lpi, int kv_shift,               \
      void* stream) {                                                         \
    return launch<TA, TB>(a, lda, a_head, bt, b_chunk, ldb, b_head, rows,     \
                          gids, member, tasks, n_tasks, groups, items,        \
                          group_rows, G, out, o_head, n, heads, C, kc, vec,   \
                          lpi, kv_shift, stream);                             \
  }

SDDMM_GATHER_DOT(float32_float32, float, float)
SDDMM_GATHER_DOT(float32_bfloat16, float, __nv_bfloat16)
SDDMM_GATHER_DOT(float16_float16, __half, __half)
SDDMM_GATHER_DOT(bfloat16_bfloat16, __nv_bfloat16, __nv_bfloat16)
