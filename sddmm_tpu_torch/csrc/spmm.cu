// CSR SpMM: out = S . dense for a CSR pattern S with per-entry values.
//
// Replaces sddmm_tpu/ops/spmm.py::csr_spmm_jax (an XLA take of the dense
// rows, a scale by the values and a segment_sum into rows there), the
// aggregation step of the attention models:
//   out[r, k] = sum_{e in [row_ptr[r], row_ptr[r+1])} values[e] * dense[cols[e], k]
// row_ptr (m+1,) int64, cols (nnz,) int32 and values (nnz,) fp32 are the
// CSR; dense (N, K) fp32 with row stride ldd; out (m, K) fp32 with row
// stride ldo.  Each product is rounded to fp32 and added in fp32 (no fused
// multiply-add), as the plain version's multiply and index_add_ do.
//
// Batches.  One launch runs H x C products over the one pattern (grid.z =
// h * C + c): batch (h, c) reads values + h*vs_h, dense + h*ds_h + c*ds_c
// and writes out + h*os_h + c*os_c.  The backward passes use it so: the
// heads of a model, and the C chunks of the hybrid op's K, where a chunk
// writes kc of dA's K columns (ldo = K, os_c = kc) and the chunks share
// their head's values -- the VJPs of the hybrid op
// (sddmm_tpu/ops/hybrid.py::_hybrid_packed_jit), of csr_sddmm_jax and of
// csr_spmm_jax are SpMMs over the pattern or its transpose.
//
// Heads of grouped-query attention.  Output head o sums S input heads (S
// = sum_heads, 1 but for grouped gradients): input head i = o * S + r,
// r = 0..S-1 in that order, reads values + i*vs_h and the dense operand of
// head i >> kv_shift.  So query heads read their group's V in place
// (kv_shift = log2 of the group, S = 1), and V's gradient sums the group's
// query heads (S = the group, kv_shift = 0) with no copy a head.
//
// Value index.  With vidx (nnz,) int32 given, entry e's value is
// values[vidx[e]] (within its head's row): a backward passes the packed
// cotangent as it is and the pattern's entry -> slot map, so the values
// are never copied into CSR order (without vidx, values[e]).
//
// Design.  The kernels walk a plan built once on the host from the pattern
// (ops/spmm.py::spmm_plan).  Neighbouring rows of attention and graph
// patterns share most of their columns (a sliding window, a row cluster),
// and each shared column is a dense row read again.
//
// Panels.  Where 64 consecutive rows of the plan's order (a panel) have
// many entries for each distinct column they hold (a band, a causal
// triangle: 40-64 entries a column), the plan gives them to
// csr_spmm_kernel_panel: one block a panel, output head and 64-column
// slice of K walks the panel's distinct columns in ascending chunks of 32,
// double-buffered: each chunk column's dense row slice is copied once into
// shared memory (cp.async), and the panel rows' values there are staged
// beside it (read through vidx where one is given, a row's entries in the
// chunk being consecutive in CSR order and marked by a 32-bit mask).  Each
// thread then holds a 4-row x 4-column tile of sums and takes each staged
// dense value once for its 4 rows, so a dense row is read from L2 once per
// panel where the row groups read it once per 4 rows.  A row's product
// with a chunk column it does not hold is skipped (predicated), not
// multiplied by zero: a non-finite dense value outside a row's pattern
// never reaches it.  With kSum the block walks the chunks once per input
// head, the input head outermost.  The panels come heaviest first, and
// the grid runs every head and slice of a panel before the next panel.
// The plan's other rows (row groups and long rows) run in the same grid,
// ahead of the panels (group_block), so that they overlap the panels'
// work: a launch is one kernel either way.
//
// Row groups.  The plan's other rows are taken
// in groups of up to GR rows, 2 or 4 as the plan chose (consecutive in a
// row order the caller may give, e.g. the SDDMM packing's row clustering),
// and a group is one list of "items": each distinct column of the group
// (ascending) with the entry of each of its rows there, or -1.  One warp
// walks one group's items and reads each dense row once for the whole
// group, where a walk per row reads it once per row.  Where a group's rows
// share too little, the plan leaves them as groups of one row, which walk
// their CSR entries (no items).  A block of 8 warps takes 8 groups.  A row
// longer than SPMM_LONG_ROW entries is its own task: the block's 8 warps
// walk 8 contiguous pieces of it, and the partial sums meet in shared
// memory and are added in piece order 0..7 by one warp.
//
// A warp walks 32 items (or entries) at a time: one load per lane brings
// an item's column and entry ids, and the values are gathered, both ahead
// of use (the next batch's values and the one after's items are in flight
// while a batch is used), and __shfl_sync hands each to every lane.  The
// lanes then issue the dense-row loads of 16 / GR items (8 entries on a
// lone or long row) before they consume any, so that many row reads are in
// flight per warp, and a lane's sums and loads in flight take the same
// registers at either GR.  Each lane holds VEC consecutive columns (float4
// at K > 64, float2 at K > 32), so a warp covers 32 * VEC columns of a row
// per load, and grid.y covers K.
//
// Order of the sums.  A row's products are added in fp32 in the order of
// its items (ascending column, the CSR order of a column-sorted pattern),
// a panel row's in ascending column (its CSR order: the plan takes only
// rows whose columns strictly ascend), or for a long row per piece in
// entry order and then the 8 pieces in order.  So a row gets the same sum
// bit for bit in a panel, a group or alone.  No atomics: the result is
// deterministic.  The order differs from
// the plain version's index_add_: the sum of n fp32 terms moves by up to
// about sqrt(n) * 2^-24 of the sum of their magnitudes, inside the 1e-5
// the kernel is held to against its plain version.  An empty row writes
// zeros.
//
// What bounds it.  Counted once, the inputs and the output are small (the
// dense rows are 8-13 MB on the models), but every item reads a K-wide
// dense row (4K bytes) for 2K flops per entry: the gathered row reads are
// served by L2 and L1, so the row groups' rate is the L2 read rate they
// reach times the reads the groups save.  A panel reads each dense row
// slice once for up to 64 rows, so its bound is the fp32 issue rate of
// the products (a multiply and an add each, no fused multiply-add), over
// the share of its rows x columns that hold an entry.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kAhead = 8;  // dense-row loads in flight per lane on entries
constexpr unsigned kFull = 0xffffffffu;
// the panel path: rows a panel, distinct columns a chunk, K columns a
// block (ops/spmm.py SPMM_PANEL_ROWS, SPMM_PANEL_COLS); its blocks also
// run row groups, so they have the row groups' warps
constexpr int kPanelRows = 64;
constexpr int kChunkCols = 32;
constexpr int kSliceK = 64;
constexpr int kPanelThreads = kWarpsPerBlock * 32;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  const typename Vec<VEC>::T v =
      __ldg(reinterpret_cast<const typename Vec<VEC>::T*>(p));
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = f[i];
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  typename Vec<VEC>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = x[i];
  *reinterpret_cast<typename Vec<VEC>::T*>(p) = v;
}

// a compile-time flag, for a generic lambda's argument
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// copy BYTES (4, 8 or 16) from global to shared memory without waiting
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// entry e's value: values[vidx[e]], or values[e] without an index
__device__ __forceinline__ float value_of(const float* __restrict__ values,
                                          const int* __restrict__ vidx,
                                          long long e) {
  return values[vidx ? (long long)vidx[e] : e];
}

// acc += sum over entries [e0, e1) of values[e] * dense[cols[e], k..k+VEC),
// in entry order; every lane of the warp calls it with the same range
template <int VEC>
__device__ __forceinline__ void walk_entries(
    long long e0, long long e1, const int* __restrict__ cols,
    const float* __restrict__ values, const int* __restrict__ vidx,
    const float* __restrict__ dense, long long ldd, int k, bool active,
    int lane, float (&acc)[VEC]) {
  int c = 0;
  float v = 0.0f;
  if (e0 + lane < e1) {
    c = cols[e0 + lane];
    v = value_of(values, vidx, e0 + lane);
  }
  for (long long base = e0; base < e1; base += 32) {
    const int n = (int)min(32LL, e1 - base);
    int c_next = 0;
    float v_next = 0.0f;
    if (base + 32 + lane < e1) {
      c_next = cols[base + 32 + lane];
      v_next = value_of(values, vidx, base + 32 + lane);
    }
    for (int j = 0; j < n; j += kAhead) {
      float x[kAhead][VEC];
      float w[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int cu = __shfl_sync(kFull, c, j + u);
        w[u] = __shfl_sync(kFull, v, j + u);
        if (active && j + u < n) {
          load_vec<VEC>(dense + (long long)cu * ldd + k, x[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j + u < n) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(w[u], x[u][i]));
        }
      }
    }
    c = c_next;
    v = v_next;
  }
}

// One lane's item as stored (1 + GR int32): its column and the entry of
// each group row
template <int GR>
struct RawItem {
  int col;
  int e[GR];
};

// One lane's item ready to use: its column, and per row of the group its
// value, with bit r of mask set where row r has an entry there
template <int GR>
struct Item {
  int col;
  unsigned mask;
  float v[GR];
};

template <int GR>
__device__ __forceinline__ RawItem<GR> load_raw(
    const int* __restrict__ items, long long i, bool ok) {
  RawItem<GR> it;
  it.col = 0;
#pragma unroll
  for (int r = 0; r < GR; ++r) it.e[r] = -1;
  if (ok) {
    const int* p = items + i * (1 + GR);
    it.col = p[0];
#pragma unroll
    for (int r = 0; r < GR; ++r) it.e[r] = p[1 + r];
  }
  return it;
}

template <int GR>
__device__ __forceinline__ Item<GR> gather_values(
    const RawItem<GR>& raw, const float* __restrict__ values,
    const int* __restrict__ vidx) {
  Item<GR> it;
  it.col = raw.col;
  it.mask = 0;
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    it.v[r] = 0.0f;
    if (raw.e[r] >= 0) {
      it.v[r] = value_of(values, vidx, raw.e[r]);
      it.mask |= 1u << r;
    }
  }
  return it;
}

// acc[r] += the group's row r over items [i0, i1), each dense row read once.
// The items are a two-deep pipeline: while a batch of 32 is used, the next
// batch's values are gathered (its items came one batch earlier) and the
// batch after that's items are loaded, so neither load waits on the other.
template <int VEC, int GR>
__device__ __forceinline__ void walk_items(
    long long i0, long long i1, const int* __restrict__ items,
    const float* __restrict__ values, const int* __restrict__ vidx,
    const float* __restrict__ dense, long long ldd, int k, bool active,
    int lane, float (&acc)[GR][VEC]) {
  constexpr int kAheadItems = 16 / GR;
  Item<GR> it = gather_values<GR>(
      load_raw<GR>(items, i0 + lane, i0 + lane < i1), values, vidx);
  RawItem<GR> raw_next =
      load_raw<GR>(items, i0 + 32 + lane, i0 + 32 + lane < i1);
  for (long long base = i0; base < i1; base += 32) {
    const int n = (int)min(32LL, i1 - base);
    const RawItem<GR> raw_after =
        load_raw<GR>(items, base + 64 + lane, base + 64 + lane < i1);
    const Item<GR> next = gather_values<GR>(raw_next, values, vidx);
    for (int j = 0; j < n; j += kAheadItems) {
      float x[kAheadItems][VEC];
#pragma unroll
      for (int u = 0; u < kAheadItems; ++u) {
        const int cu = __shfl_sync(kFull, it.col, j + u);
        if (active && j + u < n) {
          load_vec<VEC>(dense + (long long)cu * ldd + k, x[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kAheadItems; ++u) {
        const unsigned mask = __shfl_sync(kFull, it.mask, j + u);
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const float w = __shfl_sync(kFull, it.v[r], j + u);
          if (j + u < n && ((mask >> r) & 1u)) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(w, x[u][i]));
          }
        }
      }
    }
    it = next;
    raw_next = raw_after;
  }
}

// One block of row groups: task bx, K slice by (32 * VEC columns), batch bz;
// part: the block's shared memory for a long row's pieces.  kSum: output
// heads sum sum_heads input heads (an instance of its own, so that the
// one-head path keeps its code)
template <int VEC, int GR, bool kSum>
__device__ __forceinline__ void group_block(
    unsigned bx, unsigned by, unsigned bz, const long long* __restrict__ tasks,
    const long long* __restrict__ groups, const int* __restrict__ items,
    const long long* __restrict__ row_ptr, const int* __restrict__ cols,
    const float* __restrict__ values, const int* __restrict__ vidx,
    long long vs_h, const float* __restrict__ dense, long long ldd,
    long long ds_h, long long ds_c, float* __restrict__ out, long long ldo,
    long long os_h, long long os_c, int K, int C, int sum_heads, int kv_shift,
    float (*part)[32 * VEC]) {
  // output head h; without kSum its one input head h, whose dense rows are
  // those of head h >> kv_shift
  const long long h = bz / C, c = bz - h * C;
  if constexpr (kSum) {
    dense += c * ds_c;
  } else {
    values += h * vs_h;
    dense += (h >> kv_shift) * ds_h + c * ds_c;
  }
  out += h * os_h + c * os_c;
  // input head i = h * sum_heads + r of an output head's sum (kSum)
  auto values_of = [&](int r) {
    return values + (h * sum_heads + r) * vs_h;
  };
  auto dense_of = [&](int r) {
    return dense + ((h * sum_heads + r) >> kv_shift) * ds_h;
  };
  const long long first = tasks[2 * (long long)bx];
  const long long count = tasks[2 * (long long)bx + 1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k = by * 32 * VEC + lane * VEC;
  const bool active = k < K;
  if (count > 0) {
    // up to 8 row groups, one per warp
    if (warp >= count) return;
    const long long* g = groups + (2 + GR) * (first + warp);
    float acc[GR][VEC];
#pragma unroll
    for (int r = 0; r < GR; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] = 0.0f;
    if constexpr (kSum) {
      for (int r = 0; r < sum_heads; ++r) {
        if (g[3] < 0) {
          walk_entries<VEC>(row_ptr[g[2]], row_ptr[g[2] + 1], cols,
                            values_of(r), vidx, dense_of(r), ldd, k, active,
                            lane, acc[0]);
        } else {
          walk_items<VEC, GR>(g[0], g[1], items, values_of(r), vidx,
                              dense_of(r), ldd, k, active, lane, acc);
        }
      }
    } else if (g[3] < 0) {
      // a group of one row walks its CSR entries: no items
      walk_entries<VEC>(row_ptr[g[2]], row_ptr[g[2] + 1], cols, values,
                        vidx, dense, ldd, k, active, lane, acc[0]);
    } else {
      walk_items<VEC, GR>(g[0], g[1], items, values, vidx, dense, ldd, k,
                          active, lane, acc);
    }
    if (!active) return;
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const long long row = g[2 + r];
      if (row >= 0) store_vec<VEC>(out + row * ldo + k, acc[r]);
    }
    return;
  }
  // one long row: warp w walks piece w, then the pieces add up in order
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  const long long e0 = row_ptr[first], e1 = row_ptr[first + 1];
  const long long piece = (e1 - e0 + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long p0 = min(e1, e0 + warp * piece);
  if constexpr (kSum) {
    for (int r = 0; r < sum_heads; ++r)
      walk_entries<VEC>(p0, min(e1, p0 + piece), cols, values_of(r), vidx,
                        dense_of(r), ldd, k, active, lane, acc);
  } else {
    walk_entries<VEC>(p0, min(e1, p0 + piece), cols, values, vidx, dense,
                      ldd, k, active, lane, acc);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[warp][lane * VEC + i] = acc[i];
  __syncthreads();
  if (warp != 0 || !active) return;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float s = part[0][lane * VEC + i];
    for (int w = 1; w < kWarpsPerBlock; ++w)
      s = __fadd_rn(s, part[w][lane * VEC + i]);
    acc[i] = s;
  }
  store_vec<VEC>(out + first * ldo + k, acc);
}

// The row groups alone (a plan without panels)
template <int VEC, int GR, bool kSum>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const long long* __restrict__ tasks,
                const long long* __restrict__ groups,
                const int* __restrict__ items,
                const long long* __restrict__ row_ptr,
                const int* __restrict__ cols, const float* __restrict__ values,
                const int* __restrict__ vidx, long long vs_h,
                const float* __restrict__ dense, long long ldd, long long ds_h,
                long long ds_c, float* __restrict__ out, long long ldo,
                long long os_h, long long os_c, int K, int C, int sum_heads,
                int kv_shift) {
  __shared__ float part[kWarpsPerBlock][32 * VEC];
  group_block<VEC, GR, kSum>(blockIdx.x, blockIdx.y, blockIdx.z, tasks,
                             groups, items, row_ptr, cols, values, vidx,
                             vs_h, dense, ldd, ds_h, ds_c, out, ldo, os_h,
                             os_c, K, C, sum_heads, kv_shift, part);
}

// The panels and, in the same grid, the plan's other rows: blocks below
// n_group_blocks run the row groups' task (b / (batches * gslices)), batch
// and K slice of 32 * VEC columns (group_block); the rest each the panel of
// b / (batches * slices), batch (h, c) and K slice of 64 columns: its rows'
// sums over every chunk of the panel (and, with kSum, every input head of
// output head h).  VEC: floats a copy or store (K, the strides and the
// pointers are multiples of it).
template <int VEC, int GR, bool kSum>
__global__ void __launch_bounds__(kPanelThreads, 3)
csr_spmm_kernel_panel(const long long* __restrict__ panels,
                      const long long* __restrict__ panel_rows,
                      const int* __restrict__ chunk_cols,
                      const int* __restrict__ chunk_masks,
                      const int* __restrict__ chunk_before,
                      const long long* __restrict__ tasks,
                      long long n_group_blocks, int gslices,
                      const long long* __restrict__ groups,
                      const int* __restrict__ items,
                      const long long* __restrict__ row_ptr,
                      const int* __restrict__ cols,
                      const float* __restrict__ values,
                      const int* __restrict__ vidx, long long vs_h,
                      const float* __restrict__ dense, long long ldd,
                      long long ds_h, long long ds_c,
                      float* __restrict__ out, long long ldo, long long os_h,
                      long long os_c, int K, int C, long long batches,
                      int slices, int sum_heads, int kv_shift) {
  // two buffers: a chunk's dense row slices, its values by column and
  // row, and each row's mask of the chunk's columns
  __shared__ __align__(16) float ds[2][kChunkCols][kSliceK];
  __shared__ __align__(16) float vs[2][kChunkCols][kPanelRows];
  __shared__ __align__(16) unsigned ms[2][kPanelRows];
  long long b = blockIdx.x;
  if (b < n_group_blocks) {
    __shared__ float part[kWarpsPerBlock][32 * VEC];
    const unsigned by = (unsigned)(b % gslices);
    b /= gslices;
    group_block<VEC, GR, kSum>((unsigned)(b / batches), by,
                               (unsigned)(b % batches), tasks, groups, items,
                               row_ptr, cols, values, vidx, vs_h, dense, ldd,
                               ds_h, ds_c, out, ldo, os_h, os_c, K, C,
                               sum_heads, kv_shift, part);
    return;
  }
  b -= n_group_blocks;
  // the buffers as the staging lambdas see them
  float(*const ds_p)[kChunkCols][kSliceK] = ds;
  float(*const vs_p)[kChunkCols][kPanelRows] = vs;
  unsigned(*const ms_p)[kPanelRows] = ms;
  const int kb = (int)(b % slices) * kSliceK;
  b /= slices;
  const long long batch = b % batches, panel = b / batches;
  const long long h = batch / C, c = batch - h * C;
  dense += c * ds_c;
  out += h * os_h + c * os_c;
  const long long ch0 = panels[2 * panel];
  const int n_ch = (int)(panels[2 * panel + 1] - ch0);
  const long long* rows = panel_rows + panel * kPanelRows;
  const int t = threadIdx.x;
  // staging: row sr's values at chunk columns [8 sq, 8 sq + 8); the dense
  // row slice of chunk column dc, slice columns [8 dp, 8 dp + 8)
  const int sr = t % kPanelRows, sq = t / kPanelRows;
  const int dc = t / 8, dp = t % 8;
  const long long srow = rows[sr];
  const long long sstart = srow >= 0 ? row_ptr[srow] : 0;
  // sums: panel rows [4 rg, 4 rg + 4), slice columns [4 kg, 4 kg + 4)
  const int kg = t % 16, rg = t / 16;
  // the steps: chunk ch of input head h * sum_heads + s (kSum; else h),
  // the chunks innermost.  A step's index data, this thread's share: its
  // dense column, its staging row's mask and entries before the chunk
  struct Idx {
    int col;
    unsigned m;
    int before;
  };
  auto load_idx = [&](int ch) {
    const long long c = ch0 + ch;
    return Idx{chunk_cols[c * kChunkCols + dc],
               (unsigned)chunk_masks[c * kPanelRows + sr],
               chunk_before[c * kPanelRows + sr]};
  };
  auto head_of = [&](int s) { return kSum ? h * sum_heads + s : h; };
  auto stage_dense = [&](int s, int col, int buf) {
    if (col < 0) return;
    const float* src = dense + (head_of(s) >> kv_shift) * ds_h +
                       (long long)col * ldd + kb + 8 * dp;
#pragma unroll
    for (int u = 0; u < 8; u += VEC)
      if (kb + 8 * dp + u < K)
        cp_async<4 * VEC>(&ds_p[buf][dc][8 * dp + u], src + u);
  };
  // the positions in a head's values of the staging row's entries at chunk
  // columns [8 sq, 8 sq + 8) (-1 where it has none): through vidx, a load
  auto positions = [&](const Idx& x, int (&pos)[8]) {
    const long long e0 = sstart + x.before;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = 8 * sq + j;
      const long long e = e0 + __popc(x.m & ((1u << cc) - 1u));
      pos[j] = -1;
      if ((x.m >> cc) & 1u) pos[j] = vidx ? vidx[e] : (int)e;
    }
  };
  auto load_values = [&](int s, const int (&pos)[8], float (&v)[8]) {
    const float* vals = values + head_of(s) * vs_h;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = pos[j] >= 0 ? vals[pos[j]] : 0.0f;
  };
  auto store_values = [&](int buf, unsigned m, const float (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) vs_p[buf][8 * sq + j][sr] = v[j];
    if (sq == 0) ms_p[buf][sr] = m;
  };
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
  // acc += the staged chunk's columns [c0, c0 + 16) in buffer buf, each
  // row's where its mask has them (Full: every row has every column)
  auto sums = [&](int buf, const unsigned (&mr)[4], int c0, auto full) {
#pragma unroll
    for (int cc = c0; cc < c0 + 16; ++cc) {
      const float4 d4 = *reinterpret_cast<const float4*>(&ds_p[buf][cc][4 * kg]);
      const float4 w4 = *reinterpret_cast<const float4*>(&vs_p[buf][cc][4 * rg]);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (decltype(full)::value || ((mr[r] >> cc) & 1u)) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(w[r], d[i]));
        }
      }
    }
  };
  const int heads = kSum ? sum_heads : 1;
  // step 0 staged; nxt: the next step's index data, loaded a step ahead
  Idx nxt;
  {
    const Idx x = load_idx(0);
    int pos[8];
    float v[8];
    stage_dense(0, x.col, 0);
    cp_async_commit();
    positions(x, pos);
    load_values(0, pos, v);
    store_values(0, x.m, v);
    nxt = load_idx(n_ch > 1 ? 1 : 0);
    cp_async_wait_all();
    __syncthreads();
  }
  // (s1, ch1): the step after the one summed in this turn
  int s1 = 0, ch1 = 0;
  for (int buf = 0;; buf ^= 1) {
    if (++ch1 == n_ch) {
      ch1 = 0;
      ++s1;
    }
    const bool more = s1 < heads;
    // the index data of the step after that (a chunk's, whatever the head)
    const Idx nxt2 = load_idx(ch1 + 1 == n_ch ? 0 : ch1 + 1);
    // the next step's copies, then its value positions (through vidx) and
    // values, are in flight during this one's sums
    int pos[8];
    float v[8];
    if (more) {
      stage_dense(s1, nxt.col, buf ^ 1);
      cp_async_commit();
      positions(nxt, pos);
      if (!vidx) load_values(s1, pos, v);
    }
    const uint4 mk = *reinterpret_cast<const uint4*>(&ms_p[buf][4 * rg]);
    const unsigned mr[4] = {mk.x, mk.y, mk.z, mk.w};
    const bool any = mk.x | mk.y | mk.z | mk.w;
    // a chunk that every row of the warp holds whole needs no masks
    const bool full = __all_sync(kFull, (mk.x & mk.y & mk.z & mk.w) == kFull);
    if (full) {
      sums(buf, mr, 0, Flag<true>{});
    } else if (any) {
      sums(buf, mr, 0, Flag<false>{});
    }
    // through vidx the positions had the first half's sums to arrive
    if (more && vidx) load_values(s1, pos, v);
    if (full) {
      sums(buf, mr, 16, Flag<true>{});
    } else if (any) {
      sums(buf, mr, 16, Flag<false>{});
    }
    if (!more) break;
    store_values(buf ^ 1, nxt.m, v);
    nxt = nxt2;
    cp_async_wait_all();
    __syncthreads();
  }
  const int k = kb + 4 * kg;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = rows[4 * rg + r];
    if (row < 0) continue;
#pragma unroll
    for (int i = 0; i < 4; i += VEC) {
      if (k + i >= K) break;
      float x[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) x[u] = acc[r][i + u];
      store_vec<VEC>(out + row * ldo + k + i, x);
    }
  }
}

// The arguments of one launch, as the wrapper passes them
struct Args {
  const long long* tasks;
  long long n_tasks;
  const long long* groups;
  const int* items;
  const long long* row_ptr;
  const int* cols;
  const float* values;
  const int* vidx;
  long long vs_h;
  const float* dense;
  long long ldd, ds_h, ds_c;
  float* out;
  long long ldo, os_h, os_c;
  int K, heads, C, sum_heads, kv_shift;
  const long long* panels;
  long long n_panels;
  const long long* panel_rows;
  const int* chunk_cols;
  const int* chunk_masks;
  const int* chunk_before;
};

template <int VEC, int GR, bool kSum>
int launch(const Args& a, cudaStream_t stream) {
  const long long slices = (a.K + 32 * VEC - 1) / (32 * VEC);
  const long long batches = (long long)a.heads * a.C;
  if (a.n_tasks > 2147483647LL || slices > 65535 || batches > 65535)
    return (int)cudaErrorInvalidValue;
  csr_spmm_kernel<VEC, GR, kSum>
      <<<dim3((unsigned)a.n_tasks, (unsigned)slices, (unsigned)batches),
         kWarpsPerBlock * 32, 0, stream>>>(
          a.tasks, a.groups, a.items, a.row_ptr, a.cols, a.values, a.vidx,
          a.vs_h, a.dense, a.ldd, a.ds_h, a.ds_c, a.out, a.ldo, a.os_h,
          a.os_c, a.K, a.C, a.sum_heads, a.kv_shift);
  return (int)cudaGetLastError();
}

template <int VEC, int GR, bool kSum>
int launch_panels(const Args& a, cudaStream_t stream) {
  const long long slices = (a.K + kSliceK - 1) / kSliceK;
  const long long gslices = (a.K + 32 * VEC - 1) / (32 * VEC);
  const long long batches = (long long)a.heads * a.C;
  const long long group_blocks = a.n_tasks * batches * gslices;
  const long long blocks = group_blocks + a.n_panels * batches * slices;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  csr_spmm_kernel_panel<VEC, GR, kSum>
      <<<(unsigned)blocks, kPanelThreads, 0, stream>>>(
          a.panels, a.panel_rows, a.chunk_cols, a.chunk_masks,
          a.chunk_before, a.tasks, group_blocks, (int)gslices, a.groups,
          a.items, a.row_ptr, a.cols, a.values, a.vidx, a.vs_h, a.dense,
          a.ldd, a.ds_h, a.ds_c, a.out, a.ldo, a.os_h, a.os_c, a.K, a.C,
          batches, (int)slices, a.sum_heads, a.kv_shift);
  return (int)cudaGetLastError();
}

// One launch: the panels' kernel with the row groups in its grid where
// the plan has panels, else the row groups' kernel
template <int GR, bool kSum>
int launch_vec(int vec, int panel_vec, const Args& a, cudaStream_t s) {
  if (a.n_panels > 0) {
    switch (panel_vec) {
      case 1:
        return launch_panels<1, GR, kSum>(a, s);
      case 2:
        return launch_panels<2, GR, kSum>(a, s);
      case 4:
        return launch_panels<4, GR, kSum>(a, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (vec) {
    case 1:
      return launch<1, GR, kSum>(a, s);
    case 2:
      return launch<2, GR, kSum>(a, s);
    case 4:
      return launch<4, GR, kSum>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (ctypes).  The wrapper (ops/spmm.py::spmm_launch) has
// checked shapes, dtypes and contiguity and passes spmm_plan's arrays.
// The panels: panels (n_panels, 2) int64 [first chunk, end chunk];
// panel_rows (n_panels, 64) int64, -1 past its rows; per chunk, chunk_cols
// (32) int32 its columns ascending, -1 past them, chunk_masks (64) int32
// bit j set where the panel's row holds column j, chunk_before (64) int32
// the row's entries in earlier chunks.  The row groups, for the group size
// group_rows (GR, 2 or 4): tasks (n_tasks, 2) int64 [first group, group
// count 1..8] or [row, 0] for one long row; groups (n_groups, 2 + GR)
// int64 [first item, end item, then its 1..GR rows, -1 past them; a group
// of one row has no items]; items (n_items, 1 + GR) int32 [column, entry
// of each row or -1].  Together they cover every row once.  vidx (nnz,)
// int32 or null (the value index above).  heads x C batches (the strides
// above, in elements; heads the output heads, each summing sum_heads
// input heads, with kv_shift, as above).  It chose vec (1, 2 or 4) for the
// row groups and panel_vec for the panels with K, every row, head and
// chunk stride of dense and out, and both pointers multiples of it; the
// caller guarantees that row_ptr is non-decreasing and the column ids in
// range.  One kernel on the stream: csr_spmm_kernel_panel where the plan
// has panels, else csr_spmm_kernel.  Returns the launch's
// cudaGetLastError() code.
extern "C" int sddmm_csr_spmm_float32(
    const long long* tasks, long long n_tasks, const long long* groups,
    const int* items, int group_rows, const long long* row_ptr,
    const int* cols, const float* values, const int* vidx, long long vs_h,
    const float* dense, long long ldd, long long ds_h, long long ds_c,
    float* out, long long ldo, long long os_h, long long os_c, int K,
    int heads, int C, int sum_heads, int kv_shift, int vec,
    const long long* panels, long long n_panels, const long long* panel_rows,
    const int* chunk_cols, const int* chunk_masks, const int* chunk_before,
    int panel_vec, void* stream) {
  if ((n_tasks <= 0 && n_panels <= 0) || K <= 0 || heads <= 0 || C <= 0)
    return 0;
  if (sum_heads < 1 || kv_shift < 0 || kv_shift > 16)
    return (int)cudaErrorInvalidValue;
  const Args a{tasks, n_tasks, groups, items, row_ptr,   cols,
               values, vidx,  vs_h,   dense, ldd,       ds_h,
               ds_c,  out,    ldo,    os_h,  os_c,      K,
               heads, C,      sum_heads, kv_shift, panels, n_panels,
               panel_rows, chunk_cols, chunk_masks, chunk_before};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sum = sum_heads > 1;
  if (group_rows == 2)
    return sum ? launch_vec<2, true>(vec, panel_vec, a, s)
               : launch_vec<2, false>(vec, panel_vec, a, s);
  if (group_rows == 4)
    return sum ? launch_vec<4, true>(vec, panel_vec, a, s)
               : launch_vec<4, false>(vec, panel_vec, a, s);
  return (int)cudaErrorInvalidValue;
}
