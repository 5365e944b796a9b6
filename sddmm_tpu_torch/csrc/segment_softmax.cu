// Segment softmax: the row softmax of the attention models' scaled scores,
// read straight from the hybrid runner's packed flat vector.
//
// Replaces sddmm_tpu/models/graph_attention.py::segment_softmax (segment
// max, exp, segment sum and a divide there, XLA programs), as the models
// apply it to scale * scores (graph_attention.py:79-82,
// block_sparse_attention.py:117, :126), together with the gather into CSR
// order that feeds it in the port (sddmm_tpu/ops/hybrid.py:329-340,
// flat[inv_idx]):
//   x_e = scale * scores[h, inv_idx[e]]          (scores[h, e] without it)
//   out[h, e] = exp(x_e - max_row x) / max(sum_row exp(x - max_row x), 1e-30)
// for e in [row_ptr[r], row_ptr[r+1]); scores (H, F) fp32 with head stride
// s_head, inv_idx (nnz,) int32, row_ptr (m+1,) int64, out (H, nnz) fp32
// with head stride o_head.  So neither the CSR-order copy of the scores nor
// the scaled copy is ever written.  expf (not __expf); the divide is IEEE.
//
// What bounds it.  Bytes: each real score is read once (gathered through
// inv_idx), inv_idx and row_ptr once, each probability written once; a
// few operations an entry.
//
// Design.  One launch for all rows and all heads; the grid runs over rows
// and groups of heads (grid.y), and a row's group walks the heads of its
// group at the head stride.  The rows come in a plan built once per
// pattern (ops/softmax.py::softmax_plan), by length:
//   short rows (<= 128 entries, the graph's 86 on average): a group of 8
//     lanes, four rows a warp;
//   rows up to 640 entries: a warp;
//   rows up to 4096 entries (a causal mask's rows, a global token's): a
//     thread block, 16 entries a thread in registers, each read once;
//     its max and sum by the warps' xor trees and then the 8 warps in
//     order, two barriers a head.  A block takes a row for a group of
//     `block_heads` heads of its grid.y group (ops/softmax.py::
//     block_head_group), so a long row's heads spread over several
//     blocks; the plan puts the longest rows first;
//   longer rows (a graph hub's 200,000): split over a thread block
//     cluster of 8 blocks, one piece each; each block's (max, sum) is
//     combined with the others' through distributed shared memory, every
//     block taking the 8 in rank order, so no block walks a hub row alone
//     and no second launch is needed.  Only a plan with split rows is
//     launched as clusters (cudaLaunchKernelEx with a cluster dimension);
//     the others take a plain launch, their grid not rounded to whole
//     clusters.
// A cluster walks its row's heads with two cluster barriers and a second
// read of the scores a head: at 641-4096 entries (MiMo's full causal
// layer) that ran at 10 % of the byte bound, where the block's one read
// into registers needs neither (PERF.md §6).
// The forward's lane holds its entries' scores in registers, each read
// once; a warp's lanes take consecutive entries, so its loads of inv_idx
// and its stores are whole 128-byte lines and the gathers through inv_idx
// stay as coalesced as the packing allows; it reads inv_idx again for each
// head (holding it, or taking 16-byte chunks of 4 entries a lane, made the
// Longformer forward 1.4-2.5x slower on the card: 120-208 registers, and
// gathers 4x less coalesced; a block row's 16 a thread held took the
// kernel from 48 to 80 registers, its warp rows 26 % and its block rows
// 6 % slower; PERF.md §6).  The backward's lane takes
// 16-byte chunks: p and g load as float4, and its entries' inv_idx (int4)
// stay in registers for every head of its group.  A forward's group walks
// every head, a backward's half of them (ops/softmax.py::head_group, the
// fastest on the card).
// Every sum is taken in a fixed order (a lane's entries in order, an xor
// tree, a block's warps in order, a cluster's blocks in rank order), with
// no atomics: the result is deterministic.  An empty row writes nothing.
// The block rows' order in PyTorch ops: ops/softmax.py::block_softmax_plain
// and block_softmax_backward_plain.
//
// Backward (a second entry point, sddmm_segment_softmax_backward_float32).
// Replaces the VJP that jax.value_and_grad builds of segment_softmax as the
// models apply it: with p the forward's output (H, nnz) in CSR order and g
// its cotangent (H, nnz),
//   d scores[h, inv_idx[e]] = scale * p_e * (g_e - sum_row p * g)
// written straight into the packed gradient (H, F), which the wrapper has
// zeroed, at inv_idx (the transpose of the forward's fused gather: the
// padding slots keep 0), or at e without inv_idx.  The same plan and the
// same shape as the forward: a lane's p and g in registers, the row sum of
// p * g by the same fixed trees (a block row's in one pass, a cluster for
// a split row in two), the writes at inv_idx.
// Bytes: p and g read once, one value written per entry.
//
// Sink (both entry points; none where the pointers are null: an instance
// of its own, so that the plain softmax keeps its registers).  A learned
// logit b_h a head (MiMo-V2-Flash's sliding-window layers) joins every row
// of head h as one more entry with no value:
//   m = max(max_row x, b_h),  Z = sum_row exp(x - m) + exp(b_h - m),
//   out_e = exp(x_e - m) / Z,  p_sink[h, r] = exp(b_h - m) / Z,
// the sink's term added after the row's sum.  The forward writes p_sink
// (heads, m); the backward's entries are unchanged (the sink carries no
// value, so d x = p * (g - sum_row p * g) still), and it writes each row's
// share of the sink's gradient, d_rows[h, r] = -p_sink[h, r] * sum_row p *
// g, which the wrapper sums over the rows in a fixed order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSubLanes = 8;     // a short row's group
constexpr int kSubSlots = 128;   // entries a short row's group takes
constexpr int kWarpSlots = 640;  // entries a warp takes
// the backward's 4-entry chunks a lane: room for the slots and a partial
// first chunk's 3
constexpr int kSubChunks = (kSubSlots + 3 + 4 * kSubLanes - 1) /
                           (4 * kSubLanes);
constexpr int kWarpChunks = (kWarpSlots + 3 + 4 * 32 - 1) / (4 * 32);
constexpr int kBlockSlots = kThreads * 16;  // entries a block row takes
constexpr int kBlockChunks = (kBlockSlots + 3 + 4 * kThreads - 1) /
                             (4 * kThreads);
constexpr int kCluster = 8;      // blocks a split row
constexpr int kSubRows = kWarps * (32 / kSubLanes);  // short rows a block

// (m, s) := the softmax state of both: max, and the sum of exp(x - max)
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// The block's part of a split row: [a, b) of [e0, e1), 8 blocks in rank
// order each taking ceil(n / 8) entries.
__device__ __forceinline__ void piece(long long e0, long long e1, int rank,
                                      long long& a, long long& b) {
  const long long ps = (e1 - e0 + kCluster - 1) / kCluster;
  a = min(e0 + rank * ps, e1);
  b = min(a + ps, e1);
}

// A row's plan: the rows of each class, in one int64 array, and where a
// block finds its work.
struct Plan {
  const long long* rows;
  long long n_sub, n_warp, n_block, n_split;
};

// blocks a block row takes in a grid.y group of head_group heads: one for
// each block_heads of them
__host__ __device__ __forceinline__ int block_groups(int head_group,
                                                    int block_heads) {
  return (head_group + block_heads - 1) / block_heads;
}

// The rows' sink (null logit: none): the logits (heads,), the forward's
// p_sink (heads, m) and the backward's d_rows (heads, m), m rows a head
struct Sink {
  const float* logit;
  float* p;          // forward: written; backward: null
  const float* p_in; // backward: the forward's p_sink
  float* d_rows;     // backward: written
  long long m;
};

// The sum of v over a group of G lanes, by an xor tree.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, G);
  return v;
}

// The max and the sum over a row's G lanes: an xor tree for a group of a
// warp or less; for a block (G = kThreads), each warp's tree, then every
// thread reads the warps' results in order, after a barrier.  Each head
// uses one of two buffers by its parity: the buffer a head writes was
// last read before the previous head's barrier.
template <int G>
__device__ __forceinline__ float row_max(float v, int parity) {
  constexpr int W = G < 32 ? G : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o, W));
  if constexpr (G > 32) {
    __shared__ float part[2][kWarps];
    if (threadIdx.x % 32 == 0) part[parity][threadIdx.x / 32] = v;
    __syncthreads();
    v = part[parity][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, part[parity][w]);
  }
  return v;
}

template <int G>
__device__ __forceinline__ float row_sum(float v, int parity) {
  v = group_sum<G < 32 ? G : 32>(v);
  if constexpr (G > 32) {
    __shared__ float part[2][kWarps];
    if (threadIdx.x % 32 == 0) part[parity][threadIdx.x / 32] = v;
    __syncthreads();
    v = part[parity][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += part[parity][w];
  }
  return v;
}

// The forward of one row for heads [h0, h1), by a group of G lanes (the
// whole warp, or for G = kThreads the whole block, calls it together; an
// empty row [e0, e0) writes nothing): lane `lane` takes entries e0 + i * G
// + lane (i < C), so a warp's loads and stores take consecutive entries;
// its scores in registers, each read once; the group's max and sum by
// row_max and row_sum.
template <int G, int C, bool kSink>
__device__ void softmax_row(const float* __restrict__ scores,
                            long long s_head, const int* __restrict__ inv_idx,
                            long long e0, long long e1, float scale,
                            float* __restrict__ out, long long o_head,
                            int h0, int h1, int lane, const Sink& sink,
                            long long r) {
  const int n = (int)(e1 - e0);
  for (int h = h0; h < h1; ++h) {
    const float* sh = scores + h * s_head;
    float* oh = out + h * o_head;
    float x[C];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int k = i * G + lane;
      x[i] = -INFINITY;
      if (i * G < n && k < n) {
        const long long e = e0 + k;
        x[i] = scale * sh[inv_idx ? (long long)inv_idx[e] : e];
      }
      mx = fmaxf(mx, x[i]);
    }
    mx = row_max<G>(mx, h & 1);
    float b = -INFINITY;
    if constexpr (kSink) {
      b = sink.logit[h];
      mx = fmaxf(mx, b);
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i * G < n && i * G + lane < n) {
        x[i] = expf(x[i] - mx);
        sum += x[i];
      }
    }
    sum = row_sum<G>(sum, h & 1);
    if constexpr (kSink) sum += expf(b - mx);
    const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int k = i * G + lane;
      if (i * G < n && k < n) oh[e0 + k] = x[i] / denom;
    }
    if constexpr (kSink)
      if (n > 0 && lane == 0) sink.p[h * sink.m + r] = expf(b - mx) / denom;
  }
}

// The backward's chunks: a lane's entries are whole 4-entry chunks
// aligned to 16 bytes (the row's first and last may be partial), so p and
// g load as float4, and a lane keeps its entries' inv_idx (loaded as int4)
// in registers for every head of its group.
__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The inv_idx of a row's entries in its chunks, read once.
template <int G, int C>
__device__ __forceinline__ void load_index(const int* __restrict__ inv_idx,
                                           long long e0, long long e1,
                                           int lane, int (&ix)[C][4]) {
  const long long base = e0 & ~3LL;
  const bool vec = aligned16(inv_idx);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const long long eb = base + 4LL * (i * G + lane);
    if (vec && eb >= e0 && eb + 4 <= e1) {
      const int4 v = *reinterpret_cast<const int4*>(inv_idx + eb);
      ix[i][0] = v.x;
      ix[i][1] = v.y;
      ix[i][2] = v.z;
      ix[i][3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long e = eb + c;
        ix[i][c] = (e >= e0 && e < e1) ? inv_idx[e] : 0;
      }
    }
  }
}

// The backward of one row for heads [h0, h1), by a group of G lanes (a
// block for G = kThreads), chunk i * G + lane of the row's chunks from
// e0 & ~3 a lane's i-th: p and g in registers, each read once, the row sum
// of p * g by row_sum, written at inv_idx.
template <int G, int C, bool kSink>
__device__ void softmax_bwd_row(const float* __restrict__ p, long long p_head,
                                const float* __restrict__ g, long long g_head,
                                const int* __restrict__ inv_idx, long long e0,
                                long long e1, float scale,
                                float* __restrict__ out, long long o_head,
                                int h0, int h1, int lane, const Sink& sink,
                                long long r) {
  const long long base = e0 & ~3LL;
  int ix[C][4];
  if (inv_idx) load_index<G, C>(inv_idx, e0, e1, lane, ix);
  for (int h = h0; h < h1; ++h) {
    const float* ph = p + h * p_head;
    const float* gh = g + h * g_head;
    float* oh = out + h * o_head;
    const bool vec_in = aligned16(ph) && aligned16(gh);
    float pv[C][4], gv[C][4];
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const long long eb = base + 4LL * (i * G + lane);
      if (vec_in && eb >= e0 && eb + 4 <= e1) {
        const float4 a = *reinterpret_cast<const float4*>(ph + eb);
        const float4 b = *reinterpret_cast<const float4*>(gh + eb);
        pv[i][0] = a.x;
        pv[i][1] = a.y;
        pv[i][2] = a.z;
        pv[i][3] = a.w;
        gv[i][0] = b.x;
        gv[i][1] = b.y;
        gv[i][2] = b.z;
        gv[i][3] = b.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long e = eb + c;
          const bool in = e >= e0 && e < e1;
          pv[i][c] = in ? ph[e] : 0.0f;
          gv[i][c] = in ? gh[e] : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) dot = fmaf(pv[i][c], gv[i][c], dot);
    }
    dot = row_sum<G>(dot, h & 1);
    if constexpr (kSink)
      if (e1 > e0 && lane == 0)
        sink.d_rows[h * sink.m + r] = -sink.p_in[h * sink.m + r] * dot;
    const bool vec_out = !inv_idx && aligned16(oh);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const long long eb = base + 4LL * (i * G + lane);
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] = scale * (pv[i][c] * (gv[i][c] - dot));
      if (vec_out && eb >= e0 && eb + 4 <= e1) {
        *reinterpret_cast<float4*>(oh + eb) = make_float4(d[0], d[1], d[2],
                                                          d[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long e = eb + c;
          if (e >= e0 && e < e1) oh[inv_idx ? (long long)ix[i][c] : e] = d[c];
        }
      }
    }
  }
}

// The short rows' and the warp rows' passes of one block: kSubLanes lanes
// and kSubSlots / kSubLanes entries a lane for a short row, 32 lanes and
// kWarpSlots / 32 for a warp row.
template <bool kSink>
__device__ void forward_rows(const float* __restrict__ scores,
                             long long s_head, const int* __restrict__ inv_idx,
                             const long long* __restrict__ row_ptr,
                             const Plan& plan, long long b,
                             long long sub_blocks, float scale,
                             float* __restrict__ out, long long o_head,
                             int h0, int h1, const Sink& sink) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (b < sub_blocks) {  // short rows: a group of 8 lanes each
    const long long k = b * kSubRows + warp * (32 / kSubLanes) +
                        lane / kSubLanes;
    long long e0 = 0, e1 = 0, r = 0;
    if (k < plan.n_sub) {
      r = plan.rows[k];
      e0 = row_ptr[r];
      e1 = row_ptr[r + 1];
    }
    softmax_row<kSubLanes, kSubSlots / kSubLanes, kSink>(
        scores, s_head, inv_idx, e0, e1, scale, out, o_head, h0, h1,
        lane % kSubLanes, sink, r);
    return;
  }
  const long long k = (b - sub_blocks) * kWarps + warp;
  if (k >= plan.n_warp) return;  // the whole warp
  const long long r = plan.rows[plan.n_sub + k];
  softmax_row<32, kWarpSlots / 32, kSink>(
      scores, s_head, inv_idx, row_ptr[r], row_ptr[r + 1], scale, out, o_head,
      h0, h1, lane, sink, r);
}

template <bool kSink>
__device__ void backward_rows(const float* __restrict__ p, long long p_head,
                              const float* __restrict__ g, long long g_head,
                              const int* __restrict__ inv_idx,
                              const long long* __restrict__ row_ptr,
                              const Plan& plan, long long b,
                              long long sub_blocks, float scale,
                              float* __restrict__ out, long long o_head,
                              int h0, int h1, const Sink& sink) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (b < sub_blocks) {
    const long long k = b * kSubRows + warp * (32 / kSubLanes) +
                        lane / kSubLanes;
    long long e0 = 0, e1 = 0, r = 0;
    if (k < plan.n_sub) {
      r = plan.rows[k];
      e0 = row_ptr[r];
      e1 = row_ptr[r + 1];
    }
    softmax_bwd_row<kSubLanes, kSubChunks, kSink>(
        p, p_head, g, g_head, inv_idx, e0, e1, scale, out, o_head, h0, h1,
        lane % kSubLanes, sink, r);
    return;
  }
  const long long k = (b - sub_blocks) * kWarps + warp;
  if (k >= plan.n_warp) return;
  const long long r = plan.rows[plan.n_sub + k];
  softmax_bwd_row<32, kWarpChunks, kSink>(
      p, p_head, g, g_head, inv_idx, row_ptr[r], row_ptr[r + 1], scale, out,
      o_head, h0, h1, lane, sink, r);
}

// A block row's block: the k-th of the plan's block rows for heads [g0,
// g1) of its grid.y group [h0, h1), from b, its index among the block
// rows' blocks (block_groups of them a row).
struct BlockTask {
  long long r;
  int g0, g1;
};

__device__ __forceinline__ BlockTask block_task(const Plan& plan, long long b,
                                                int h0, int h1,
                                                int head_group,
                                                int block_heads) {
  const int per_row = block_groups(head_group, block_heads);
  const int g0 = h0 + (int)(b % per_row) * block_heads;
  return {plan.rows[plan.n_sub + plan.n_warp + b / per_row], g0,
          min(h1, g0 + block_heads)};
}

template <bool kSink>
__global__ void __launch_bounds__(kThreads)
segment_softmax_kernel(const float* __restrict__ scores, long long s_head,
                       const int* __restrict__ inv_idx,
                       const long long* __restrict__ row_ptr, Plan plan,
                       float scale, float* __restrict__ out, long long o_head,
                       int heads, int head_group, int block_heads,
                       Sink sink) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.y * head_group, h1 = min(heads, h0 + head_group);
  const long long split_blocks = plan.n_split * kCluster;
  const long long block_blocks =
      plan.n_block * block_groups(head_group, block_heads);
  const long long sub_blocks = (plan.n_sub + kSubRows - 1) / kSubRows;
  const long long bx = blockIdx.x;
  if (bx >= split_blocks + block_blocks) {
    forward_rows<kSink>(scores, s_head, inv_idx, row_ptr, plan,
                        bx - split_blocks - block_blocks, sub_blocks, scale,
                        out, o_head, h0, h1, sink);
    return;
  }
  if (bx >= split_blocks) {  // a block row
    const BlockTask t = block_task(plan, bx - split_blocks, h0, h1,
                                   head_group, block_heads);
    softmax_row<kThreads, kBlockSlots / kThreads, kSink>(
        scores, s_head, inv_idx, row_ptr[t.r], row_ptr[t.r + 1], scale, out,
        o_head, t.g0, t.g1, threadIdx.x, sink, t.r);
    return;
  }
  // a split row over the cluster
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float part[2][2];  // this block's (max, sum), by head parity
  __shared__ float wm[kWarps], ws[kWarps], total[2];
  const int rank = (int)cluster.block_rank();
  const long long r =
      plan.rows[plan.n_sub + plan.n_warp + plan.n_block + bx / kCluster];
  long long a, b;
  piece(row_ptr[r], row_ptr[r + 1], rank, a, b);
  for (int h = h0; h < h1; ++h) {
    const float* sh = scores + h * s_head;
    float* oh = out + h * o_head;
    float mx = -INFINITY, sum = 0.0f;
    for (long long e = a + threadIdx.x; e < b; e += kThreads) {
      const float v = scale * sh[inv_idx ? (long long)inv_idx[e] : e];
      if (v > mx) {
        sum = sum * expf(mx - v) + 1.0f;
        mx = v;
      } else {
        sum += expf(v - mx);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, mx, o);
      const float s2 = __shfl_xor_sync(kFull, sum, o);
      combine(mx, sum, m2, s2);
    }
    if (lane == 0) {
      wm[warp] = mx;
      ws[warp] = sum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float m_b = wm[0], s_b = ws[0];
      for (int w = 1; w < kWarps; ++w) combine(m_b, s_b, wm[w], ws[w]);
      part[h & 1][0] = m_b;
      part[h & 1][1] = s_b;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
      float m_all = -INFINITY, s_all = 0.0f;
      for (int k = 0; k < kCluster; ++k) {
        const float* rp = cluster.map_shared_rank(&part[h & 1][0], k);
        combine(m_all, s_all, rp[0], rp[1]);
      }
      if constexpr (kSink) {
        combine(m_all, s_all, sink.logit[h], 1.0f);
        if (rank == 0)
          sink.p[h * sink.m + r] =
              expf(sink.logit[h] - m_all) / fmaxf(s_all, 1e-30f);
      }
      total[0] = m_all;
      total[1] = fmaxf(s_all, 1e-30f);
    }
    __syncthreads();
    const float m_all = total[0], denom = total[1];
    for (long long e = a + threadIdx.x; e < b; e += kThreads)
      oh[e] = expf(scale * sh[inv_idx ? (long long)inv_idx[e] : e] - m_all) /
              denom;
  }
  cluster.sync();  // no block leaves while another reads its part
}

template <bool kSink>
__global__ void __launch_bounds__(kThreads)
segment_softmax_backward_kernel(const float* __restrict__ p, long long p_head,
                                const float* __restrict__ g, long long g_head,
                                const int* __restrict__ inv_idx,
                                const long long* __restrict__ row_ptr,
                                Plan plan, float scale,
                                float* __restrict__ out, long long o_head,
                                int heads, int head_group, int block_heads,
                                Sink sink) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.y * head_group, h1 = min(heads, h0 + head_group);
  const long long split_blocks = plan.n_split * kCluster;
  const long long block_blocks =
      plan.n_block * block_groups(head_group, block_heads);
  const long long sub_blocks = (plan.n_sub + kSubRows - 1) / kSubRows;
  const long long bx = blockIdx.x;
  if (bx >= split_blocks + block_blocks) {
    backward_rows<kSink>(p, p_head, g, g_head, inv_idx, row_ptr, plan,
                         bx - split_blocks - block_blocks, sub_blocks, scale,
                         out, o_head, h0, h1, sink);
    return;
  }
  if (bx >= split_blocks) {  // a block row
    const BlockTask t = block_task(plan, bx - split_blocks, h0, h1,
                                   head_group, block_heads);
    softmax_bwd_row<kThreads, kBlockChunks, kSink>(
        p, p_head, g, g_head, inv_idx, row_ptr[t.r], row_ptr[t.r + 1], scale,
        out, o_head, t.g0, t.g1, threadIdx.x, sink, t.r);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float part[2];
  __shared__ float wsum[kWarps];
  __shared__ float total;
  const int rank = (int)cluster.block_rank();
  const long long r =
      plan.rows[plan.n_sub + plan.n_warp + plan.n_block + bx / kCluster];
  long long a, b;
  piece(row_ptr[r], row_ptr[r + 1], rank, a, b);
  for (int h = h0; h < h1; ++h) {
    const float* ph = p + h * p_head;
    const float* gh = g + h * g_head;
    float* oh = out + h * o_head;
    float dot = 0.0f;
    for (long long e = a + threadIdx.x; e < b; e += kThreads)
      dot = fmaf(ph[e], gh[e], dot);
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
    if (lane == 0) wsum[warp] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = wsum[0];
      for (int w = 1; w < kWarps; ++w) s += wsum[w];
      part[h & 1] = s;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int k = 0; k < kCluster; ++k)
        s += *cluster.map_shared_rank(&part[h & 1], k);
      total = s;
      if constexpr (kSink)
        if (rank == 0)
          sink.d_rows[h * sink.m + r] = -sink.p_in[h * sink.m + r] * s;
    }
    __syncthreads();
    const float s = total;
    for (long long e = a + threadIdx.x; e < b; e += kThreads)
      oh[inv_idx ? (long long)inv_idx[e] : e] = scale * (ph[e] * (gh[e] - s));
  }
  cluster.sync();
}

// blocks of a launch over the plan: a cluster a split row, block_groups
// blocks a block row, then the short rows' and the other rows' blocks,
// rounded up to whole clusters where there are split rows; -1 if the grid
// is too large
long long plan_blocks(const Plan& plan, int head_group, int block_heads) {
  const long long blocks =
      plan.n_split * kCluster +
      plan.n_block * block_groups(head_group, block_heads) +
      (plan.n_sub + kSubRows - 1) / kSubRows +
      (plan.n_warp + kWarps - 1) / kWarps;
  const long long whole = plan.n_split
                              ? (blocks + kCluster - 1) / kCluster * kCluster
                              : blocks;
  return whole > 2147483647LL ? -1 : whole;
}

// Launches `kernel` over the plan's grid: as clusters of kCluster blocks
// where the plan has split rows, else a plain launch.  Returns the
// launch's error code (cudaErrorInvalidValue for a grid over 2^31 - 1
// blocks or over 65535 groups of heads, or a count or a group below 1),
// the error state cleared.
template <typename... Params, typename... Args>
int launch_plan(void (*kernel)(Params...), const Plan& plan, int heads,
                int head_group, int block_heads, void* stream,
                Args... args) {
  if (plan.n_sub < 0 || plan.n_warp < 0 || plan.n_block < 0 ||
      plan.n_split < 0 || head_group < 1 || block_heads < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = plan_blocks(plan, head_group, block_heads);
  const int groups = (heads + head_group - 1) / head_group;
  if (blocks < 0 || groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!plan.n_split) {
    kernel<<<grid, kThreads, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// C interface (ctypes).  The wrapper (ops/softmax.py::softmax_launch) has
// checked shapes, dtypes and devices: scores (heads, *) fp32 with head
// stride s_head and, where inv_idx is null, the entries in CSR order;
// inv_idx (nnz,) int32 or null; row_ptr (m+1,) int64, non-decreasing;
// plan_rows int64, the plan's short rows (n_sub, 1..128 entries), then the
// rows of 129..640 entries (n_warp), then those of 641..4096 (n_block),
// then the longer rows (n_split), every non-empty row once; out (heads,
// nnz) fp32 with head stride o_head; head_group the heads a row's group
// walks (grid.y: their groups), block_heads the heads of its group a block
// row's block takes; sink (heads,) fp32 or null, and then p_sink (heads,
// m) fp32 written (see Sink).  Returns launch_plan's error code.
extern "C" int sddmm_segment_softmax_float32(
    const float* scores, long long s_head, const int* inv_idx,
    const long long* row_ptr, const long long* plan_rows, long long n_sub,
    long long n_warp, long long n_block, long long n_split, float scale,
    float* out, long long o_head, int heads, int head_group, int block_heads,
    const float* sink, float* p_sink, long long m, void* stream) {
  if (heads <= 0 || n_sub + n_warp + n_block + n_split <= 0) return 0;
  const Plan plan{plan_rows, n_sub, n_warp, n_block, n_split};
  return launch_plan(sink ? segment_softmax_kernel<true>
                          : segment_softmax_kernel<false>,
                     plan, heads, head_group, block_heads, stream, scores,
                     s_head, inv_idx, row_ptr, plan, scale, out, o_head,
                     heads, head_group, block_heads,
                     Sink{sink, p_sink, nullptr, nullptr, m});
}

// C interface of the backward (ctypes), checked by the wrapper
// (ops/softmax.py::softmax_launch): p and g (heads, nnz) fp32 in CSR order
// with head strides p_head and g_head; inv_idx (nnz,) int32 or null;
// row_ptr and the plan as in the forward; out fp32 with head stride
// o_head, (heads, F) and zeroed where inv_idx is given, else (heads, nnz);
// p_sink (heads, m) the forward's, or null, and then d_rows (heads, m)
// written.  Returns launch_plan's error code.
extern "C" int sddmm_segment_softmax_backward_float32(
    const float* p, long long p_head, const float* g, long long g_head,
    const int* inv_idx, const long long* row_ptr, const long long* plan_rows,
    long long n_sub, long long n_warp, long long n_block, long long n_split,
    float scale, float* out, long long o_head, int heads, int head_group,
    int block_heads, const float* p_sink, float* d_rows, long long m,
    void* stream) {
  if (heads <= 0 || n_sub + n_warp + n_block + n_split <= 0) return 0;
  const Plan plan{plan_rows, n_sub, n_warp, n_block, n_split};
  return launch_plan(d_rows ? segment_softmax_backward_kernel<true>
                            : segment_softmax_backward_kernel<false>,
                     plan, heads, head_group, block_heads, stream, p, p_head,
                     g, g_head, inv_idx, row_ptr, plan, scale, out, o_head,
                     heads, head_group, block_heads,
                     Sink{nullptr, nullptr, p_sink, d_rows, m});
}
