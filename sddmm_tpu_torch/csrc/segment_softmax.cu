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
// Design.  One launch for all rows and heads (grid.y = head).  A block of
// 8 warps takes 8 consecutive rows, a warp each: a row of up to 640
// entries (20 a lane) lives in registers, so each entry is read once
// (its inv_idx and its score) and written once; the warp takes the max and
// the sum of the exps with xor-shuffle trees.  A longer row (the global
// token's 4096 entries, a graph hub) is skipped there and is its own block
// (listed in long_rows): 256 threads each keep an online (max, sum) over
// their strided entries, the warps combine them in a fixed tree and then
// in warp order, and a second pass writes.  Every sum is taken in a fixed
// order, with no atomics: the result is deterministic.  An empty row
// writes nothing.
//
// What bounds it.  Bytes: each real score is read once (gathered through
// inv_idx, which is read once a head) and each probability written once;
// the arithmetic is a few operations an entry.
//
// Backward (a second entry point, sddmm_segment_softmax_backward_float32).
// Replaces the VJP that jax.value_and_grad builds of segment_softmax as the
// models apply it: with p the forward's output (H, nnz) in CSR order and g
// its cotangent (H, nnz),
//   d scores[h, inv_idx[e]] = scale * p_e * (g_e - sum_row p * g)
// written straight into the packed gradient (H, F), which the wrapper has
// zeroed, at inv_idx (the transpose of the forward's fused gather: the
// padding slots keep 0), or at e without inv_idx.  The same shape as the
// forward: one launch for all rows and heads, a warp per row of up to 640
// entries (p and g held in registers, each read once), a block per longer
// row (a strided pass for the sum, a second pass that writes).  Sums in a
// fixed order (a lane's entries in order, an xor tree, the warps in
// order): deterministic.  Bytes: p and g read once, one value written per
// entry; a few operations an entry.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPer = 20;  // entries a lane holds: rows up to 32 * kPer
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float score(const float* __restrict__ s,
                                       const int* __restrict__ inv_idx,
                                       long long e, float scale) {
  return scale * s[inv_idx ? (long long)inv_idx[e] : e];
}

// (m, s) := the softmax state of both: max, and the sum of exp(x - max)
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_kernel(const float* __restrict__ scores, long long s_head,
                       const int* __restrict__ inv_idx,
                       const long long* __restrict__ row_ptr, long long m,
                       long long n_row_blocks,
                       const long long* __restrict__ long_rows, float scale,
                       float* __restrict__ out, long long o_head) {
  scores += blockIdx.y * s_head;
  out += blockIdx.y * o_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if ((long long)blockIdx.x < n_row_blocks) {
    const long long r = (long long)blockIdx.x * kWarps + warp;
    if (r >= m) return;
    const long long e0 = row_ptr[r], e1 = row_ptr[r + 1];
    const long long n = e1 - e0;
    if (n <= 0 || n > 32LL * kPer) return;  // empty, or its own block
    float x[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long e = e0 + i * 32 + lane;
      x[i] = -INFINITY;
      if (i * 32 < n && e < e1) x[i] = score(scores, inv_idx, e, scale);
      mx = fmaxf(mx, x[i]);
    }
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i * 32 < n && e0 + i * 32 + lane < e1) {
        x[i] = expf(x[i] - mx);
        sum += x[i];
      }
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long e = e0 + i * 32 + lane;
      if (i * 32 < n && e < e1) out[e] = x[i] / denom;
    }
    return;
  }
  // one long row: an online (max, sum) pass, then a write pass
  __shared__ float part_m[kWarps], part_s[kWarps], total[2];
  const long long r = long_rows[blockIdx.x - n_row_blocks];
  const long long e0 = row_ptr[r], e1 = row_ptr[r + 1];
  float mx = -INFINITY, sum = 0.0f;
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const float v = score(scores, inv_idx, e, scale);
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
    part_m[warp] = mx;
    part_s[warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m_all = part_m[0], s_all = part_s[0];
    for (int w = 1; w < kWarps; ++w) combine(m_all, s_all, part_m[w], part_s[w]);
    total[0] = m_all;
    total[1] = fmaxf(s_all, 1e-30f);
  }
  __syncthreads();
  const float m_all = total[0], denom = total[1];
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x)
    out[e] = expf(score(scores, inv_idx, e, scale) - m_all) / denom;
}

__global__ void __launch_bounds__(kWarps * 32)
segment_softmax_backward_kernel(const float* __restrict__ p, long long p_head,
                                const float* __restrict__ g, long long g_head,
                                const int* __restrict__ inv_idx,
                                const long long* __restrict__ row_ptr,
                                long long m, long long n_row_blocks,
                                const long long* __restrict__ long_rows,
                                float scale, float* __restrict__ out,
                                long long o_head) {
  p += blockIdx.y * p_head;
  g += blockIdx.y * g_head;
  out += blockIdx.y * o_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if ((long long)blockIdx.x < n_row_blocks) {
    const long long r = (long long)blockIdx.x * kWarps + warp;
    if (r >= m) return;
    const long long e0 = row_ptr[r], e1 = row_ptr[r + 1];
    const long long n = e1 - e0;
    if (n <= 0 || n > 32LL * kPer) return;  // empty, or its own block
    float pv[kPer], gv[kPer];
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long e = e0 + i * 32 + lane;
      pv[i] = gv[i] = 0.0f;
      if (i * 32 < n && e < e1) {
        pv[i] = p[e];
        gv[i] = g[e];
        dot = fmaf(pv[i], gv[i], dot);
      }
    }
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long e = e0 + i * 32 + lane;
      if (i * 32 < n && e < e1)
        out[inv_idx ? (long long)inv_idx[e] : e] =
            scale * (pv[i] * (gv[i] - dot));
    }
    return;
  }
  // one long row: a strided pass for sum p * g, then a write pass
  __shared__ float part[kWarps];
  __shared__ float total;
  const long long r = long_rows[blockIdx.x - n_row_blocks];
  const long long e0 = row_ptr[r], e1 = row_ptr[r + 1];
  float dot = 0.0f;
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x)
    dot = fmaf(p[e], g[e], dot);
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
  if (lane == 0) part[warp] = dot;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = part[0];
    for (int w = 1; w < kWarps; ++w) s += part[w];
    total = s;
  }
  __syncthreads();
  const float s = total;
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x)
    out[inv_idx ? (long long)inv_idx[e] : e] = scale * (p[e] * (g[e] - s));
}

}  // namespace

// C interface (ctypes).  The wrapper (ops/softmax.py::segment_softmax_torch)
// has checked shapes, dtypes and devices: scores (heads, *) fp32 with head
// stride s_head and, where inv_idx is null, the entries in CSR order;
// inv_idx (nnz,) int32 or null; row_ptr (m+1,) int64, non-decreasing;
// long_rows (n_long,) int64, every row longer than 640 entries (and no
// other); out (heads, nnz) fp32 with head stride o_head.  Returns the
// launch's cudaGetLastError() code.
extern "C" int sddmm_segment_softmax_float32(
    const float* scores, long long s_head, const int* inv_idx,
    const long long* row_ptr, long long m, const long long* long_rows,
    long long n_long, float scale, float* out, long long o_head, int heads,
    void* stream) {
  if (m <= 0 || heads <= 0) return 0;
  const long long row_blocks = (m + kWarps - 1) / kWarps;
  if (heads > 65535 || row_blocks + n_long > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  segment_softmax_kernel<<<dim3((unsigned)(row_blocks + n_long),
                                (unsigned)heads),
                           kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, s_head, inv_idx, row_ptr, m, row_blocks, long_rows, scale, out,
      o_head);
  return (int)cudaGetLastError();
}

// C interface of the backward (ctypes), checked by the wrapper
// (ops/softmax.py::segment_softmax_backward): p and g (heads, nnz) fp32 in
// CSR order with head strides p_head and g_head; inv_idx (nnz,) int32 or
// null; row_ptr and long_rows as in the forward; out fp32 with head stride
// o_head, (heads, F) and zeroed where inv_idx is given, else (heads, nnz).
// Returns the launch's cudaGetLastError() code.
extern "C" int sddmm_segment_softmax_backward_float32(
    const float* p, long long p_head, const float* g, long long g_head,
    const int* inv_idx, const long long* row_ptr, long long m,
    const long long* long_rows, long long n_long, float scale, float* out,
    long long o_head, int heads, void* stream) {
  if (m <= 0 || heads <= 0) return 0;
  const long long row_blocks = (m + kWarps - 1) / kWarps;
  if (heads > 65535 || row_blocks + n_long > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  segment_softmax_backward_kernel<<<dim3((unsigned)(row_blocks + n_long),
                                         (unsigned)heads),
                                    kWarps * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      p, p_head, g, g_head, inv_idx, row_ptr, m, row_blocks, long_rows,
      scale, out, o_head);
  return (int)cudaGetLastError();
}
