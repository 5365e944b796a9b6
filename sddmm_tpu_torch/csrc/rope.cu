// Rotary position embedding (RoPE) on the first R dimensions of the query
// and key heads, forward and backward, for grouped-query attention layers
// such as MiMo-V2-Flash's.
//
// Replaces no TPU kernel: the JAX package's attention applies no position
// encoding.  What it computes, for a head's row i (its position) and
// d < R/2, with (c, s) = table[i, d] = (cos, sin) of i * theta^(-2d/R):
//   forward   y_d = x_d c - x_{d+R/2} s,   y_{d+R/2} = x_{d+R/2} c + x_d s
//   backward  y_d = x_d c + x_{d+R/2} s,   y_{d+R/2} = x_{d+R/2} c - x_d s
// (the backward is the transpose: the rotation by -i * omega_d), the "rotate
// half" pairing; dimensions R..D-1 and rows past `rows` (the sentinel row of
// q_pad and k_pad) are copied where out is not in.  Each product and the sum
// are rounded apart (no fused multiply-add), as the plain version's torch
// ops are.  The table is built once, in float64, and rounded to fp32: fp32
// angles i * omega at i = 4095 would err by 2.4e-4.
//
// One launch takes both tensors: x (heads, rows_pad, D) with head and row
// strides, a warp a (tensor, head, row), a lane a pair of dimensions (and
// then the copied ones).  Bound by bytes: each element read and written once.

#include <cuda_runtime.h>

namespace {

struct Part {
  const float* in;
  float* out;
  long long s_h, s_r;  // strides of in and out, which share a layout
  int heads;
};

__global__ void __launch_bounds__(256)
rope_kernel(Part q, Part k, const float2* __restrict__ table, int rows,
            int rows_pad, int D, int R, int inverse) {
  const long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long per_head = rows_pad;
  const long long nq = (long long)q.heads * per_head;
  const long long total = nq + (long long)k.heads * per_head;
  if (w >= total) return;
  const Part& p = w < nq ? q : k;
  const long long v = w < nq ? w : w - nq;
  const long long h = v / per_head, i = v - h * per_head;
  const float* x = p.in + h * p.s_h + i * p.s_r;
  float* y = p.out + h * p.s_h + i * p.s_r;
  const int half = R / 2;
  const bool rotate = i < rows;
  for (int d = lane; d < half; d += 32) {
    const float a = x[d], b = x[d + half];
    if (!rotate) {
      y[d] = a;
      y[d + half] = b;
      continue;
    }
    const float2 cs = table[i * half + d];
    const float sa = __fmul_rn(a, cs.y), sb = __fmul_rn(b, cs.y);
    const float ca = __fmul_rn(a, cs.x), cb = __fmul_rn(b, cs.x);
    y[d] = inverse ? __fadd_rn(ca, sb) : __fsub_rn(ca, sb);
    y[d + half] = inverse ? __fsub_rn(cb, sa) : __fadd_rn(cb, sa);
  }
  if (p.out != p.in)
    for (int d = R + lane; d < D; d += 32) y[d] = x[d];
}

}  // namespace

// C interface (ctypes).  The wrapper (ops/rope.py) has checked fp32 tensors
// q (hq, rows_pad, D) and k (hk, rows_pad, D) with contiguous rows, their
// outputs in the same layout (the same pointers for in place), the table
// (rows, R/2) float2, R even and at most D, rows <= rows_pad.  inverse: the
// backward.  Returns the launch's cudaGetLastError() code.
extern "C" int sddmm_rope_float32(const float* q_in, float* q_out,
                                  long long q_sh, long long q_sr, int hq,
                                  const float* k_in, float* k_out,
                                  long long k_sh, long long k_sr, int hk,
                                  const float* table, int rows, int rows_pad,
                                  int D, int R, int inverse, void* stream) {
  const long long warps = ((long long)hq + hk) * rows_pad;
  if (warps <= 0 || R <= 0) return 0;
  if (R % 2 || R > D || rows > rows_pad || (warps + 7) / 8 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Part q{q_in, q_out, q_sh, q_sr, hq};
  const Part k{k_in, k_out, k_sh, k_sr, hk};
  rope_kernel<<<(unsigned)((warps + 7) / 8), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      q, k, reinterpret_cast<const float2*>(table), rows, rows_pad, D, R,
      inverse);
  return (int)cudaGetLastError();
}
