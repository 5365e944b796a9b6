// Device row clustering: one round of BSMR's multi-leader row clustering.
//
// Replaces sddmm_tpu/reorder/device_cluster.py::_round_step (an XLA
// program there, :51-128), which computes rows._batched_cluster's round:
// the first L live rows in dispersion order are the leader candidates;
// each is dropped into the first earlier accepted leader it is similar to,
// else accepted; then every live row joins the first accepted leader it is
// similar to.  Similarity of L1-normalised encodings x, y is the weighted
// Jaccard min_sum / ((|x| + |y|) - min_sum), in fp32.
//
// The rows live in dispersion order here (position p is the p-th row of
// the order): ptr (n+1,) int64 over the row's occupied column blocks, idx
// int32 block ids and hat fp32 values, hsum (n,) fp32 the row sums of hat.
// cluster (n,) int32 is -1 while a row is live, else its cluster id.
// state int32[5] carries the round's scalars on the card: clusters so far,
// live rows, the first live position, the accepted leaders of the round
// and the round's first cluster id.  lead (nb, ld) fp32 holds the accepted
// leaders' dense hats, leader a in column a, zero elsewhere; acc_pos (ld,)
// their positions.
//
// Design.  JAX densifies every row to (m, B) and contracts every row
// against every leader over all B blocks each round.  Here a row's min-sum
// against a leader is a sum over the row's own occupied blocks (about 8 at
// the probe size, against B = 2048), reading the leader's hat from the
// (B, L) table, which is L2-resident (256 KB at B = 2048, L = 32).  Lane a
// of a warp takes accepted leader a: the 32 lanes read one 128-byte line of
// the table per block of the row, and a ballot gives the first accepting
// leader.  Two launches a round:
//   leaders: one block; clears the previous round's leader hats (their own
//     blocks only), finds the first L live positions from the first live
//     one (a block-wide ballot scan), and dedups them in order on warp 0;
//   assign: a warp per 32 consecutive positions; a ballot finds the live
//     ones and the warp takes them one by one; one atomic per block for
//     the rows assigned.
//
// Exactness.  Every sum is numpy's float32 pairwise sum over the row's
// blocks in their order (8 accumulators up to 128 terms, halves above),
// exactly as rows._batched_cluster(hat_dtype=np.float32) takes
// np.minimum(leader_dense[:, supp], vals).sum(axis=1), so the port's
// similarities are that function's, bit for bit: the leaders' test against
// float32(alpha), the rows' against alpha in float64 (the host's sims are
// float64), which alpha_row, the largest float32 <= alpha, reproduces.  No
// products, so no FMA contraction; the divide is IEEE.
//
// What bounds it.  Bytes: a round reads the live rows' encodings once
// (8 bytes a block, 16 a row) and the leaders' hats; a few operations a
// block and leader.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeadThreads = 1024;
constexpr int kAssignWarps = 8;
constexpr int kMaxLeaders = 1024;

enum { kClusters = 0, kLive = 1, kStart = 2, kAccepted = 3, kBase = 4 };

// numpy's pairwise_sum (float32) of min(lead[idx[k] * ld], hat[k]), k < n
__device__ float pairwise_min_sum(const int* __restrict__ idx,
                                  const float* __restrict__ hat,
                                  const float* lead, long long ld, int n) {
  if (n < 8) {
    float r = 0.0f;
    for (int k = 0; k < n; ++k)
      r += fminf(lead[(long long)idx[k] * ld], hat[k]);
    return r;
  }
  if (n <= 128) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[j] = fminf(lead[(long long)idx[j] * ld], hat[j]);
    int i = 8;
    for (; i < n - (n % 8); i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] += fminf(lead[(long long)idx[i + j] * ld], hat[i + j]);
    }
    float res = ((r[0] + r[1]) + (r[2] + r[3])) +
                ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += fminf(lead[(long long)idx[i] * ld], hat[i]);
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_min_sum(idx, hat, lead, ld, n2) +
         pairwise_min_sum(idx + n2, hat + n2, lead, ld, n - n2);
}

// The first accepted leader (0..n_acc-1) the row at encodings [s, s+len)
// with hat sum hs is similar to, or -1; called by a whole warp.
__device__ int first_leader(const int* __restrict__ idx,
                            const float* __restrict__ hat,
                            const float* __restrict__ hsum, const float* lead,
                            const int* acc_pos, long long ld, long long s,
                            int len, float hs, int n_acc, float alpha,
                            int lane) {
  for (int a0 = 0; a0 < n_acc; a0 += 32) {
    const int a = a0 + lane;
    bool hit = false;
    if (a < n_acc) {
      const float ms = pairwise_min_sum(idx + s, hat + s, lead + a, ld, len);
      const float sim = ms / fmaxf((hsum[acc_pos[a]] + hs) - ms, 1e-30f);
      hit = sim > alpha;
    }
    const unsigned b = __ballot_sync(kFull, hit);
    if (b) return a0 + __ffs(b) - 1;
  }
  return -1;
}

__global__ void __launch_bounds__(kLeadThreads)
cluster_leaders_kernel(const long long* __restrict__ ptr,
                       const int* __restrict__ idx,
                       const float* __restrict__ hat,
                       const float* __restrict__ hsum, int* cluster,
                       int* state, float* lead, int* acc_pos, long long n,
                       int L, float alpha) {
  __shared__ int s_lead[kMaxLeaders];
  __shared__ int s_warp[kLeadThreads / 32];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // clear the previous round's accepted leaders from the hat table
  const int prev = state[kAccepted];
  for (int a = warp; a < prev; a += n_warps) {
    const int p = acc_pos[a];
    const long long s = ptr[p], e = ptr[p + 1];
    for (long long k = s + lane; k < e; k += 32)
      lead[(long long)idx[k] * L + a] = 0.0f;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();
  // the first L live positions, in order, from the first live one
  for (long long p0 = state[kStart]; p0 < n; p0 += blockDim.x) {
    const long long p = p0 + tid;
    const bool live = p < n && cluster[p] < 0;
    const unsigned bal = __ballot_sync(kFull, live);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    const int before = s_count;
    int rank = before + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += s_warp[w];
    if (live && rank < L) s_lead[rank] = (int)p;
    __syncthreads();
    if (tid == 0) {
      int total = before;
      for (int w = 0; w < n_warps; ++w) total += s_warp[w];
      s_count = min(total, L);
    }
    __syncthreads();
    if (s_count >= L) break;
  }
  if (warp != 0) return;
  // dedup the candidates in order against the accepted ones
  const int n_lead = s_count;
  const int base = state[kClusters];
  int n_acc = 0;
  for (int i = 0; i < n_lead; ++i) {
    const int p = s_lead[i];
    const long long s = ptr[p];
    const int len = (int)(ptr[p + 1] - s);
    const int first = first_leader(idx, hat, hsum, lead, acc_pos, L, s, len,
                                   hsum[p], n_acc, alpha, lane);
    if (first >= 0) {
      if (lane == 0) cluster[p] = base + first;
    } else {
      for (int k = lane; k < len; k += 32)
        lead[(long long)idx[s + k] * L + n_acc] = hat[s + k];
      if (lane == 0) {
        cluster[p] = base + n_acc;
        acc_pos[n_acc] = p;
      }
      ++n_acc;
    }
    __syncwarp();
  }
  if (lane == 0) {
    state[kBase] = base;
    state[kAccepted] = n_acc;
    state[kClusters] = base + n_acc;
    state[kLive] -= n_lead;
    if (n_lead) state[kStart] = s_lead[0];
  }
}

__global__ void __launch_bounds__(kAssignWarps * 32)
cluster_assign_kernel(const long long* __restrict__ ptr,
                      const int* __restrict__ idx,
                      const float* __restrict__ hat,
                      const float* __restrict__ hsum, int* cluster,
                      int* state, const float* __restrict__ lead,
                      const int* __restrict__ acc_pos, long long n, int L,
                      float alpha) {
  __shared__ int s_done;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_acc = state[kAccepted];
  const int base = state[kBase];
  const long long start = state[kStart];
  if (tid == 0) s_done = 0;
  __syncthreads();
  const long long p0 = ((long long)blockIdx.x * kAssignWarps + warp) * 32;
  int done = 0;
  if (n_acc > 0 && p0 + 32 > start && p0 < n) {
    const long long p = p0 + lane;
    unsigned todo = __ballot_sync(kFull, p < n && cluster[p] < 0);
    while (todo) {
      const long long q = p0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      const long long s = ptr[q];
      const int len = (int)(ptr[q + 1] - s);
      const int first = first_leader(idx, hat, hsum, lead, acc_pos, L, s,
                                     len, hsum[q], n_acc, alpha, lane);
      if (first >= 0) {
        if (lane == 0) cluster[q] = base + first;
        ++done;
      }
    }
  }
  if (lane == 0 && done) atomicAdd(&s_done, done);
  __syncthreads();
  if (tid == 0 && s_done) atomicSub(&state[kLive], s_done);
}

}  // namespace

// C interface (ctypes), checked by the wrapper
// (reorder/device_cluster.py::cluster_round): the encodings and the round
// state described above, n positions (< 2^31), L leaders a round (<= 1024,
// the table's leading dimension), alpha the leaders' threshold (float32 of
// the host's alpha).  Returns the launch's cudaGetLastError() code.
extern "C" int sddmm_cluster_leaders(const long long* ptr, const int* idx,
                                     const float* hat, const float* hsum,
                                     int* cluster, int* state, float* lead,
                                     int* acc_pos, long long n, int L,
                                     float alpha, void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxLeaders || n >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cluster_leaders_kernel<<<1, kLeadThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ptr, idx, hat, hsum, cluster, state, lead, acc_pos, n, L, alpha);
  return (int)cudaGetLastError();
}

// The rows' pass of the same round: alpha is the rows' threshold (the
// largest float32 <= the host's alpha).
extern "C" int sddmm_cluster_assign(const long long* ptr, const int* idx,
                                    const float* hat, const float* hsum,
                                    int* cluster, int* state,
                                    const float* lead, const int* acc_pos,
                                    long long n, int L, float alpha,
                                    void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxLeaders || n >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kAssignWarps * 32 - 1) / (kAssignWarps * 32);
  cluster_assign_kernel<<<(unsigned)blocks, kAssignWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ptr, idx, hat, hsum, cluster, state, lead, acc_pos, n, L, alpha);
  return (int)cudaGetLastError();
}
