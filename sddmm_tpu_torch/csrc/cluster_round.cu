// Device row clustering: one round of BSMR's multi-leader row clustering.
//
// Replaces sddmm_tpu/reorder/device_cluster.py::_round_step (an XLA
// program there, :51-128), which computes rows._batched_cluster's round:
// the first L live rows in dispersion order are the leader candidates;
// each is dropped into the first earlier accepted leader it is similar to,
// else accepted; then every live row joins the first accepted leader it is
// similar to.  Similarity of L1-normalised encodings x, y is the weighted
// Jaccard min_sum / ((|x| + |y|) - min_sum), in fp32.  It also takes over
// the JAX host loop's per-round test of the early bail and max_rounds.
//
// The rows live in dispersion order here (position p is the p-th row of
// the order): ptr (n+1,) int64 over the row's occupied column blocks, idx
// int32 block ids and hat fp32 values, hsum (n,) fp32 the row sums of hat.
// cluster (n,) int32 is -1 while a row is live, else its cluster id.
// state int32[kWords] carries the clustering's scalars on the card (see the
// enum) and the last round's accepted mask, ceil(L/32) words from kMask.
// lead (nb, L) fp32 holds the round's candidates' dense hats, candidate j
// in column j, zero elsewhere; cand_pos (L,) their positions;
// made (n+1,) the clusters made by the end of each round; lists (2, n)
// int32 the live positions, rebuilt each round (any order).
//
// What bounds it.  Bytes: a round reads the live rows' encodings once
// (8 bytes a block, 16 a row; 4.74 MB a round on average on the probe
// matrix, 0.0014 ms at 3.35 TB/s) and the candidates' hats; a few
// operations a block and leader.  The work is a chain of dependent loads
// (a row's block ids, then the leader table at them), so latency, not
// bandwidth, sets the time.
//
// Design.
//   leaders (one block of 1024 threads): tests the bail and max_rounds
//     (the host's rule, in double) and ends the clustering on the card;
//     clears the last round's candidate columns (their own blocks only);
//     finds the first L live positions (a block-wide ballot scan); stages
//     the candidates' encodings in shared memory and writes every
//     candidate's hat into its own column at once; then computes all
//     L x L "candidate i is similar to earlier candidate j" bits in
//     parallel, a thread a pair, each the same pairwise min-sum over i's
//     blocks against column j as before; one thread resolves acceptance in
//     order with bit operations (i is accepted iff sim_i & accepted is
//     empty, else it joins the lowest set bit), and cluster ids are the
//     ranks among the accepted.  The serial chain of 32 candidates x 16
//     dependent loads becomes one pass of independent ones.  The bits are
//     ceil(L/32) 32-bit words a candidate (dynamic shared memory, L x W
//     words, with the stage), so L goes up to kMaxLeaders.
//   assign (a grid sized to the card, rows by grid stride): a warp a live
//     row of the round's compacted list, so no warp walks 32 rows and the
//     grid never visits dead positions.  A row of up to 32 blocks is read
//     once, one (block, hat) a lane, and shuffled to the lanes, so the
//     leader-table reads (lane a: candidate column a, one 128-byte line a
//     block) are the only gathered loads, and independent; a ballot ANDed
//     with the accepted candidates gives the first accepted leader (each
//     candidate's hat sum and cluster offset, -1 where it was not
//     accepted, are staged in shared memory once a block from the mask
//     words, the first 32 candidates' in registers).  Four blocks an SM at
//     most 64 registers a thread, one wave.  Survivors
//     are appended to the next round's list through a warp's shared
//     buffer, one atomic per 32 rows.
//   No host fetch a round: the host enqueues rounds in batches and reads
//   the state once a batch; a round after the end (no live rows, a bail or
//   max_rounds) returns at once.  k rounds between fetches were chosen
//   over a persistent cooperative kernel: the two passes want different
//   grids (one block against the whole card), and a grid-wide sync would
//   tie the leaders' single block to a full-card launch every round.
//
// Exactness.  Every sum is numpy's float32 pairwise sum over the row's
// blocks in their order (8 accumulators up to 128 terms, halves above),
// exactly as rows._batched_cluster(hat_dtype=np.float32) takes
// np.minimum(leader_dense[:, supp], vals).sum(axis=1), so the port's
// similarities are that function's, bit for bit: the leaders' test against
// float32(alpha), the rows' against alpha in float64 (the host's sims are
// float64), which alpha_row, the largest float32 <= alpha, reproduces.  No
// products, so no FMA contraction; the divide is IEEE.  A column holds one
// candidate's hat and zeros elsewhere, so its min-sum against a row is the
// same whether or not the candidate is accepted.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeadThreads = 1024;
constexpr int kAssignWarps = 8;
constexpr int kAssignBlocksPerSm = 4;  // 64 registers a thread at most
constexpr int kMaxLeaders = 512;  // candidates a round (mask words below)
constexpr int kMaskWords = kMaxLeaders / 32;
constexpr int kStage = 4096;      // candidate encodings staged in shared

enum {
  kClusters = 0,  // clusters made so far
  kLive = 1,      // live rows
  kStart = 2,     // the first live position
  kCands = 3,     // the last round's candidates
  kBase = 4,      // the last round's first cluster id
  kRounds = 5,    // rounds counted as the host counts them
  kDone = 6,      // 0 running, 1 no live rows, 2 bailed (or max_rounds)
  kCount0 = 7,    // live positions in lists[0] and lists[1]
  kMask = 9,      // the last round's accepted candidates, 32 a word
  kWords = kMask + kMaskWords
};

// words of a candidate's similarity bits, and the leaders' dynamic shared
// memory: those bits for L candidates, then the stage
__host__ __device__ constexpr int sim_words(int L) { return (L + 31) / 32; }
constexpr size_t leaders_smem(int L) {
  return sizeof(unsigned) * L * sim_words(L) +
         (sizeof(int) + sizeof(float)) * kStage;
}

// numpy's pairwise_sum (float32) of min(lead[idx[k] * ld], hat[k]), k < n;
// idx and hat may point to shared or global memory
__device__ float pairwise_min_sum(const int* idx, const float* hat,
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

// term k of a row held one (block, hat) a lane; the whole warp calls it
__device__ __forceinline__ float reg_term(int my_idx, float my_hat,
                                          const float* col, long long ld,
                                          int k) {
  const int b = __shfl_sync(kFull, my_idx, k);
  const float h = __shfl_sync(kFull, my_hat, k);
  return fminf(col[(long long)b * ld], h);
}

// pairwise_min_sum of a row of n <= 32 blocks held one a lane (lane k: the
// row's k-th block and hat) against the column col; same order of adds
__device__ float reg_min_sum(int my_idx, float my_hat, const float* col,
                             long long ld, int n) {
  if (n < 8) {
    float r = 0.0f;
    for (int k = 0; k < n; ++k) r += reg_term(my_idx, my_hat, col, ld, k);
    return r;
  }
  float r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = reg_term(my_idx, my_hat, col, ld, j);
  int i = 8;
  for (; i < n - (n % 8); i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[j] += reg_term(my_idx, my_hat, col, ld, i + j);
  }
  float res = ((r[0] + r[1]) + (r[2] + r[3])) +
              ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += reg_term(my_idx, my_hat, col, ld, i);
  return res;
}

__global__ void __launch_bounds__(kLeadThreads)
cluster_leaders_kernel(const long long* __restrict__ ptr,
                       const int* __restrict__ idx,
                       const float* __restrict__ hat,
                       const float* __restrict__ hsum, int* cluster,
                       int* state, float* lead, int* cand_pos, int* made,
                       long long n, int L, float alpha, int bail_after,
                       double bail_yield, long long max_rounds) {
  extern __shared__ unsigned s_dyn[];
  __shared__ int s_cand[kMaxLeaders];
  __shared__ int s_len[kMaxLeaders];
  __shared__ int s_cid[kMaxLeaders];
  __shared__ const int* s_ip[kMaxLeaders];
  __shared__ const float* s_hp[kMaxLeaders];
  __shared__ unsigned s_acc[kMaskWords];
  __shared__ int s_warp[kLeadThreads / 32];
  __shared__ int s_count, s_go, s_base;
  const int W = sim_words(L);
  unsigned* s_sim = s_dyn;  // (L, W): bit j of row i, i similar to j
  int* s_stage_idx = reinterpret_cast<int*>(s_dyn + L * W);
  float* s_stage_hat = reinterpret_cast<float*>(s_stage_idx + kStage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // the host loop's test at the top of a round
  if (tid == 0) {
    int go = 0;
    if (state[kDone] == 0) {
      const int live = state[kLive];
      if (live == 0) {
        state[kDone] = 1;
      } else {
        const int rounds = state[kRounds] + 1;
        state[kRounds] = rounds;
        const double assigned = (double)(n - live);
        const bool bail = rounds > bail_after &&
                          assigned < bail_yield * (double)L * (double)rounds;
        if (bail || (max_rounds >= 0 && rounds > max_rounds)) {
          state[kDone] = 2;
        } else {
          go = 1;
          state[kCount0 + (rounds & 1)] = 0;  // this round's survivors
        }
      }
    }
    s_go = go;
    s_count = 0;
    s_base = state[kClusters];
  }
  __syncthreads();
  if (!s_go) return;
  // clear the last round's candidate columns
  const int prev = state[kCands];
  for (int a = warp; a < prev; a += n_warps) {
    const int p = cand_pos[a];
    const long long s = ptr[p], e = ptr[p + 1];
    for (long long k = s + lane; k < e; k += 32)
      lead[(long long)idx[k] * L + a] = 0.0f;
  }
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
    if (live && rank < L) s_cand[rank] = (int)p;
    __syncthreads();
    if (tid == 0) {
      int total = before;
      for (int w = 0; w < n_warps; ++w) total += s_warp[w];
      s_count = min(total, L);
    }
    __syncthreads();
    if (s_count >= L) break;
  }
  const int n_lead = s_count;
  if (tid < n_lead) {
    const int p = s_cand[tid];
    s_len[tid] = (int)(ptr[p + 1] - ptr[p]);
  }
  for (int t = tid; t < n_lead * W; t += blockDim.x) s_sim[t] = 0u;
  if (tid < W) s_acc[tid] = 0u;
  __syncthreads();
  if (tid == 0) {  // stage the candidates' encodings while they fit
    int off = 0;
    for (int i = 0; i < n_lead; ++i) {
      const long long s = ptr[s_cand[i]];
      if (off + s_len[i] <= kStage) {
        s_ip[i] = s_stage_idx + off;
        s_hp[i] = s_stage_hat + off;
        off += s_len[i];
      } else {
        s_ip[i] = idx + s;
        s_hp[i] = hat + s;
      }
    }
  }
  __syncthreads();
  // every candidate's hat into its own column (and into the stage)
  for (int j = warp; j < n_lead; j += n_warps) {
    const long long s = ptr[s_cand[j]];
    const bool staged = s_ip[j] != idx + s;
    int* si = const_cast<int*>(s_ip[j]);
    float* sh = const_cast<float*>(s_hp[j]);
    for (int k = lane; k < s_len[j]; k += 32) {
      const int b = idx[s + k];
      const float h = hat[s + k];
      lead[(long long)b * L + j] = h;
      if (staged) {
        si[k] = b;
        sh[k] = h;
      }
    }
  }
  __syncthreads();
  // "i is similar to earlier j", all pairs at once
  for (int t = tid; t < n_lead * n_lead; t += blockDim.x) {
    const int i = t / n_lead, j = t % n_lead;
    if (j >= i) continue;
    const float ms = pairwise_min_sum(s_ip[i], s_hp[i], lead + j, L,
                                      s_len[i]);
    const float sim =
        ms / fmaxf((hsum[s_cand[j]] + hsum[s_cand[i]]) - ms, 1e-30f);
    if (sim > alpha) atomicOr(&s_sim[i * W + (j >> 5)], 1u << (j & 31));
  }
  __syncthreads();
  if (tid == 0) {  // acceptance in order, with bit operations
    int n_acc = 0;
    for (int c = 0; c * 32 < n_lead; ++c) {
      // word c of the accepted mask in a register; the words before it
      // are final in s_acc
      unsigned acc = 0u;
      const int first_id = n_acc;
      const int end = min(n_lead, (c + 1) * 32);
      for (int i = c * 32; i < end; ++i) {
        int j = -1;  // the lowest accepted j < i that i is similar to
        for (int w = 0; w < c && j < 0; ++w) {
          const unsigned hits = s_sim[i * W + w] & s_acc[w];
          if (hits) j = (w << 5) + __ffs(hits) - 1;
        }
        if (j >= 0) {
          s_cid[i] = s_cid[j];  // j is accepted: its id is its rank
          continue;
        }
        const unsigned hits = s_sim[i * W + c] & acc;
        if (!hits) {
          s_cid[i] = n_acc++;
          acc |= 1u << (i & 31);
        } else {
          s_cid[i] = first_id + __popc(acc & ((1u << (__ffs(hits) - 1)) - 1u));
        }
      }
      s_acc[c] = acc;
    }
    const int base = s_base;
    const int made_now = base + n_acc;
    state[kBase] = base;
    state[kCands] = n_lead;
    for (int w = 0; w < W; ++w) state[kMask + w] = (int)s_acc[w];
    state[kClusters] = made_now;
    state[kLive] -= n_lead;
    state[kStart] = s_cand[0];
    made[state[kRounds] - 1] = made_now;
  }
  __syncthreads();
  if (tid < n_lead) {
    cluster[s_cand[tid]] = s_base + s_cid[tid];
    cand_pos[tid] = s_cand[tid];
  }
}

__global__ void __launch_bounds__(kAssignWarps * 32, kAssignBlocksPerSm)
cluster_assign_kernel(const long long* __restrict__ ptr,
                      const int* __restrict__ idx,
                      const float* __restrict__ hat,
                      const float* __restrict__ hsum, int* cluster,
                      int* state, const float* __restrict__ lead,
                      const int* __restrict__ cand_pos, int* lists,
                      long long n, int L, float alpha) {
  __shared__ int s_done;
  __shared__ int s_buf[kAssignWarps][32];
  __shared__ float s_cs[kMaxLeaders];  // the candidates' hat sums
  __shared__ int s_rank[kMaxLeaders];  // rank among the accepted, or -1
  if (state[kDone] != 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = state[kRounds];
  const int* in = lists + (long long)((rounds - 1) & 1) * n;
  int* out = lists + (long long)(rounds & 1) * n;
  int* out_count = state + kCount0 + (rounds & 1);
  const long long count = state[kCount0 + ((rounds - 1) & 1)];
  const int n_cand = state[kCands];
  const int base = state[kBase];
  // candidate a's hat sum and its cluster offset from the accepted mask
  for (int a = tid; a < n_cand; a += blockDim.x) {
    const unsigned word = (unsigned)state[kMask + (a >> 5)];
    int rank = -1;
    if ((word >> (a & 31)) & 1u) {
      rank = __popc(word & ((1u << (a & 31)) - 1u));
      for (int w = 0; w < (a >> 5); ++w)
        rank += __popc((unsigned)state[kMask + w]);
    }
    s_rank[a] = rank;
    s_cs[a] = hsum[cand_pos[a]];
  }
  if (tid == 0) s_done = 0;
  __syncthreads();
  // the first 32 candidates (all of them up to L = 32) in registers
  const int rank0 = lane < n_cand ? s_rank[lane] : -1;
  const float cs0 = s_cs[min(lane, n_cand - 1)];
  int done = 0, nbuf = 0;
  const long long n_w = (long long)gridDim.x * kAssignWarps;
  for (long long w = (long long)blockIdx.x * kAssignWarps + warp; w < count;
       w += n_w) {
    const int q = in[w];
    if (cluster[q] >= 0) continue;  // a candidate of this round
    const long long s = ptr[q];
    const int len = (int)(ptr[q + 1] - s);
    const float hs = hsum[q];
    int my_idx = 0;
    float my_hat = 0.0f;
    if (len <= 32 && lane < len) {
      my_idx = idx[s + lane];
      my_hat = hat[s + lane];
    }
    int first = -1;  // the first accepted leader's cluster offset
    for (int a0 = 0; a0 < n_cand; a0 += 32) {
      const int a = a0 + lane;
      const int rank = a0 == 0 ? rank0 : (a < n_cand ? s_rank[a] : -1);
      const bool ok = rank >= 0;
      const float* col = lead + min(a, L - 1);
      const float ms = len <= 32
                           ? reg_min_sum(my_idx, my_hat, col, L, len)
                           : pairwise_min_sum(idx + s, hat + s, col, L, len);
      const float cs = a0 == 0 ? cs0 : s_cs[min(a, n_cand - 1)];
      const bool hit = ok && ms / fmaxf((cs + hs) - ms, 1e-30f) > alpha;
      const unsigned b = __ballot_sync(kFull, hit);
      if (b) {
        first = __shfl_sync(kFull, rank, __ffs(b) - 1);
        break;
      }
    }
    if (first >= 0) {
      if (lane == 0) cluster[q] = base + first;
      ++done;
    } else {
      if (lane == 0) s_buf[warp][nbuf] = q;
      if (++nbuf == 32) {
        __syncwarp();
        int pos = 0;
        if (lane == 0) pos = atomicAdd(out_count, 32);
        pos = __shfl_sync(kFull, pos, 0);
        out[pos + lane] = s_buf[warp][lane];
        nbuf = 0;
        __syncwarp();
      }
    }
  }
  if (nbuf) {
    __syncwarp();
    int pos = 0;
    if (lane == 0) pos = atomicAdd(out_count, nbuf);
    pos = __shfl_sync(kFull, pos, 0);
    if (lane < nbuf) out[pos + lane] = s_buf[warp][lane];
  }
  if (lane == 0 && done) atomicAdd(&s_done, done);
  __syncthreads();
  if (tid == 0 && s_done) atomicSub(&state[kLive], s_done);
}

int assign_blocks(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const long long want = (n + kAssignWarps - 1) / kAssignWarps;
  const long long full = (long long)kAssignBlocksPerSm * sms;  // one wave
  return (int)(want < full ? want : full);
}

}  // namespace

// C interface (ctypes), checked by the wrapper
// (reorder/device_cluster.py::cluster_round): the encodings and the state
// described above, n positions (< 2^31), L candidates a round (<=
// kMaxLeaders, the table's leading dimension), alpha the leaders' threshold
// (float32 of the host's alpha), the host loop's bail_after, bail_yield and
// max_rounds (-1: none).  Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for an L or n it does not take.
extern "C" int sddmm_cluster_leaders(const long long* ptr, const int* idx,
                                     const float* hat, const float* hsum,
                                     int* cluster, int* state, float* lead,
                                     int* cand_pos, int* made, long long n,
                                     int L, float alpha, int bail_after,
                                     double bail_yield, long long max_rounds,
                                     void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxLeaders || n >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // above 48 KB of shared memory a kernel must opt in, once a device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(cluster_leaders_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)leaders_smem(kMaxLeaders));
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  cluster_leaders_kernel<<<1, kLeadThreads, leaders_smem(L),
                           static_cast<cudaStream_t>(stream)>>>(
      ptr, idx, hat, hsum, cluster, state, lead, cand_pos, made, n, L, alpha,
      bail_after, bail_yield, max_rounds);
  return (int)cudaGetLastError();
}

// The rows' pass of the same round: alpha is the rows' threshold (the
// largest float32 <= the host's alpha); lists (2, n) int32.
extern "C" int sddmm_cluster_assign(const long long* ptr, const int* idx,
                                    const float* hat, const float* hsum,
                                    int* cluster, int* state,
                                    const float* lead, const int* cand_pos,
                                    int* lists, long long n, int L,
                                    float alpha, void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxLeaders || n >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cluster_assign_kernel<<<assign_blocks(n), kAssignWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ptr, idx, hat, hsum, cluster, state, lead, cand_pos, lists, n, L,
      alpha);
  return (int)cudaGetLastError();
}
