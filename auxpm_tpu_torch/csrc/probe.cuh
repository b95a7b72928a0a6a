// Probe body of two entries of fused_estimator.cu (rotated estimate, plain
// per-sample weights), and the pieces every estimator kernel shares
// (round_operand, log_lik, blocked_lse, the dispatch); the plain estimate,
// the rotated weights and both sweeps run on sweep_body.cuh instead.
//
// Replaces the probe body that the three TPU kernels share in
// auxpm_tpu/ops/fused_estimator.py (_dot_whiten, _log_lik_tile,
// _blocked_lse_lw).  For ONE chain, handled by ONE thread block, it computes
//
//     f[s, i]  = sum_k left[s, k] * (scale * C[i, k])        (S, n), never stored
//     lw[s]    = sum_i mask[i] * loglik(y[i] * f[s, i])
//     estimate = blocked-lse_s(lw) - log S
//
// Design for Hopper (one block of 256 threads per chain):
//   * `left` (u, or the rotated proposal u cos a + v sin a) is formed once per
//     probe in shared memory (S x n f32 = 164 KB at S=64, n=640); a block has
//     227 KB, so the left operand fits but C (n x n f32 = 1.6 MB) does not.
//   * C is therefore streamed from global memory / L2 on EVERY probe, in
//     64-row x 32-column tiles staged through shared memory with a register
//     prefetch of the next tile.  Cost of that choice: n*n*4 bytes of C are
//     re-read per probe per chain (1.6 MB at n=640), so a sweep's traffic
//     grows with its probe count.  Splitting a chain over a thread-block
//     cluster, or batching the active chains' probes into one GEMM, are the
//     ways out and are left to later work.
//   * C is lower-triangular but the contraction runs over the full n, as the
//     reference does: the zero terms change nothing but cost half the FMAs
//     and half the bytes.  sweep_body.cuh skips them; these two entries
//     are queued to move onto it.
//   * each thread owns a 4x4 micro-tile of f (rows ty*4.., columns tx+16c),
//     FP32 FMAs on the CUDA cores; the likelihood is applied to the finished
//     micro-tile and summed over columns in registers, so f never leaves the
//     block.
//   * the 8-block log-sum-exp runs on warp 0 in the fixed order of the
//     reference (block partials in index order, -inf guard), result broadcast
//     through shared memory so every thread sees the same float.
//
// Bound on this card: the least work of a probe is S n (n + 1) FLOPs per
// chain (26 MFLOP at S=64, n=640), against the n(n+1)/2 floats of C's lower
// triangle (0.8 MB): about S/2 FLOPs per byte, so bound by operations at
// S=64 and by bytes at S_local=32 (the card's FP32 balance is about 20).
// With 128 chains in flight the stream of 128 distinct factors (105 MB of
// triangles, larger than L2) matters too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // most importance samples a block can hold
constexpr int kTileN = 64;    // rows of C (columns of f) per tile
constexpr int kTileK = 32;    // contraction chunk
constexpr int kLdb = kTileK + 4;
constexpr int kMaxShrink = 32;
constexpr int kCtrl = 8;      // broadcast slots

enum Likelihood { kLogistic = 0, kProbit = 1 };

__host__ __device__ inline int left_ld(int n) { return n + 4; }

inline size_t probe_smem_bytes(int n) {
  return sizeof(float) *
         (size_t(kRows) * left_ld(n) + kTileN * kLdb + kRows + kCtrl);
}

struct ProbeSmem {
  float* left;  // (kRows, n + 4)
  float* ctile; // (kTileN, kLdb)
  float* lw;    // (kRows,)
  float* ctrl;  // (kCtrl,) slot 0 = last probe's estimate
};

__device__ inline ProbeSmem carve_smem(float* base, int n) {
  ProbeSmem sm;
  sm.left = base;
  sm.ctile = sm.left + kRows * left_ld(n);
  sm.lw = sm.ctile + kTileN * kLdb;
  sm.ctrl = sm.lw + kRows;
  return sm;
}

template <bool BF16>
__device__ __forceinline__ float round_operand(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// log Phi(z) by the log-form single-formula erfc approximation: the same
// polynomial as models/likelihoods.log_ndtr.
__device__ __forceinline__ float log_ndtr(float z) {
  const float x = fabsf(z) * 0.7071067811865476f;
  const float t = 1.0f / (1.0f + 0.5f * x);
  float p = 0.17087277f;
  p = p * t + -0.82215223f;
  p = p * t + 1.48851587f;
  p = p * t + -1.13520398f;
  p = p * t + 0.27886807f;
  p = p * t + -0.18628806f;
  p = p * t + 0.09678418f;
  p = p * t + 0.37409196f;
  p = p * t + 1.00002368f;
  p = p * t + -1.26551223f;
  const float log_ec = logf(t) - x * x + p;
  const float neg = -0.6931471805599453f + log_ec;
  const float pos = log1pf(-0.5f * expf(log_ec));
  return z < 0.0f ? neg : pos;
}

template <int LIK>
__device__ __forceinline__ float log_lik(float z) {
  if constexpr (LIK == kLogistic) {
    // log sigmoid(z) = -softplus(-z)
    return -(fmaxf(-z, 0.0f) + log1pf(expf(-fabsf(z))));
  } else {
    return log_ndtr(z);
  }
}

__device__ __forceinline__ float finite_or_zero(float m) {
  return isfinite(m) ? m : 0.0f;
}

// Blocked log-sum-exp of lw[0..S) with the fixed sequential combine of
// ops/logsumexp.blocked_logsumexp.  Called by all 32 lanes of ONE warp.
__device__ inline float blocked_lse(const float* lw, int S, int n_blocks) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int bs = S / n_blocks;
  float bm = -INFINITY, bsum = 0.0f;
  if (lane < n_blocks) {
    const float* blk = lw + lane * bs;
    for (int e = 0; e < bs; ++e) bm = fmaxf(bm, blk[e]);
    const float safe = finite_or_zero(bm);
    for (int e = 0; e < bs; ++e) bsum += expf(blk[e] - safe);
  }
  float cm = __shfl_sync(full, bm, 0);
  float cs = __shfl_sync(full, bsum, 0);
  for (int b = 1; b < n_blocks; ++b) {
    const float m_b = __shfl_sync(full, bm, b);
    const float s_b = __shfl_sync(full, bsum, b);
    const float nm = fmaxf(cm, m_b);
    const float safe = finite_or_zero(nm);
    cs = cs * expf(cm - safe) + s_b * expf(m_b - safe);
    cm = nm;
  }
  return logf(cs) + finite_or_zero(cm);
}

// Rows S..kRows of the left operand are never written by fill_left; zero them
// once so the micro-tiles that cover them stay finite.
__device__ inline void zero_pad_rows(const ProbeSmem& sm, int S, int n) {
  const int ld = left_ld(n);
  for (int idx = S * ld + threadIdx.x; idx < kRows * ld; idx += kThreads)
    sm.left[idx] = 0.0f;
}

// Form the effective left operand in shared memory.  `value(idx)` returns
// element idx = s * n + k of the (S, n) operand (u, or u cos a + v sin a).
template <bool BF16, class F>
__device__ inline void fill_left(const ProbeSmem& sm, int S, int n, F value) {
  const int ld = left_ld(n);
  for (int idx = threadIdx.x; idx < S * n; idx += kThreads) {
    const int s = idx / n;
    const int k = idx - s * n;
    sm.left[s * ld + k] = round_operand<BF16>(value(idx));
  }
  __syncthreads();
}

// The per-sample log-weights of one probe: fills sm.lw[0..kRows) from the
// left operand currently in shared memory and scale * C (rows past the
// caller's S are pad rows and hold the weight of a zero sample).  Every thread
// of the block must call it.  Ends with a block barrier.
//
// A row's weight does not depend on which of the block's rows it occupies or
// on how many rows the call holds: each micro-tile row runs k in the same
// fixed order and the sum over columns is the same shuffle tree for every
// row.  The particle-sharded estimator rests on that (a shard's rows give the
// bits the whole block would give).
template <int LIK, bool BF16>
__device__ inline void probe_weights(const ProbeSmem& sm,
                                     const float* __restrict__ C,
                                     float scale,
                                     const float* __restrict__ y,
                                     const float* __restrict__ mask, int n) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ld = left_ld(n);
  const int n_chunks = n / kTileK;

  // this thread's two float4 slots of a (kTileN, kTileK) tile of C
  const int row0 = tid >> 3, row1 = row0 + 32;
  const int q4 = (tid & 7) * 4;

  float rowacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int j0 = 0; j0 < n; j0 += kTileN) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

    const float* c_row0 = C + size_t(j0 + row0) * n + q4;
    const float* c_row1 = C + size_t(j0 + row1) * n + q4;
    float4 pre0 = *reinterpret_cast<const float4*>(c_row0);
    float4 pre1 = *reinterpret_cast<const float4*>(c_row1);

    for (int kc = 0; kc < n_chunks; ++kc) {
      float4 s0, s1;
      s0.x = round_operand<BF16>(scale * pre0.x);
      s0.y = round_operand<BF16>(scale * pre0.y);
      s0.z = round_operand<BF16>(scale * pre0.z);
      s0.w = round_operand<BF16>(scale * pre0.w);
      s1.x = round_operand<BF16>(scale * pre1.x);
      s1.y = round_operand<BF16>(scale * pre1.y);
      s1.z = round_operand<BF16>(scale * pre1.z);
      s1.w = round_operand<BF16>(scale * pre1.w);
      *reinterpret_cast<float4*>(sm.ctile + row0 * kLdb + q4) = s0;
      *reinterpret_cast<float4*>(sm.ctile + row1 * kLdb + q4) = s1;
      __syncthreads();
      if (kc + 1 < n_chunks) {
        pre0 = *reinterpret_cast<const float4*>(c_row0 + (kc + 1) * kTileK);
        pre1 = *reinterpret_cast<const float4*>(c_row1 + (kc + 1) * kTileK);
      }
      const float* a_base = sm.left + (ty * 4) * ld + kc * kTileK;
      const float* b_base = sm.ctile + tx * kLdb;
#pragma unroll
      for (int k = 0; k < kTileK; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = *reinterpret_cast<const float4*>(a_base + r * ld + k);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b[c] = *reinterpret_cast<const float4*>(b_base + 16 * c * kLdb + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
            acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
            acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
            acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
          }
      }
      __syncthreads();
    }

    // likelihood on the finished micro-tile, summed over its columns
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      const float yj = y[j], mj = mask[j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        rowacc[r] += log_lik<LIK>(yj * acc[r][c]) * mj;
    }
  }

  // sum over the 16 threads (tx) that share each row
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v = rowacc[r];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (tx == 0) sm.lw[ty * 4 + r] = v;
  }
  __syncthreads();
}

// One probe: the estimate at the left operand currently in shared memory and
// scale * C, i.e. probe_weights and the blocked log-sum-exp of its first S
// rows.  Every thread of the block must call it; every thread gets the same
// return value.  Ends with a block barrier.
template <int LIK, bool BF16>
__device__ inline float probe_estimate(const ProbeSmem& sm,
                                       const float* __restrict__ C,
                                       float scale,
                                       const float* __restrict__ y,
                                       const float* __restrict__ mask,
                                       int S, int n, int n_blocks,
                                       float log_s) {
  probe_weights<LIK, BF16>(sm, C, scale, y, mask, n);
  if (threadIdx.x < 32) {
    const float est = blocked_lse(sm.lw, S, n_blocks) - log_s;
    if (threadIdx.x == 0) sm.ctrl[0] = est;
  }
  __syncthreads();
  return sm.ctrl[0];
}

// Raise the dynamic shared memory limit of a kernel; returns the CUDA error.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// Pick the (likelihood, whiten dtype) instantiation of a kernel template
// functor and run `launch` on it.
#define AUXPM_DISPATCH(likelihood, bf16, CALL)                     \
  do {                                                             \
    if ((likelihood) == kLogistic && !(bf16)) { CALL(kLogistic, false); } \
    else if ((likelihood) == kLogistic) { CALL(kLogistic, true); } \
    else if (!(bf16)) { CALL(kProbit, false); }                    \
    else { CALL(kProbit, true); }                                  \
  } while (0)

}  // namespace auxpm
