// The f32 pieces that every estimator kernel shares (fused_estimator.cu,
// ess_sweep.cu, sigma_sweep.cu, all over sweep_body.cuh): the operand
// rounding of whiten_dtype="bfloat16", the two log-likelihoods, the fixed
// 8-block log-sum-exp and the (likelihood, whiten dtype) dispatch.
//
// Counterparts of the pieces of auxpm_tpu/ops/fused_estimator.py that its
// TPU kernels share (_log_lik_tile, _blocked_lse_lw); the product itself
// (_dot_whiten) is sweep_body.cuh's probe_tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kRows = 64;     // rows of u in one work item (a row block)
constexpr int kMaxSamples = 4096;  // most importance samples S of a probe
constexpr int kMaxShrink = 32;

enum Likelihood { kLogistic = 0, kProbit = 1 };

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
