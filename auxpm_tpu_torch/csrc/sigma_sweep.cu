// Whole log_sigma slice sweep: all 1 + n_sigma_extra shrinkage-only slice
// updates of a chain, off the carried factor C0 = chol(R + jitter I), inside
// one kernel.
//
// Replaces the TPU kernel auxpm_tpu/ops/sigma_sweep.py::_sigma_sweep_kernel
// (wrapper _pallas_sigma_sweep).  A probe at candidate x runs the shared
// probe body (probe.cuh) on exp(x) * C0, the scale applied to each element of
// C0 BEFORE the product exactly as the reference does, and evaluates
//     lp(x) = lp_rest - hiv (x - mu)^2 + ll(x).
// One block per chain, the shrink loop inside the kernel, so each chain runs
// its own probe count.  u does not change in this update and is staged in
// shared memory once per sweep; C0 (1.6 MB at n=640) cannot stay in a block's
// 227 KB and is streamed from global memory / L2 on every probe (n*n*4 bytes
// re-read per probe per chain).
//
// Thread 0 owns the bracket and makes every float comparison; candidates and
// the continue flag are published through shared memory behind a barrier, so
// the block's control flow is uniform.  Cap-hit keeps the current point.
//
// Bound: operations.  2*S*n*n FLOPs per probe, one probe per shrink
// iteration, against one read of (C0, u, chain, rep) and 8 floats written.
#include "probe.cuh"

namespace auxpm {

constexpr int kRepCols = 2 + kMaxShrink;
constexpr int kCand = 1, kGo = 2;  // ctrl slots (slot 0 = probe's estimate)

template <int LIK, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
sigma_sweep_kernel(const float* __restrict__ chol0,
                   const float* __restrict__ u,
                   const float* __restrict__ chain,
                   const float* __restrict__ rep,
                   const float* __restrict__ y,
                   const float* __restrict__ mask, float* __restrict__ stats,
                   int S, int n, int R, int n_blocks, float log_s) {
  extern __shared__ __align__(16) float smem[];
  const ProbeSmem sm = carve_smem(smem, n);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* C0 = chol0 + size_t(b) * n * n;
  const float* ub = u + size_t(b) * S * n;
  const float* ch = chain + size_t(b) * 8;
  const float* rp = rep + size_t(b) * R * kRepCols;

  zero_pad_rows(sm, S, n);
  fill_left<BF16>(sm, S, n, [&](int idx) { return ub[idx]; });

  // bracket state lives in thread 0 only
  float ll = ch[0], lp = ch[1], sig = ch[2];
  const float w = ch[3], mu = ch[4], hiv = ch[5], lp_rest = ch[6];
  float n_shrink_tot = 0.0f, moved_tot = 0.0f;

  for (int r = 0; r < R; ++r) {
    const float* row = rp + r * kRepCols;
    const float log_y = lp + row[0];
    float l = sig - w * row[1];
    float rt = l + w;
    float x = sig, lp_x = lp, ll_x = ll;
    int i = 0;
    bool done = false;
    do {
      if (tid == 0) sm.ctrl[kCand] = l + (rt - l) * row[2 + i];
      __syncthreads();
      const float x_new = sm.ctrl[kCand];
      const float ll_new = probe_estimate<LIK, BF16>(
          sm, C0, expf(x_new), y, mask, S, n, n_blocks, log_s);
      if (tid == 0) {
        const float d = x_new - mu;
        const float lp_new = lp_rest - hiv * d * d + ll_new;
        done = lp_new > log_y;
        if (!(done || x_new >= sig)) l = x_new;
        if (!(done || x_new < sig)) rt = x_new;
        x = x_new;
        lp_x = lp_new;
        ll_x = ll_new;
        ++i;
        sm.ctrl[kGo] = (!done && i < kMaxShrink) ? 1.0f : 0.0f;
      }
      __syncthreads();
    } while (sm.ctrl[kGo] != 0.0f);
    if (tid == 0) {
      if (done) {
        sig = x;
        lp = lp_x;
        ll = ll_x;
      }
      n_shrink_tot += float(i);
      moved_tot += done ? 1.0f : 0.0f;
    }
    // all threads have read ctrl[kGo] before thread 0 writes it again
    __syncthreads();
  }
  if (tid == 0) {
    float* st = stats + size_t(b) * 8;
    st[0] = sig;
    st[1] = ll;
    st[2] = lp;
    st[3] = n_shrink_tot;
    st[4] = moved_tot;
    st[5] = 0.0f;
    st[6] = 0.0f;
    st[7] = 0.0f;
  }
}

}  // namespace auxpm

extern "C" int auxpm_sigma_sweep(const void* chol0, const void* u,
                                 const void* chain, const void* rep,
                                 const void* y, const void* mask, void* stats,
                                 int B, int S, int n, int R, int n_blocks,
                                 float log_s, int likelihood, int bf16,
                                 void* stream) {
  using namespace auxpm;
  const size_t smem = probe_smem_bytes(n);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                        \
  err = allow_smem(sigma_sweep_kernel<LIK, BF>, smem);                       \
  if (err == cudaSuccess) {                                                  \
    sigma_sweep_kernel<LIK, BF>                                              \
        <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(          \
            static_cast<const float*>(chol0), static_cast<const float*>(u),  \
            static_cast<const float*>(chain), static_cast<const float*>(rep),\
            static_cast<const float*>(y), static_cast<const float*>(mask),   \
            static_cast<float*>(stats), S, n, R, n_blocks, log_s);           \
    err = cudaGetLastError();                                                \
  }
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}
