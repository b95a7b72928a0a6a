// Whole elliptical-slice sweep of u | theta: all repeats and every
// bracket-shrink probe of a chain inside one kernel.
//
// Replaces the TPU kernel auxpm_tpu/ops/ess_sweep.py::_ess_sweep_kernel
// (wrapper _pallas_ess_sweep).  The property kept is that each chain runs
// exactly its OWN probe count: one block per chain, the data-dependent shrink
// loop inside the kernel.  What does not carry over is the factor held next
// to the compute for the whole sweep: C (1.6 MB at n=640) does not fit a
// block's 227 KB, so it is streamed from global memory / L2 on every probe
// (probe.cuh).  Bytes re-read per probe per chain: n*n*4 of C plus 2*S*n*4 of
// u and v_r to form the rotated proposal.
//
// Control flow is uniform by construction: thread 0 alone compares the
// floats and owns the bracket; it publishes the next angle and the
// continue/accept flags through shared memory, a barrier follows, and every
// thread branches on the published value.
//
// u_out is the working buffer, as in the reference: an accepted repeat
// rewrites it in global memory and a block barrier orders that write before
// the next repeat's probes read it.  On cap-hit the state is kept.
//
// Bound: operations.  2*S*n*n FLOPs per probe, (R + shrinks) probes per
// chain, against one read of (C, u, v, scal) and one write of u'.
#include "probe.cuh"

namespace auxpm {

constexpr int kScalCols = 3 + kMaxShrink;
// ctrl slots (slot 0 is the probe's estimate)
constexpr int kAngle = 1, kGo = 2, kAccept = 3;

template <int LIK, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
ess_sweep_kernel(const float* __restrict__ chol, const float* __restrict__ u,
                 const float* __restrict__ scal, const float* __restrict__ v,
                 const float* __restrict__ y, const float* __restrict__ mask,
                 float* __restrict__ u_out, float* __restrict__ stats, int S,
                 int n, int R, int n_blocks, float log_s) {
  extern __shared__ __align__(16) float smem[];
  const ProbeSmem sm = carve_smem(smem, n);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int sn = S * n;
  const float* C = chol + size_t(b) * n * n;
  const float* ub = u + size_t(b) * sn;
  const float* vb = v + size_t(b) * R * sn;
  const float* sc = scal + size_t(b) * R * kScalCols;
  float* uo = u_out + size_t(b) * sn;

  zero_pad_rows(sm, S, n);
  for (int idx = tid; idx < sn; idx += kThreads) uo[idx] = ub[idx];
  __syncthreads();

  // bracket state lives in thread 0 only
  float ll = sc[0], n_shrink_tot = 0.0f, moved_tot = 0.0f;

  for (int r = 0; r < R; ++r) {
    const float* vr = vb + size_t(r) * sn;
    const float* row = sc + r * kScalCols;
    const float log_y = ll + row[1];
    float a = row[2];
    float a_min = a - 6.2831855f, a_max = a;
    int i = 0;
    bool done = false;

    auto probe_at = [&](float ang) {
      const float ca = cosf(ang), sa = sinf(ang);
      fill_left<BF16>(sm, S, n,
                      [&](int idx) { return uo[idx] * ca + vr[idx] * sa; });
      return probe_estimate<LIK, BF16>(sm, C, 1.0f, y, mask, S, n, n_blocks,
                                       log_s);
    };

    float ll_p = probe_at(a);
    if (tid == 0) {
      done = ll_p > log_y;
      sm.ctrl[kGo] = (!done && i < kMaxShrink) ? 1.0f : 0.0f;
    }
    __syncthreads();
    while (sm.ctrl[kGo] != 0.0f) {
      if (tid == 0) {
        a_min = a < 0.0f ? a : a_min;
        a_max = a < 0.0f ? a_max : a;
        a = a_min + (a_max - a_min) * row[3 + i];
        sm.ctrl[kAngle] = a;
      }
      __syncthreads();
      ll_p = probe_at(sm.ctrl[kAngle]);
      if (tid == 0) {
        ++i;
        done = ll_p > log_y;
        sm.ctrl[kGo] = (!done && i < kMaxShrink) ? 1.0f : 0.0f;
      }
      __syncthreads();
    }
    if (tid == 0) {
      sm.ctrl[kAngle] = a;
      sm.ctrl[kAccept] = done ? 1.0f : 0.0f;
      if (done) ll = ll_p;
      n_shrink_tot += float(i);
      moved_tot += done ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (sm.ctrl[kAccept] != 0.0f) {
      const float ang = sm.ctrl[kAngle];
      const float ca = cosf(ang), sa = sinf(ang);
      for (int idx = tid; idx < sn; idx += kThreads)
        uo[idx] = uo[idx] * ca + vr[idx] * sa;
    }
    // orders the rewrite of u_out before the next repeat reads it, and the
    // reads of ctrl before thread 0 rewrites it
    __syncthreads();
  }
  if (tid == 0) {
    float* st = stats + size_t(b) * 4;
    st[0] = ll;
    st[1] = n_shrink_tot;
    st[2] = moved_tot;
    st[3] = 0.0f;
  }
}

}  // namespace auxpm

extern "C" int auxpm_ess_sweep(const void* chol, const void* u,
                               const void* scal, const void* v, const void* y,
                               const void* mask, void* u_out, void* stats,
                               int B, int S, int n, int R, int n_blocks,
                               float log_s, int likelihood, int bf16,
                               void* stream) {
  using namespace auxpm;
  const size_t smem = probe_smem_bytes(n);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                        \
  err = allow_smem(ess_sweep_kernel<LIK, BF>, smem);                         \
  if (err == cudaSuccess) {                                                  \
    ess_sweep_kernel<LIK, BF>                                                \
        <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(          \
            static_cast<const float*>(chol), static_cast<const float*>(u),   \
            static_cast<const float*>(scal), static_cast<const float*>(v),   \
            static_cast<const float*>(y), static_cast<const float*>(mask),   \
            static_cast<float*>(u_out), static_cast<float*>(stats), S, n, R, \
            n_blocks, log_s);                                                \
    err = cudaGetLastError();                                                \
  }
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}
