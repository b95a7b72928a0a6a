// The estimator's four one-launch entries: the estimate, the estimate at a
// rotated proposal, the per-sample weights and the weights at a rotated
// proposal, each ONE round of the sweep body (sweep_body.cuh) for a batch of
// chains.
//
// Replace the TPU kernels of auxpm_tpu/ops/fused_estimator.py: _fused_kernel
// (wrapper _pallas_estimate), _fused_rot_kernel (_pallas_estimate_rot),
// _fused_weights_kernel (_pallas_weights) and _fused_rot_weights_kernel
// (_pallas_rot_weights).  Each TPU kernel walks column blocks of C on a
// sequential grid and carries the per-sample accumulator in scratch from one
// grid step to the next; blocks on this card run in no order.  Here the
// (chain, 64-row block, 64-column tile) items of the call's chains, the
// triangle of C skipped, are spread over a grid of resident blocks (two per
// SM), each item's row sums go to a global slot rowsum[chain][tile][S], and
// the block that completes a chain's LAST item folds the chain's tiles in tile
// order (fold_when_last).  It finds out by a per-chain arrival counter (its
// stores fenced, then atomicAdd): one launch that need not be cooperative,
// with no grid barrier to wait at and each chain's fold overlapping the other
// chains' items.  The fold's order does not depend on which block folds, and
// each row's arithmetic (the sum over k in one accumulator, 8 columns and a
// shuffle tree per row, the tile-order fold) is that row's alone: a chain's
// result does not depend on the other chains of its call, nor a row's weight
// on the rows that share its call.  Any S from 1 to kMaxSamples and any n: the
// TPU kernels hold the whole (S, n) block of u in VMEM, here S is a loop over
// row blocks (C streamed once per block) and a partial last tile is masked
// (sweep_body.cuh).
//
//   entry                 probe                    items           fold
//   fused_estimate        u                        every chain     estimate
//   fused_estimate_rot    u cos a + v sin a        active chains   estimate
//   fused_weights         u                        every chain     rows
//   fused_rot_weights     u cos a + v sin a        active chains   rows
//
// * The rotated entries stream u and v through the ring and rotate them in
//   place (ProbeSpec{u, v, C, cosf(a), sinf(a), 1}, u' never stored); cosf /
//   sinf in full precision, since the caller forms the accepted u'
//   afterwards and the carried estimate has to be the estimate of that u'.
// * With `active` (B,) (or null: all), every block builds the same ascending
//   list of the active chains (compact_active), the items are (active chain,
//   tile), and the blocks write 0 for the inactive chains themselves: a call
//   costs what its active chains cost.  The callers' bracket loops (the ESS
//   loop of samplers/ess_u.py, the sharded one) call these entries a dozen
//   to fifty times per step, mostly with a few chains left.  Block 0 adds
//   the number of active chains to `active_total` (or nothing if it is
//   null): the wrappers' running count.  The list is uint16: the wrappers
//   split more than sweep::kMaxChains chains into several launches.
// * "estimate": warp 0 of the folding block folds the chain's rows into
//   shared memory (S <= 64) or in place into the chain's tile-0 slots of
//   rowsum (lane s reads and writes only row s), runs the fixed 8-block
//   log-sum-exp minus log S over them (fold_estimate) and writes out[b].  "rows": it folds
//   the chain's S row sums straight into out[b][0..S) (fold_rows), with no
//   log-sum-exp: the local half of the particle-sharded estimator, where a
//   rank scores its own S_local = S / K rows against the replicated factor
//   and a collective folds the blocked partials of all ranks.  The K ranks
//   of a particle group agree bit for bit because a row's weight has the
//   same bits whichever rows share its call; at angle 0 a row of the rotated
//   weights is the row of the plain weights, and the rows of the plain
//   weights are the row sums the estimate folds.
// * At S <= 32 (a rank's S_local) the consumers of the weights and the
//   rotated entries take 2 rows each instead of 4 (probe_tiles' RPT): the 32
//   zero pad rows of a stage cost no products, and a row keeps its bits,
//   since its arithmetic is the same at RPT 2 and 4.
//
// Bound, per chain: the lower triangle of C (n(n+1)/2 floats) and S n floats
// of u (2 S n with v) read once, S n (n + 1) FLOPs.  At S = 64 and n = 640
// that is 23 (rotated) to 27 FLOPs per byte, above the card's FP32 balance
// of about 20: bound by operations; at S_local = 32 (the weights) 13 to 15:
// bound by bytes.  What holds the kernels back in fact is the body's rate
// and, at a few active chains, the longest item (sweep_body.cuh); past 64
// rows also the re-reads of C, once per row block.
//
// workspace of every entry: rowsum (B * ceil(n / 64) * S floats), then B int
// arrival counters that must be 0 at the launch.  active and active_total
// may be null.
#include "sweep_body.cuh"

namespace auxpm {

// Chain b's probe: u (and v, rotated by angle[b], where v is not null).
__device__ inline sweep::ProbeSpec probe_of(const float* u, const float* v,
                                            const float* chol,
                                            const float* angle, int b, int S,
                                            int n) {
  sweep::ProbeSpec p;
  p.u = u + size_t(b) * S * n;
  p.v = v == nullptr ? nullptr : v + size_t(b) * S * n;
  p.c = chol + size_t(b) * n * n;
  p.ca = 1.0f;
  p.sa = 0.0f;
  if (v != nullptr) {
    const float a = angle[b];
    p.ca = cosf(a);
    p.sa = sinf(a);
  }
  p.c_scale = 1.0f;
  return p;
}

// The round of every entry: the chains whose flag in `active` is set (all B
// if it is null), `zero(b)` for the others, and `fold(b)` on warp 0 of the
// block that completes chain b's last item.  All threads of the block call
// it.
template <int LIK, bool BF16, int RPT, class Zero, class Fold>
__device__ inline void one_round(
    sweep::Smem& sm, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ chol, const float* __restrict__ angle,
    const float* __restrict__ active, const float* __restrict__ y,
    const float* __restrict__ mask, float* rowsum, int* arrivals,
    int* active_total, int B, int S, int n, Zero zero, Fold fold) {
  using namespace sweep;
  const int n_tiles = col_tiles(n);
  const int items = n_tiles * row_blocks(S);   // per chain
  int n_active = B;
  if (active != nullptr) {
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      if (active[b] == 0.0f) zero(b);
    n_active = compact_active(sm, active, 1, B);
  }
  if (active_total != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(active_total, n_active);
  // the grid never exceeds the items of every chain; with an active list
  // the blocks past the active chains' items have nothing to do
  if (active != nullptr && int(blockIdx.x) >= n_active * items) return;

  init_smem(sm);
  Ring ring;
  probe_tiles<LIK, BF16, RPT>(
      sm, ring, n_active, S, n, y, mask, rowsum,
      [&](int j) { return active == nullptr ? j : int(sm.list[j]); },
      [&](int b) { return probe_of(u, v, chol, angle, b, S, n); },
      [&](int b, int) {
        fold_when_last(arrivals, b, items, [&] { fold(b); });
      });
}

// The estimate's fold: out[b], 0 for an inactive chain.
template <int LIK, bool BF16, int RPT>
__device__ inline void estimate_round(
    sweep::Smem& sm, const float* __restrict__ chol,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ angle, const float* __restrict__ active,
    const float* __restrict__ y, const float* __restrict__ mask,
    float* __restrict__ out, float* rowsum, int* arrivals,
    int* active_total, int B, int S, int n, int n_blocks, float log_s) {
  const int n_tiles = sweep::col_tiles(n);
  one_round<LIK, BF16, RPT>(
      sm, u, v, chol, angle, active, y, mask, rowsum, arrivals, active_total,
      B, S, n,
      [&](int b) {
        if (threadIdx.x == 0) out[b] = 0.0f;
      },
      [&](int b) {
        float* lw = S <= kRows ? sm.lw : rowsum + size_t(b) * n_tiles * S;
        const float est = sweep::fold_estimate(lw, rowsum, b, n_tiles, S,
                                               n_blocks, log_s);
        if (threadIdx.x == 0) out[b] = est;
      });
}

// The weights' fold: out[b][0..S), zeros for an inactive chain.
template <int LIK, bool BF16, int RPT>
__device__ inline void weights_round(
    sweep::Smem& sm, const float* __restrict__ chol,
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ angle, const float* __restrict__ active,
    const float* __restrict__ y, const float* __restrict__ mask,
    float* __restrict__ out, float* rowsum, int* arrivals,
    int* active_total, int B, int S, int n) {
  const int n_tiles = sweep::col_tiles(n);
  const int tid = threadIdx.x;
  one_round<LIK, BF16, RPT>(
      sm, u, v, chol, angle, active, y, mask, rowsum, arrivals, active_total,
      B, S, n,
      [&](int b) {
        for (int s = tid; s < S; s += blockDim.x)
          out[size_t(b) * S + s] = 0.0f;
      },
      [&](int b) {
        sweep::fold_rows(out + size_t(b) * S, rowsum, b, n_tiles, S);
      });
}

#define AUXPM_SMEM                                           \
  extern __shared__ __align__(128) unsigned char smem_raw[]; \
  sweep::Smem& sm = *reinterpret_cast<sweep::Smem*>(smem_raw)

template <int LIK, bool BF16>
__global__ void __launch_bounds__(sweep::kThreads, 2)
fused_estimate_kernel(const float* __restrict__ chol,
                      const float* __restrict__ u,
                      const float* __restrict__ y,
                      const float* __restrict__ mask,
                      float* __restrict__ out, float* rowsum, int* arrivals,
                      int B, int S, int n, int n_blocks, float log_s) {
  AUXPM_SMEM;
  estimate_round<LIK, BF16, 4>(sm, chol, u, nullptr, nullptr, nullptr, y,
                               mask, out, rowsum, arrivals, nullptr, B, S, n,
                               n_blocks, log_s);
}

template <int LIK, bool BF16, int RPT>
__global__ void __launch_bounds__(sweep::kThreads, 2)
fused_estimate_rot_kernel(const float* __restrict__ chol,
                          const float* __restrict__ u,
                          const float* __restrict__ v,
                          const float* __restrict__ angle,
                          const float* __restrict__ active,  // or nullptr
                          const float* __restrict__ y,
                          const float* __restrict__ mask,
                          float* __restrict__ out, float* rowsum,
                          int* arrivals, int* active_total, int B, int S,
                          int n, int n_blocks, float log_s) {
  AUXPM_SMEM;
  estimate_round<LIK, BF16, RPT>(sm, chol, u, v, angle, active, y, mask, out,
                                 rowsum, arrivals, active_total, B, S, n,
                                 n_blocks, log_s);
}

template <int LIK, bool BF16, int RPT>
__global__ void __launch_bounds__(sweep::kThreads, 2)
fused_weights_kernel(const float* __restrict__ chol,
                     const float* __restrict__ u,
                     const float* __restrict__ y,
                     const float* __restrict__ mask,
                     float* __restrict__ out, float* rowsum, int* arrivals,
                     int B, int S, int n) {
  AUXPM_SMEM;
  weights_round<LIK, BF16, RPT>(sm, chol, u, nullptr, nullptr, nullptr, y,
                                mask, out, rowsum, arrivals, nullptr, B, S,
                                n);
}

template <int LIK, bool BF16, int RPT>
__global__ void __launch_bounds__(sweep::kThreads, 2)
fused_rot_weights_kernel(const float* __restrict__ chol,
                         const float* __restrict__ u,
                         const float* __restrict__ v,
                         const float* __restrict__ angle,
                         const float* __restrict__ active,  // or nullptr
                         const float* __restrict__ y,
                         const float* __restrict__ mask,
                         float* __restrict__ out, float* rowsum,
                         int* arrivals, int* active_total, int B, int S,
                         int n) {
  AUXPM_SMEM;
  weights_round<LIK, BF16, RPT>(sm, chol, u, v, angle, active, y, mask, out,
                                rowsum, arrivals, active_total, B, S, n);
}

#undef AUXPM_SMEM

// One round on min(resident grid, items) blocks, not cooperative; returns
// the CUDA error of the launch.
template <class K, class... Args>
cudaError_t launch_round(K kernel, int items, void* stream, Args... args) {
  int grid = 0;
  cudaError_t err = sweep::sweep_grid(kernel, &grid);
  if (err != cudaSuccess) return err;
  if (items < grid) grid = items > 0 ? items : 1;
  kernel<<<grid, sweep::kThreads, sizeof(sweep::Smem),
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

// rowsum[B][ceil(n / 64)][S], arrivals[B]
struct Workspace {
  float* rowsum;
  int* arrivals;
  Workspace(void* base, int B, int S, int n)
      : rowsum(static_cast<float*>(base)),
        arrivals(reinterpret_cast<int*>(
            rowsum + size_t(B) * sweep::col_tiles(n) * S)) {}
};

}  // namespace auxpm

// RPT 2 at S <= 32 (a rank's S_local: no products on the pad rows), else 4.
#define AUXPM_DISPATCH_RPT(S, likelihood, bf16, LAUNCH)  \
  do {                                                   \
    if ((S) <= 32) {                                     \
      AUXPM_DISPATCH(likelihood, bf16, LAUNCH##_2);      \
    } else {                                             \
      AUXPM_DISPATCH(likelihood, bf16, LAUNCH##_4);      \
    }                                                    \
  } while (0)

#define F(p) static_cast<const float*>(p)

// ops/_build.py compiles this file once per entry, AUXPM_ENTRY = 0..3 (the
// four entries' 28 kernels took 50 s in one nvcc, the other sources at most
// 16 s); without it every entry is compiled.
#ifndef AUXPM_ENTRY
#define AUXPM_ENTRY -1
#endif

#if AUXPM_ENTRY < 0 || AUXPM_ENTRY == 0
extern "C" int auxpm_fused_estimate(const void* chol, const void* u,
                                    const void* y, const void* mask, void* out,
                                    void* workspace, int B, int S, int n,
                                    int n_blocks, float log_s, int likelihood,
                                    int bf16, void* stream) {
  using namespace auxpm;
  const Workspace ws(workspace, B, S, n);
  const int items = B * sweep::col_tiles(n) * sweep::row_blocks(S);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                     \
  err = launch_round(fused_estimate_kernel<LIK, BF>, items, stream,       \
                     F(chol), F(u), F(y), F(mask), static_cast<float*>(out), \
                     ws.rowsum, ws.arrivals, B, S, n, n_blocks, log_s)
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}
#endif

#if AUXPM_ENTRY < 0 || AUXPM_ENTRY == 1
extern "C" int auxpm_fused_estimate_rot(const void* chol, const void* u,
                                        const void* v, const void* angle,
                                        const void* active, const void* y,
                                        const void* mask, void* out,
                                        void* workspace, void* active_total,
                                        int B, int S, int n, int n_blocks,
                                        float log_s, int likelihood, int bf16,
                                        void* stream) {
  using namespace auxpm;
  const Workspace ws(workspace, B, S, n);
  const int items = B * sweep::col_tiles(n) * sweep::row_blocks(S);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF, RPT)                                                \
  err = launch_round(fused_estimate_rot_kernel<LIK, BF, RPT>, items,      \
                     stream, F(chol), F(u), F(v), F(angle), F(active),    \
                     F(y), F(mask), static_cast<float*>(out), ws.rowsum,  \
                     ws.arrivals, static_cast<int*>(active_total), B, S, n, \
                     n_blocks, log_s)
#define CALL_2(LIK, BF) CALL(LIK, BF, 2)
#define CALL_4(LIK, BF) CALL(LIK, BF, 4)
  AUXPM_DISPATCH_RPT(S, likelihood, bf16 != 0, CALL);
#undef CALL_4
#undef CALL_2
#undef CALL
  return static_cast<int>(err);
}
#endif

#if AUXPM_ENTRY < 0 || AUXPM_ENTRY == 2
extern "C" int auxpm_fused_weights(const void* chol, const void* u,
                                   const void* y, const void* mask, void* out,
                                   void* workspace, int B, int S, int n,
                                   int likelihood, int bf16, void* stream) {
  using namespace auxpm;
  const Workspace ws(workspace, B, S, n);
  const int items = B * sweep::col_tiles(n) * sweep::row_blocks(S);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF, RPT)                                                 \
  err = launch_round(fused_weights_kernel<LIK, BF, RPT>, items, stream,    \
                     F(chol), F(u), F(y), F(mask), static_cast<float*>(out), \
                     ws.rowsum, ws.arrivals, B, S, n)
#define CALL_2(LIK, BF) CALL(LIK, BF, 2)
#define CALL_4(LIK, BF) CALL(LIK, BF, 4)
  AUXPM_DISPATCH_RPT(S, likelihood, bf16 != 0, CALL);
#undef CALL_4
#undef CALL_2
#undef CALL
  return static_cast<int>(err);
}
#endif

#if AUXPM_ENTRY < 0 || AUXPM_ENTRY == 3
extern "C" int auxpm_fused_rot_weights(const void* chol, const void* u,
                                       const void* v, const void* angle,
                                       const void* active, const void* y,
                                       const void* mask, void* out,
                                       void* workspace, void* active_total,
                                       int B, int S, int n, int likelihood,
                                       int bf16, void* stream) {
  using namespace auxpm;
  const Workspace ws(workspace, B, S, n);
  const int items = B * sweep::col_tiles(n) * sweep::row_blocks(S);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF, RPT)                                                 \
  err = launch_round(fused_rot_weights_kernel<LIK, BF, RPT>, items, stream, \
                     F(chol), F(u), F(v), F(angle), F(active), F(y),       \
                     F(mask), static_cast<float*>(out), ws.rowsum,         \
                     ws.arrivals, static_cast<int*>(active_total), B, S, n)
#define CALL_2(LIK, BF) CALL(LIK, BF, 2)
#define CALL_4(LIK, BF) CALL(LIK, BF, 4)
  AUXPM_DISPATCH_RPT(S, likelihood, bf16 != 0, CALL);
#undef CALL_4
#undef CALL_2
#undef CALL
  return static_cast<int>(err);
}
#endif

#undef F
#undef AUXPM_DISPATCH_RPT
