// Fused whiten -> likelihood -> log-sum-exp estimator, one launch for a batch
// of chains.
//
// Replaces the TPU kernel auxpm_tpu/ops/fused_estimator.py::_fused_kernel
// (wrapper _pallas_estimate).  The TPU kernel walks column blocks of C on a
// sequential grid and carries the per-sample accumulator in scratch from one
// grid step to the next; blocks on this card run in no order.  Here the
// estimate is ONE round of the sweep body (sweep_body.cuh): the (chain,
// 64-column tile) items of all B chains, the triangle of C skipped, are
// spread over a grid of resident blocks (two per SM), each item's row sums
// go to a global slot, and the block that completes a chain's LAST item
// folds the chain's tiles in tile order and runs the fixed 8-block
// log-sum-exp (fold_estimate).  It finds out by a per-chain arrival counter
// (its stores fenced, then atomicAdd): one launch that need not be
// cooperative, with no grid barrier to wait at and each chain's fold
// overlapping the other chains' items; the fold's order does not depend on
// which block folds, so a chain's estimate does not depend on the batch.
// What this replaces (probe.cuh, one block per chain) contracted the whole
// square of C and filled a 164 KB left operand first, which allowed one
// block per SM: at B=64, 64 of 132 SMs worked.  The estimate shares its f32
// expression with the two sweeps and the fourth entry below, not with the
// second and third (probe.cuh).
//
// Bound: operations.  Per chain it must read the lower triangle of C
// (n(n+1)/2 floats) and u (S n) once and write one float, and it does
// S n (n + 1) FLOPs: about S/2 = 32 FLOPs per byte of C at S=64, above the
// card's FP32 balance of about 20.
//
// Second entry, the rotated estimator: the same estimate at the proposal
// u' = u cos a + v sin a of the elliptical-slice loop, u' never stored.
// Replaces auxpm_tpu/ops/fused_estimator.py::_fused_rot_kernel (wrapper
// _pallas_estimate_rot), which forms u' per column tile next to the matrix
// unit.  Here u and v together (2 x 164 KB at S=64, n=640) do not fit a
// block's 227 KB, so the block reads both from global memory once per call
// and forms u' straight into the shared-memory left operand (fill_left);
// from there it is probe.cuh's body, which contracts the whole square of C
// (its design note is there).  Per call and chain the least traffic is
// 2*S*n*4 bytes of u and v on top of the lower triangle of C, and the least
// work S n (n + 1) FLOPs: bound by operations at S=64.  The
// caller's bracket loop is batched with a per-chain `done` flag; `active`
// (B,) lets the block of a finished chain return at once (its output is 0),
// so a round costs what its unfinished chains cost.  cosf / sinf in full
// precision: the accepted u' is formed afterwards by the caller, and the
// carried estimate has to be the estimate of that u'.
//
// Third entry, the per-sample weights: the (S_local,) log-weights of the
// block's rows with NO log-sum-exp.  Replaces
// auxpm_tpu/ops/fused_estimator.py::_fused_weights_kernel (wrapper
// _pallas_weights), the local half of the particle-sharded estimator: a rank
// scores its own S_local = S / K rows against the replicated factor and a
// collective folds the blocked partials of all ranks.  It is probe_weights
// of probe.cuh and a store of sm.lw, so a row gives the same bits whichever
// rows share its call.  Bound: bytes (the lower triangle of C is read for
// S_local rows: about S_local/2 = 16 FLOPs per byte at S_local = 32, below
// the card's FP32 balance of 20).  A block computes kRows = 64 rows, so at
// S_local = 32 half of its products are on zero pad rows.
//
// Fourth entry, the rotated per-sample weights: the same at the proposal
// u cos a + v sin a of the sharded elliptical-slice bracket loop.  Replaces
// auxpm_tpu/ops/fused_estimator.py::_fused_rot_weights_kernel (wrapper
// _pallas_rot_weights).  One round of the sweep body, like the plain
// estimate: every block builds the list of ACTIVE chains from `active` in
// ascending order (compact_active), the items are (active chain, 64-column
// tile) with ProbeSpec{u, v, C, cosf(a), sinf(a), 1} (u and v stream through
// the ring and are rotated in place; cosf / sinf in full precision, since
// the caller forms the accepted u' afterwards), the triangle of C skipped,
// and the block that completes a chain's last item (fold_when_last) writes
// its S_local row sums folded in tile order.  Each row's weight is the sum
// over k in one accumulator, the column tree and the tile fold of that row
// alone, so it has the same bits whichever rows share its call; the rows
// past S_local of a stage stay zero.  The blocks zero the rows of inactive
// chains themselves, and a call costs what its active chains cost: the
// bracket loop calls it ~53 times per step and rank, mostly with a few
// chains left.  What this replaces (probe.cuh, one block per chain, a 164 KB
// left operand, the whole square of C) lasted as long as one chain's whole
// probe on one SM whether 128 chains were active or 3.  Bound: bytes, as
// above (plus S_local n floats of v per chain).  At S_local <= 32 the
// consumers take 2 rows each instead of 4 (probe_tiles' RPT): the 32 pad
// rows of a stage cost no products, and a row keeps its bits, since its
// arithmetic is the same at RPT 2 and 4.  Block 0 adds the number of
// active chains to `active_total` (or nothing if it is null): the wrapper's
// running count, read by chip_smoke.py.
#include "sweep_body.cuh"

namespace auxpm {

template <int LIK, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
fused_weights_kernel(const float* __restrict__ chol,
                     const float* __restrict__ u,
                     const float* __restrict__ y,
                     const float* __restrict__ mask,
                     float* __restrict__ out, int S, int n) {
  extern __shared__ __align__(16) float smem[];
  const ProbeSmem sm = carve_smem(smem, n);
  const int b = blockIdx.x;
  const float* ub = u + size_t(b) * S * n;
  zero_pad_rows(sm, S, n);
  fill_left<BF16>(sm, S, n, [&](int idx) { return ub[idx]; });
  probe_weights<LIK, BF16>(sm, chol + size_t(b) * n * n, 1.0f, y, mask, n);
  if (threadIdx.x < S) out[size_t(b) * S + threadIdx.x] = sm.lw[threadIdx.x];
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
  using namespace sweep;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int sn = S * n;
  const int n_tiles = n / kCols;

  int n_active = B;
  if (active != nullptr) {
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      if (active[b] == 0.0f && tid < S) out[size_t(b) * S + tid] = 0.0f;
    n_active = compact_active(sm, active, 1, B);
  }
  if (active_total != nullptr && blockIdx.x == 0 && tid == 0)
    atomicAdd(active_total, n_active);
  if (int(blockIdx.x) >= n_active * n_tiles) return;   // uniform in the block

  init_smem(sm);
  Ring ring;
  probe_tiles<LIK, BF16, RPT>(
      sm, ring, n_active, S, n, y, mask, rowsum,
      [&](int j) { return active == nullptr ? j : int(sm.list[j]); },
      [&](int b) {
        const float a = angle[b];
        ProbeSpec p;
        p.u = u + size_t(b) * sn;
        p.v = v + size_t(b) * sn;
        p.c = chol + size_t(b) * n * n;
        p.ca = cosf(a);
        p.sa = sinf(a);
        p.c_scale = 1.0f;
        return p;
      },
      [&](int b, int) {
        fold_when_last(arrivals, b, n_tiles, [&] {
          fold_rows(sm, rowsum, b, n_tiles, S);
          for (int s = tid; s < S; s += 32) out[size_t(b) * S + s] = sm.lw[s];
        });
      });
}

template <int LIK, bool BF16>
__global__ void __launch_bounds__(sweep::kThreads, 2)
fused_estimate_kernel(const float* __restrict__ chol,
                      const float* __restrict__ u,
                      const float* __restrict__ y,
                      const float* __restrict__ mask,
                      float* __restrict__ out, float* rowsum, int* arrivals,
                      int B, int S, int n, int n_blocks, float log_s) {
  using namespace sweep;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int sn = S * n;
  const int n_tiles = n / kCols;

  init_smem(sm);
  Ring ring;
  probe_tiles<LIK, BF16>(
      sm, ring, B, S, n, y, mask, rowsum, [](int j) { return j; },
      [&](int b) {
        ProbeSpec p;
        p.u = u + size_t(b) * sn;
        p.v = nullptr;
        p.c = chol + size_t(b) * n * n;
        p.ca = 1.0f;
        p.sa = 0.0f;
        p.c_scale = 1.0f;
        return p;
      },
      [&](int b, int) {
        fold_when_last(arrivals, b, n_tiles, [&] {
          const float est =
              fold_estimate(sm, rowsum, b, n_tiles, S, n_blocks, log_s);
          if (tid == 0) out[b] = est;
        });
      });
}

template <int LIK, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
fused_estimate_rot_kernel(const float* __restrict__ chol,
                          const float* __restrict__ u,
                          const float* __restrict__ v,
                          const float* __restrict__ angle,
                          const float* __restrict__ active,  // or nullptr
                          const float* __restrict__ y,
                          const float* __restrict__ mask,
                          float* __restrict__ out, int S, int n, int n_blocks,
                          float log_s) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  if (active != nullptr && active[b] == 0.0f) {  // uniform over the block
    if (threadIdx.x == 0) out[b] = 0.0f;
    return;
  }
  const ProbeSmem sm = carve_smem(smem, n);
  const float* ub = u + size_t(b) * S * n;
  const float* vb = v + size_t(b) * S * n;
  const float ca = cosf(angle[b]), sa = sinf(angle[b]);
  zero_pad_rows(sm, S, n);
  fill_left<BF16>(sm, S, n,
                  [&](int idx) { return ub[idx] * ca + vb[idx] * sa; });
  const float est = probe_estimate<LIK, BF16>(
      sm, chol + size_t(b) * n * n, 1.0f, y, mask, S, n, n_blocks, log_s);
  if (threadIdx.x == 0) out[b] = est;
}

}  // namespace auxpm

extern "C" int auxpm_fused_estimate_rot(const void* chol, const void* u,
                                        const void* v, const void* angle,
                                        const void* active, const void* y,
                                        const void* mask, void* out, int B,
                                        int S, int n, int n_blocks,
                                        float log_s, int likelihood, int bf16,
                                        void* stream) {
  using namespace auxpm;
  const size_t smem = probe_smem_bytes(n);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                        \
  err = allow_smem(fused_estimate_rot_kernel<LIK, BF>, smem);                \
  if (err == cudaSuccess) {                                                  \
    fused_estimate_rot_kernel<LIK, BF>                                       \
        <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(          \
            static_cast<const float*>(chol), static_cast<const float*>(u),   \
            static_cast<const float*>(v), static_cast<const float*>(angle),  \
            static_cast<const float*>(active), static_cast<const float*>(y), \
            static_cast<const float*>(mask), static_cast<float*>(out), S, n, \
            n_blocks, log_s);                                                \
    err = cudaGetLastError();                                                \
  }
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}

// workspace: rowsum (B * n / 64 * 64 floats), then B int arrival counters
// that must be 0 at the launch.
extern "C" int auxpm_fused_estimate(const void* chol, const void* u,
                                    const void* y, const void* mask, void* out,
                                    void* workspace, int B, int S, int n,
                                    int n_blocks, float log_s, int likelihood,
                                    int bf16, void* stream) {
  using namespace auxpm;
  float* rowsum = static_cast<float*>(workspace);
  int* arrivals =
      reinterpret_cast<int*>(rowsum + size_t(B) * (n / sweep::kCols) * kRows);
  const int items = B * (n / sweep::kCols);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                        \
  do {                                                                       \
    int grid = 0;                                                            \
    err = sweep::sweep_grid(fused_estimate_kernel<LIK, BF>, &grid);          \
    if (err == cudaSuccess) {                                                \
      if (items < grid) grid = items;                                        \
      fused_estimate_kernel<LIK, BF>                                         \
          <<<grid, sweep::kThreads, sizeof(sweep::Smem),                     \
             static_cast<cudaStream_t>(stream)>>>(                           \
              static_cast<const float*>(chol), static_cast<const float*>(u), \
              static_cast<const float*>(y), static_cast<const float*>(mask), \
              static_cast<float*>(out), rowsum, arrivals, B, S, n, n_blocks, \
              log_s);                                                        \
      err = cudaGetLastError();                                              \
    }                                                                        \
  } while (0)
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}

extern "C" int auxpm_fused_weights(const void* chol, const void* u,
                                   const void* y, const void* mask, void* out,
                                   int B, int S, int n, int likelihood,
                                   int bf16, void* stream) {
  using namespace auxpm;
  const size_t smem = probe_smem_bytes(n);
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                        \
  err = allow_smem(fused_weights_kernel<LIK, BF>, smem);                     \
  if (err == cudaSuccess) {                                                  \
    fused_weights_kernel<LIK, BF>                                            \
        <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(          \
            static_cast<const float*>(chol), static_cast<const float*>(u),   \
            static_cast<const float*>(y), static_cast<const float*>(mask),   \
            static_cast<float*>(out), S, n);                                 \
    err = cudaGetLastError();                                                \
  }
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}

// workspace: rowsum (B * n / 64 * 64 floats), then B int arrival counters
// that must be 0 at the launch.  active and active_total may be null.
extern "C" int auxpm_fused_rot_weights(const void* chol, const void* u,
                                       const void* v, const void* angle,
                                       const void* active, const void* y,
                                       const void* mask, void* out,
                                       void* workspace, void* active_total,
                                       int B, int S, int n, int likelihood,
                                       int bf16, void* stream) {
  using namespace auxpm;
  float* rowsum = static_cast<float*>(workspace);
  int* arrivals =
      reinterpret_cast<int*>(rowsum + size_t(B) * (n / sweep::kCols) * kRows);
  const int items = B * (n / sweep::kCols);
  cudaError_t err = cudaSuccess;
#define LAUNCH(LIK, BF, RPT)                                                 \
  do {                                                                       \
    int grid = 0;                                                            \
    err = sweep::sweep_grid(fused_rot_weights_kernel<LIK, BF, RPT>, &grid);  \
    if (err == cudaSuccess) {                                                \
      if (items < grid) grid = items;                                        \
      fused_rot_weights_kernel<LIK, BF, RPT>                                 \
          <<<grid, sweep::kThreads, sizeof(sweep::Smem),                     \
             static_cast<cudaStream_t>(stream)>>>(                           \
              static_cast<const float*>(chol), static_cast<const float*>(u), \
              static_cast<const float*>(v),                                  \
              static_cast<const float*>(angle),                              \
              static_cast<const float*>(active),                             \
              static_cast<const float*>(y), static_cast<const float*>(mask), \
              static_cast<float*>(out), rowsum, arrivals,                    \
              static_cast<int*>(active_total), B, S, n);                     \
      err = cudaGetLastError();                                              \
    }                                                                        \
  } while (0)
  // S <= 32 (a rank's S_local): 2 rows per thread, no products on pad rows
#define CALL(LIK, BF)       \
  if (S <= 32) {            \
    LAUNCH(LIK, BF, 2);     \
  } else {                  \
    LAUNCH(LIK, BF, 4);     \
  }
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
#undef LAUNCH
  return static_cast<int>(err);
}
