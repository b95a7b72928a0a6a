// Whole elliptical-slice sweep of u | theta: all repeats and every
// bracket-shrink probe of every chain inside ONE cooperative launch.
//
// Replaces the TPU kernel auxpm_tpu/ops/ess_sweep.py::_ess_sweep_kernel
// (wrapper _pallas_ess_sweep).  The property kept is that each chain runs
// exactly its OWN probe count.  The layout is not the TPU's (one grid step
// per chain with C resident): the sweep advances in rounds over the whole
// card (sweep_body.cuh).  In a round every active chain makes its next
// probe: phase A spreads the (chain, 64-column tile) items of all of them
// over every block, a grid barrier, then phase B gives each active chain to
// one block, whose warp 0 folds the chain's tile sums, runs the fixed 8-block
// log-sum-exp, compares with log y and moves the bracket: it publishes the
// next angle, or, on accept, the whole block rewrites
// u' = u cos a + v_r sin a and the chain moves to its next repeat.  A second
// grid barrier closes the round.  The semantics are those of the plain
// version (ops/ess_sweep._ref_ess_sweep): the same scal columns, at most 32
// shrinks per repeat, cap-hit keeps the state, stats = (ll, n_shrink, moved,
// 0).  A chain's probes follow each other in consecutive rounds, so the
// number of rounds is the largest probe count of any chain.
//
// State between rounds lives in a small global workspace (the wrapper's): per
// chain kState floats (repeat, shrinks so far, angle, bracket, ll, log y,
// counts, active flag) in two buffers, read in one round and written for the
// next; the tile sums rowsum[chain][tile][S]; last, the number of rounds the
// launch took.  Phase B folds a chain's S log-weights in the block's idle
// ring.  Any S up to kMaxSamples (row blocks of 64, C streamed once per block)
// and n a multiple of 64 (the wrapper's gate: only a padded target gets a
// sweep, as in the reference).  In phase B a chain has max(1, grid / B)
// blocks: each folds and decides (the same floats give the same decision),
// the first writes the next state, and each rewrites its slice of u' (float4,
// through L2): a first version left the rewrite (492 KB of traffic per
// accepted chain) to one block per chain.  u_out is the working buffer, as
// in the reference.
//
// Bound: operations.  S n (n + 64) / 2 FMAs per probe with the triangle
// skipped (the least work is S n (n + 1) FLOPs), against one read of (C, u,
// v, scal) and one write of u'.  Grid barriers: 1 + 2 per round.  The
// cooperative launch helpers are sweep_body.cuh's, shared with the sigma
// sweep.
#include "sweep_body.cuh"

namespace auxpm {

constexpr int kScalCols = 3 + kMaxShrink;
constexpr int kState = 16;
// state slots
constexpr int kRep = 0, kShrink = 1, kA = 2, kAMin = 3, kAMax = 4, kLL = 5,
              kLogY = 6, kNShrink = 7, kMoved = 8, kActive = 9;
constexpr float kTwoPi = 6.2831855f;

template <int LIK, bool BF16>
__global__ void __launch_bounds__(sweep::kThreads, 2)
ess_sweep_kernel(const float* __restrict__ chol, const float* __restrict__ u,
                 const float* __restrict__ scal, const float* __restrict__ v,
                 const float* __restrict__ y, const float* __restrict__ mask,
                 float* u_out, float* __restrict__ stats, float* state,
                 float* rowsum, float* rounds, int B, int S, int n, int R,
                 int n_blocks, float log_s) {
  namespace cg = cooperative_groups;
  using namespace sweep;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int sn = S * n;
  const int n_tiles = col_tiles(n);

  init_smem(sm);

  // every chain at the first probe of its first repeat (state buffer 0);
  // u_out = u
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* sc = scal + size_t(b) * R * kScalCols;
    if (tid == 0) {
      float* st = state + size_t(b) * kState;
      const float a = sc[2];
      st[kRep] = 0.0f;
      st[kShrink] = 0.0f;
      st[kA] = a;
      st[kAMin] = a - kTwoPi;
      st[kAMax] = a;
      st[kLL] = sc[0];
      st[kLogY] = sc[0] + sc[1];
      st[kNShrink] = 0.0f;
      st[kMoved] = 0.0f;
      st[kActive] = 1.0f;
    }
    const float* ub = u + size_t(b) * sn;
    float* uo = u_out + size_t(b) * sn;
    for (int idx = tid; idx < sn; idx += blockDim.x) uo[idx] = ub[idx];
  }
  grid.sync();

  // phase B: `per_chain` blocks per chain (the grid's spare blocks share the
  // rewrite of u'); all of them fold and decide alike, the first writes the
  // chain's next state
  const int per_chain = max(1, int(gridDim.x) / B);
  const int chains_per_pass = int(gridDim.x) / per_chain;
  const int slice = int(blockIdx.x) % per_chain;
  const int sn4 = sn / 4;   // 64 divides n
  const int slice_len = (sn4 + per_chain - 1) / per_chain;

  Ring ring;
  for (int round = 0;; ++round) {
    // state is double-buffered: read this round's, write the next
    const float* cur = state + size_t(round & 1) * B * kState;
    float* nxt = state + size_t((round + 1) & 1) * B * kState;
    const int n_active = compact_active(sm, cur + kActive, kState, B);
    if (n_active == 0) {        // the same flags in every block
      if (blockIdx.x == 0 && tid == 0) *rounds = float(round);
      break;
    }

    // ------------------------------------------------ phase A: the probes
    probe_tiles<LIK, BF16>(
        sm, ring, n_active, S, n, y, mask, rowsum,
        [&](int j) { return int(sm.list[j]); },
        [&](int b) {
          const float* st = cur + size_t(b) * kState;
          const int r = int(__ldcg(st + kRep));
          const float a = __ldcg(st + kA);
          ProbeSpec p;
          p.u = u_out + size_t(b) * sn;
          p.v = v + (size_t(b) * R + r) * sn;
          p.c = chol + size_t(b) * n * n;
          p.ca = cosf(a);
          p.sa = sinf(a);
          p.c_scale = 1.0f;
          return p;
        },
        [](int, int) {});
    grid.sync();

    // ---------------------------------------------- phase B: the decisions
    for (int base = 0; base < B; base += chains_per_pass) {
      const int b = base + int(blockIdx.x) / per_chain;
      if (int(blockIdx.x) / per_chain >= chains_per_pass || b >= B) continue;
      const float* st = cur + size_t(b) * kState;
      float* st_next = nxt + size_t(b) * kState;
      if (__ldcg(st + kActive) == 0.0f) {    // uniform in the block
        if (slice == 0 && tid == 0) st_next[kActive] = 0.0f;
        continue;
      }
      if (tid < 32) {
        const float ll_p =
            fold_estimate(idle_ring(sm), rowsum, b, n_tiles, S, n_blocks,
                        log_s);
        if (tid == 0) {
          int r = int(__ldcg(st + kRep)), i = int(__ldcg(st + kShrink));
          float a = __ldcg(st + kA), a_min = __ldcg(st + kAMin);
          float a_max = __ldcg(st + kAMax), ll = __ldcg(st + kLL);
          float log_y = __ldcg(st + kLogY);
          float n_shrink = __ldcg(st + kNShrink), moved = __ldcg(st + kMoved);
          float active = 1.0f;
          const float* row = scal + (size_t(b) * R + r) * kScalCols;
          const bool done = ll_p > log_y;
          bool next_repeat = false;
          sm.bcast[0] = 0.0f;
          if (done) {                       // accept: u' at angle a
            ll = ll_p;
            n_shrink += float(i);
            moved += 1.0f;
            sm.bcast[0] = 1.0f;
            sm.bcast[1] = a;
            sm.bcast[2] = float(r);
            next_repeat = true;
          } else if (i < kMaxShrink) {      // shrink toward 0, next angle
            a_min = a < 0.0f ? a : a_min;
            a_max = a < 0.0f ? a_max : a;
            a = a_min + (a_max - a_min) * row[3 + i];
            ++i;
          } else {                          // cap-hit: keep the state
            n_shrink += float(i);
            next_repeat = true;
          }
          if (next_repeat) {
            ++r;
            if (r < R) {
              row += kScalCols;
              a = row[2];
              a_min = a - kTwoPi;
              a_max = a;
              log_y = ll + row[1];
              i = 0;
            } else {
              active = 0.0f;
              if (slice == 0) {
                float* out = stats + size_t(b) * 4;
                out[0] = ll;
                out[1] = n_shrink;
                out[2] = moved;
                out[3] = 0.0f;
              }
            }
          }
          if (slice == 0) {
            st_next[kRep] = float(r);
            st_next[kShrink] = float(i);
            st_next[kA] = a;
            st_next[kAMin] = a_min;
            st_next[kAMax] = a_max;
            st_next[kLL] = ll;
            st_next[kLogY] = log_y;
            st_next[kNShrink] = n_shrink;
            st_next[kMoved] = moved;
            st_next[kActive] = active;
          }
        }
      }
      __syncthreads();
      if (sm.bcast[0] != 0.0f) {            // this block's slice of u'
        const float ang = sm.bcast[1];
        const float ca = cosf(ang), sa = sinf(ang);
        float4* uo = reinterpret_cast<float4*>(u_out + size_t(b) * sn);
        const float4* vr = reinterpret_cast<const float4*>(
            v + (size_t(b) * R + int(sm.bcast[2])) * sn);
        const int end = min(sn4, (slice + 1) * slice_len);
#pragma unroll 4
        for (int idx = slice * slice_len + tid; idx < end;
             idx += blockDim.x) {
          float4 x = __ldcg(uo + idx);
          const float4 w = __ldg(vr + idx);
          x.x = x.x * ca + w.x * sa;
          x.y = x.y * ca + w.y * sa;
          x.z = x.z * ca + w.z * sa;
          x.w = x.w * ca + w.w * sa;
          uo[idx] = x;
        }
      }
      __syncthreads();   // sm.bcast and the folded weights are reused by
                         // the next chain
    }
    grid.sync();
  }
}

// A cooperative kernel of the sweep body's shape (block size, shared
// memory, two blocks per SM) that only passes one grid barrier.
__global__ void __launch_bounds__(sweep::kThreads, 2) grid_check_kernel() {
  cooperative_groups::this_grid().sync();
}

}  // namespace auxpm

// Blocks of the grid every kernel of the sweep body launches on the current
// device (occupancy x SMs: the launch bounds and the shared memory make it
// two blocks per SM for each of them), or minus the CUDA error.
extern "C" int auxpm_sweep_grid() {
  int grid = 0;
  const cudaError_t err = auxpm::sweep::sweep_grid(auxpm::grid_check_kernel,
                                                   &grid);
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

// The CUDA error of a cooperative launch of the sweep body's shape on that
// grid plus `extra` blocks: 0 for extra = 0, and the card must refuse any
// extra > 0, since the blocks of a grid barrier have to be resident
// together.
extern "C" int auxpm_cooperative_launch_check(int extra) {
  using namespace auxpm;
  int grid = 0;
  cudaError_t err = sweep::sweep_grid(grid_check_kernel, &grid);
  void* no_args[1] = {nullptr};
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(grid_check_kernel), grid + extra,
        sweep::kThreads, no_args, sizeof(sweep::Smem), nullptr);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaGetLastError();   // clears a refused launch's error (it is not sticky)
  return static_cast<int>(err);
}

extern "C" int auxpm_ess_sweep(const void* chol, const void* u,
                               const void* scal, const void* v, const void* y,
                               const void* mask, void* u_out, void* stats,
                               void* workspace, int B, int S, int n, int R,
                               int n_blocks, float log_s, int likelihood,
                               int bf16, void* stream) {
  using namespace auxpm;
  const float* chol_ = static_cast<const float*>(chol);
  const float* u_ = static_cast<const float*>(u);
  const float* scal_ = static_cast<const float*>(scal);
  const float* v_ = static_cast<const float*>(v);
  const float* y_ = static_cast<const float*>(y);
  const float* mask_ = static_cast<const float*>(mask);
  float* u_out_ = static_cast<float*>(u_out);
  float* stats_ = static_cast<float*>(stats);
  float* state_ = static_cast<float*>(workspace);
  float* rowsum_ = state_ + 2 * size_t(B) * kState;
  float* rounds_ = rowsum_ + size_t(B) * sweep::col_tiles(n) * S;
  void* args[] = {&chol_,  &u_,     &scal_,   &v_,      &y_,      &mask_,
                  &u_out_, &stats_, &state_,  &rowsum_, &rounds_, &B,
                  &S,      &n,      &R,       &n_blocks, &log_s};
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                              \
  err = sweep::launch_cooperative(ess_sweep_kernel<LIK, BF>, args,  \
                                  static_cast<cudaStream_t>(stream))
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}
