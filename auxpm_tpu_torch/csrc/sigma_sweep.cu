// Whole log_sigma slice sweep: all 1 + n_sigma_extra shrinkage-only slice
// updates of every chain, off the carried factor C0 = chol(R + jitter I),
// inside ONE cooperative launch.
//
// Replaces the TPU kernel auxpm_tpu/ops/sigma_sweep.py::_sigma_sweep_kernel
// (wrapper _pallas_sigma_sweep).  A probe at candidate x evaluates
//     ll(x) = estimate(u, exp(x) C0),  lp(x) = lp_rest - hiv (x - mu)^2 + ll(x)
// with the scale applied to each element of C0 BEFORE the product, exactly as
// the reference states it: log L-hat stays one fixed function of (theta, u),
// the expression of the per-probe path.  The scale is never factored out of
// the product (u C0^T once, rescaled probes after it): that is another f32
// function and would break the estimator identity.
//
// The property kept is that each chain runs exactly its OWN probe count.  The
// layout is not the TPU's (one grid step per chain with C0 resident): the
// sweep advances in rounds over the whole card (sweep_body.cuh), like the ESS
// sweep.  In a round every active chain makes its next probe: phase A spreads
// the (chain, 64-column tile) items of all of them over every block, with
// ProbeSpec{u, v = nullptr, C0, c_scale = expf(x)}: u and C0 stream through
// the ring, no v, and the consumers scale each chunk of C0 in place (one
// consumer barrier per chunk; scaling the float4s of C as the product loads
// them gives the same f32 products but 16 times the multiplies).  A grid
// barrier, then phase B: warp 0 of one block per active chain folds the
// chain's tile sums, runs the fixed 8-block log-sum-exp, forms lp(x),
// compares it with log y = lp + rep[r, 0] and moves the bracket as
// ops/sigma_sweep._ref_sigma_sweep does: on accept the point moves to x, at
// the 32-probe cap it stays bitwise where it was, and either way the chain
// goes to its next repeat; otherwise it publishes its next candidate
// l + (rt - l) rep[r, 2 + i].  A second grid barrier closes the round.  A
// chain's probes follow each other in consecutive rounds, so the number of
// rounds is the largest probe count of any chain.  stats = (sigma', ll', lp',
// n_shrink, moved, 0, 0, 0).
//
// State between rounds lives in the wrapper's global workspace: per chain
// kState floats (repeat, probes in this repeat, bracket, candidate, point,
// lp, ll, log y, counts, active flag) in two buffers, read in one round and
// written for the next (a chain that finishes clears its flag in both); the
// tile sums rowsum[chain][tile][S]; last, the number of rounds.  Phase B
// folds a chain's S log-weights in the block's idle ring.  Any S up to
// kMaxSamples and n a multiple of 64 (the wrapper's gate, as the ESS
// sweep's).
//
// Bound: operations.  S n (n + 64) / 2 FMAs per probe with the triangle
// skipped (the least work is S n (n + 1) FLOPs), against one read of the
// lower triangle of C0, of u and of (chain, rep) and 8 floats written per
// chain.  Grid barriers: 1 + 2 per round.
#include "sweep_body.cuh"

namespace auxpm {

constexpr int kRepCols = 2 + kMaxShrink;
constexpr int kState = 16;
// state slots
constexpr int kRep = 0, kShrink = 1, kL = 2, kRt = 3, kX = 4, kSig = 5,
              kLp = 6, kLl = 7, kLogY = 8, kNShrink = 9, kMoved = 10,
              kActive = 11;

template <int LIK, bool BF16>
__global__ void __launch_bounds__(sweep::kThreads, 2)
sigma_sweep_kernel(const float* __restrict__ chol0,
                   const float* __restrict__ u,
                   const float* __restrict__ chain,
                   const float* __restrict__ rep,
                   const float* __restrict__ y,
                   const float* __restrict__ mask, float* __restrict__ stats,
                   float* state, float* rowsum, float* rounds, int B, int S,
                   int n, int R, int n_blocks, float log_s) {
  namespace cg = cooperative_groups;
  using namespace sweep;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int sn = S * n;
  const int n_tiles = col_tiles(n);

  init_smem(sm);

  // every chain at the first candidate of its first repeat (state buffer 0)
  if (tid == 0) {
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const float* ch = chain + size_t(b) * 8;
      const float* row = rep + size_t(b) * R * kRepCols;
      const float sig = ch[2], lp = ch[1], w = ch[3];
      const float l = sig - w * row[1];
      const float rt = l + w;
      float* st = state + size_t(b) * kState;
      st[kRep] = 0.0f;
      st[kShrink] = 0.0f;
      st[kL] = l;
      st[kRt] = rt;
      st[kX] = l + (rt - l) * row[2];
      st[kSig] = sig;
      st[kLp] = lp;
      st[kLl] = ch[0];
      st[kLogY] = lp + row[0];
      st[kNShrink] = 0.0f;
      st[kMoved] = 0.0f;
      st[kActive] = 1.0f;
    }
  }
  grid.sync();

  Ring ring;
  for (int round = 0;; ++round) {
    // state is double-buffered: read this round's, write the next
    float* cur = state + size_t(round & 1) * B * kState;
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
          ProbeSpec p;
          p.u = u + size_t(b) * sn;
          p.v = nullptr;
          p.c = chol0 + size_t(b) * n * n;
          p.ca = 1.0f;
          p.sa = 0.0f;
          p.c_scale = expf(__ldcg(cur + size_t(b) * kState + kX));
          return p;
        },
        [](int, int) {});
    grid.sync();

    // ---------------------------------------------- phase B: the decisions
    for (int j = blockIdx.x; j < n_active && tid < 32; j += gridDim.x) {
      const int b = sm.list[j];
      const float ll_x =
          fold_estimate(idle_ring(sm), rowsum, b, n_tiles, S, n_blocks,
                        log_s);
      if (tid != 0) continue;
      const float* ch = chain + size_t(b) * 8;
      const float w = ch[3], mu = ch[4], hiv = ch[5], lp_rest = ch[6];
      float* st = cur + size_t(b) * kState;
      float* st_next = nxt + size_t(b) * kState;
      int r = int(__ldcg(st + kRep)), i = int(__ldcg(st + kShrink));
      float l = __ldcg(st + kL), rt = __ldcg(st + kRt);
      const float x = __ldcg(st + kX);
      float sig = __ldcg(st + kSig), lp = __ldcg(st + kLp);
      float ll = __ldcg(st + kLl), log_y = __ldcg(st + kLogY);
      float n_shrink = __ldcg(st + kNShrink), moved = __ldcg(st + kMoved);
      const float* row = rep + (size_t(b) * R + r) * kRepCols;

      const float d = x - mu;
      const float lp_x = lp_rest - hiv * d * d + ll_x;
      const bool done = lp_x > log_y;
      if (!(done || x >= sig)) l = x;
      if (!(done || x < sig)) rt = x;
      ++i;
      float active = 1.0f;
      if (done || i == kMaxShrink) {   // this repeat ends
        if (done) {                    // accept; at the cap the point stays
          sig = x;
          lp = lp_x;
          ll = ll_x;
          moved += 1.0f;
        }
        n_shrink += float(i);
        if (++r < R) {
          row += kRepCols;
          log_y = lp + row[0];
          l = sig - w * row[1];
          rt = l + w;
          i = 0;
        } else {
          active = 0.0f;
          float* out = stats + size_t(b) * 8;
          out[0] = sig;
          out[1] = ll;
          out[2] = lp;
          out[3] = n_shrink;
          out[4] = moved;
          out[5] = 0.0f;
          out[6] = 0.0f;
          out[7] = 0.0f;
          st[kActive] = 0.0f;          // both buffers: it stays finished
        }
      }
      st_next[kRep] = float(r);
      st_next[kShrink] = float(i);
      st_next[kL] = l;
      st_next[kRt] = rt;
      st_next[kX] = active != 0.0f ? l + (rt - l) * row[2 + i] : x;
      st_next[kSig] = sig;
      st_next[kLp] = lp;
      st_next[kLl] = ll;
      st_next[kLogY] = log_y;
      st_next[kNShrink] = n_shrink;
      st_next[kMoved] = moved;
      st_next[kActive] = active;
    }
    grid.sync();
  }
}

}  // namespace auxpm

extern "C" int auxpm_sigma_sweep(const void* chol0, const void* u,
                                 const void* chain, const void* rep,
                                 const void* y, const void* mask, void* stats,
                                 void* workspace, int B, int S, int n, int R,
                                 int n_blocks, float log_s, int likelihood,
                                 int bf16, void* stream) {
  using namespace auxpm;
  const float* chol0_ = static_cast<const float*>(chol0);
  const float* u_ = static_cast<const float*>(u);
  const float* chain_ = static_cast<const float*>(chain);
  const float* rep_ = static_cast<const float*>(rep);
  const float* y_ = static_cast<const float*>(y);
  const float* mask_ = static_cast<const float*>(mask);
  float* stats_ = static_cast<float*>(stats);
  float* state_ = static_cast<float*>(workspace);
  float* rowsum_ = state_ + 2 * size_t(B) * kState;
  float* rounds_ = rowsum_ + size_t(B) * sweep::col_tiles(n) * S;
  void* args[] = {&chol0_, &u_,     &chain_,  &rep_, &y_, &mask_,
                  &stats_, &state_, &rowsum_, &rounds_, &B, &S,
                  &n,      &R,      &n_blocks, &log_s};
  cudaError_t err = cudaSuccess;
#define CALL(LIK, BF)                                                \
  err = sweep::launch_cooperative(sigma_sweep_kernel<LIK, BF>, args,  \
                                  static_cast<cudaStream_t>(stream))
  AUXPM_DISPATCH(likelihood, bf16 != 0, CALL);
#undef CALL
  return static_cast<int>(err);
}
