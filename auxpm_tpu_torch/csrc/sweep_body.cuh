// Round-synchronous probe body of every estimator kernel: the ESS sweep
// (ess_sweep.cu), the sigma sweep (sigma_sweep.cu) and the four entries of
// fused_estimator.cu (the estimate, the rotated estimate, the per-sample
// weights and the rotated weights, one round each).  They share one
// definition of the estimator's f32 expression: the same items, the same k
// order inside an item, the same fold over columns and tiles.
//
// A sweep advances in ROUNDS inside ONE cooperative launch.  In each round
// every still-active chain makes its next probe: phase A computes the
// per-sample log-weights of all those probes with the work spread over every
// block of the grid, a grid barrier follows, phase B (the caller's) folds
// them, decides and publishes each chain's next probe, and a second grid
// barrier closes the round.  A finished chain costs nothing in later rounds:
// the sweep lasts as many rounds as its chains' largest probe count, and
// every round is spread over the whole card.  The entries of
// fused_estimator.cu are one such round with no barrier: the block that
// completes a chain's last item folds it (fold_when_last).
//
// Phase A.  A work item is (active chain, block of up to 64 rows of u,
// 64-column tile t of f = left C^T): S importance samples make
// ceil(S / 64) row blocks, and n columns ceil(n / 64) tiles, the last one
// partial when 64 does not divide n (its columns j >= n are left out of
// the likelihood).  C is lower-triangular, so tile t contracts only
// k < min(64 (t + 1), n): the terms dropped are exact zeros
// (fmaf(a, 0, acc) == acc), and the work is about S n (n + 64) / 2 FMAs
// per probe instead of S n^2.  C is streamed once per row block, so at
// S > 64 a probe reads it ceil(S / 64) times (PERF.md).  Items are dealt to
// blocks in a fixed order, largest k range first (t descending, then
// chains in ascending index, then row blocks ascending), block g taking
// items g, g + grid, ...  A block is one producer warp and four consumer
// warps:
//   * the producer streams 32-deep chunks of u, v (if the probe rotates) and
//     C (16-byte cp.async copies through L2 at a fixed stride, up to 48 per
//     lane per chunk) into a ring of kStages shared-memory stages.  A chunk
//     that holds columns past n, rows of C past n (the last tile) or rows
//     that do not start 16-byte aligned (4 does not divide n) goes through
//     copy_ragged_chunk instead, out of line: copies cut at n (4 bytes each
//     where unaligned), the rest zero-filled by the copy itself (src-size
//     below its size).  With those cut copies inline in the common loop,
//     every kernel of the body took up to 2x as long at config 2's shapes
//     (PERF.md).
//     Each stage has a `full` mbarrier (one arrival per producer lane when
//     its copies have landed) and an `empty` one (the 128 consumer threads).
//     C is read with an evict-first L2 policy: it is streamed once per
//     probe and row block, while u and v are re-read by every tile of the
//     probe.  A first version issued one 128-byte bulk copy (cp.async.bulk)
//     per row, 192 per chunk, and took 10.4 ms for config 2's sweep against
//     5.5 with these copies (PERF.md);
//   * the consumers form the rotated operand u cos a + v sin a in place as
//     each chunk arrives, and scale C by the probe's c_scale in place (one
//     consumer barrier per chunk when either happens; operands rounded to
//     bf16 for whiten_dtype="bfloat16", as round_operand does), then run a
//     4 x 8 register tile each: per 4-deep step 4 + 8 float4 shared loads
//     feed 128 FMAs.  Rows of u and C are padded to 36 floats so that
//     neither operand's loads conflict.  The rows of a stage past the row
//     block's last are left as they are and their results are not stored;
//   * the likelihood is applied to the finished 64 x 64 tile (columns
//     j < n) and each row's sum over the tile's columns goes to a global
//     slot rowsum[chain][t][s] (S slots a tile); the caller's `done(chain,
//     t)` then runs on the consumers (the estimator counts arrivals there,
//     the sweeps do nothing).
// Each f element is the sum over k in ascending order in one accumulator,
// each row's sum over a tile's columns is one shuffle tree, and the tiles
// fold in tile order (fold_rows): a row of a given probe has the same bits
// in every kernel of the body, whichever rows share its call and whichever
// row block holds it.  The plain PyTorch versions sum in other orders and
// agree to rounding, not bitwise.
//
// Shared memory depends on neither n nor S (a stage is 26 KB), so two blocks
// share an SM; the grid is that occupancy times the SM count.  A chain's S
// folded log-weights go to a buffer the caller names: the output (weights);
// for the estimate sm.lw at S <= 64, else the chain's own tile-0 row sums, in
// place (one folding block a chain; the log-sum-exp's reads of global memory
// made the estimate 3 % slower at S = 64, PERF.md); or the idle ring in phase
// B of a sweep, where several blocks fold the same chain (at most kMaxSamples
// floats).  Tried and not kept (PERF.md):
// 128-column items on 256 consumer threads (one block per SM; the same
// time), 8 x 8 register tiles on 128-column items (spills, slower), and a
// bulk L2 prefetch (cp.async.bulk.prefetch.L2) of each streamed row's next 4,
// 8 or 20 chunks, so that DRAM reads whole row segments and not 128-byte
// pieces (every kernel of the body slower or no faster).  What bounds the
// body now: a round lasts at least as long as its longest item (20 chunks of
// tile 9 at n = 640), and in full rounds each chunk moves 24.5 KB (16 KB
// without v) for 131 k FMAs.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "probe.cuh"

namespace auxpm {
namespace sweep {

constexpr int kCols = 64;                   // columns of f per work item
constexpr int kDepth = 32;                  // k per stage
constexpr int kLdp = kDepth + 4;            // padded row of a u or C stage
constexpr int kStages = 4;
constexpr int kConsumers = 128;             // 16 x 8 threads, 4 x 8 f each
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxChains = 2048;            // the active list is uint16;
                                            // wrappers split larger batches

struct Stage {
  float u[kRows * kLdp];     // left rows (rotated in place)
  float v[kRows * kDepth];   // direction rows
  float c[kCols * kLdp];     // rows of C (columns of f)
};

struct Smem {
  Stage stage[kStages];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint16_t list[kMaxChains]; // active chains of the round, ascending
  float lw[kRows];           // the estimate's folded log-weights, S <= 64
  float bcast[4];            // phase B: decision broadcast
  int warp_count[kThreads / 32];
};

// Phase B of a sweep folds a chain's S log-weights into the ring, idle
// between phase A's last chunk and the next round's first.
static_assert(sizeof(Stage) * kStages >= sizeof(float) * kMaxSamples,
              "the ring must hold a chain's folded log-weights");
__device__ __forceinline__ float* idle_ring(Smem& sm) {
  return reinterpret_cast<float*>(sm.stage);
}

// One probe of one chain: f = left (c_scale C)^T with left = u (v == nullptr)
// or u cos a + v sin a.
struct ProbeSpec {
  const float* u;   // (S, n), S importance samples
  const float* v;   // (S, n) or nullptr
  const float* c;   // (n, n) lower-triangular
  float ca, sa;     // rotation
  float c_scale;    // applied to C before the product (1 = untouched)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, P1;\n\t}"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// A transaction that never completes would hang the card; after ~2^26 tries
// (seconds) the kernel traps instead, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spin = 0; !mbar_try_wait(bar, parity); ++spin)
    if (spin == (1u << 26)) __trap();
}

// 16 bytes global -> shared, through L2 only (the data were written by other
// blocks of this launch).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// The same, with an L2 eviction policy (createpolicy): C, streamed once per
// probe, is read evict-first so that it does not push the chains' u and v,
// which every tile item of a probe re-reads, out of L2.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
          smem_addr(dst)),
      "l"(src), "l"(policy)
      : "memory");
}

// The two with a source size: the first `bytes` are copied, the rest
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "l"(policy)
      : "memory");
}

// 4 bytes global -> shared (zero-filled if `bytes` is 0): the copies of a
// row that does not start 16-byte aligned (n % 4 != 0).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Four consecutive floats of one row, k .. k + 3, into dst: the elements
// at k >= n are zero-filled and never read (the source address is clamped
// to the row's start).  `aligned`: 4 divides n, one 16-byte copy.
template <bool kHint>
__device__ __forceinline__ void copy_quad(float* dst, const float* row, int k,
                                          int n, bool aligned,
                                          uint64_t policy) {
  if (aligned) {
    const int bytes = k < n ? 16 : 0;    // n - k is a multiple of 4
    const float* src = k < n ? row + k : row;
    if constexpr (kHint) {
      cp_async16(dst, src, bytes, policy);
    } else {
      cp_async16(dst, src, bytes);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = k + e < n;
      cp_async4(dst + e, in ? row + k + e : row, in ? 4 : 0);
    }
  }
}

// One producer lane's copies of one chunk that holds a column k >= n, a row
// of C past n or a row start that is not 16-byte aligned: the quads are
// cut at n and zero-filled (copy_quad).  Kept out of line, away from the
// strided copies of the common case.
static __device__ __noinline__ void copy_ragged_chunk(
    float* u_dst, float* v_dst, float* c_dst, const float* u_rows,
    const float* v_rows, const float* c_rows, const float* c, int r4, int k0,
    int n, int rows, int c_row0, bool aligned, uint64_t policy) {
  for (int j = 0; j < kRows / 4; ++j) {
    const int r = r4 + 4 * j;
    if (r < rows) {
      copy_quad<false>(u_dst + j * 4 * kLdp, u_rows + size_t(r) * n, k0, n,
                       aligned, 0);
      if (v_rows)
        copy_quad<false>(v_dst + j * 4 * kDepth, v_rows + size_t(r) * n, k0,
                         n, aligned, 0);
    }
    // rows of C past n (the last tile): zero-filled
    const bool c_in = c_row0 + r < n;
    copy_quad<true>(c_dst + j * 4 * kLdp, c_in ? c_rows + size_t(r) * n : c,
                    k0, c_in ? n : 0, aligned, policy);
  }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// The barrier receives one arrival once all of this thread's earlier
// cp.async copies have landed (its count includes that arrival: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Ring position of one role (producer or consumers).  Both roles walk the
// same sequence of chunks, so their positions agree.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Once per launch, all threads: barriers initialised, the pad rows zeroed.
__device__ inline void init_smem(Smem& sm) {
  for (int s = 0; s < kStages; ++s) {
    for (int i = threadIdx.x; i < kRows * kLdp; i += blockDim.x)
      sm.stage[s].u[i] = 0.0f;
    for (int i = threadIdx.x; i < kRows * kDepth; i += blockDim.x)
      sm.stage[s].v[i] = 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);   // the producer's lanes
      mbar_init(&sm.empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Every thread of the block: the chains whose flag active[b * stride] is
// non-zero, ascending, into sm.list; returns their number.  The flags were
// written by other blocks before the last grid barrier (read through L2).
__device__ inline int compact_active(Smem& sm, const float* active, int stride,
                                     int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < B; base += kThreads) {
    const int b = base + threadIdx.x;
    const bool on = b < B && __ldcg(active + size_t(b) * stride) != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) sm.warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = total;
    for (int w = 0; w < warp; ++w) before += sm.warp_count[w];
    if (on)
      sm.list[before + __popc(ballot & ((1u << lane) - 1u))] = uint16_t(b);
    for (int w = 0; w < kThreads / 32; ++w) total += sm.warp_count[w];
    __syncthreads();
  }
  return total;
}

// Items of one chain's probe: row blocks x column tiles.
__host__ __device__ __forceinline__ int row_blocks(int S) {
  return (S + kRows - 1) / kRows;
}
__host__ __device__ __forceinline__ int col_tiles(int n) {
  return (n + kCols - 1) / kCols;
}

// Item w of a round: tile t (descending), the round's j-th chain, row
// block rb.  At one row block (S <= 64) no division by it.
struct Item {
  int t, j, rb;
};
__device__ __forceinline__ Item item_of(int w, int n_tiles, int per_tile,
                                        int n_rb) {
  const int q = w / per_tile;
  const int rem = w - q * per_tile;
  if (n_rb == 1) return {n_tiles - 1 - q, rem, 0};
  return {n_tiles - 1 - q, rem / n_rb, rem % n_rb};
}

// Phase A of a round: every item w of this block, w = (nT - 1 - t) nA nR +
// j nR + rb for the j-th chain of the round, row block rb and tile t, into
// rowsum[(chain * nT + t) * S + 64 rb + r].  `chain_of(j)` is the j-th chain
// of the round, `spec(b)` chain b's ProbeSpec, and `done(b, t)` runs on
// every consumer thread once an item (b, ., t) is in rowsum.  All threads
// of the block call it; the rings persist across rounds.  Ends with a block
// barrier.
//
// RPT: rows of f per consumer thread, 4 (all 64 rows of a block) or 2 (the
// first 32, for S <= 32: half the products).  A row's arithmetic is the
// same either way (the same k order per element, the same 8 columns and
// shuffle tree per row), so a row has the same bits at RPT 2 and 4, and in
// any row block.
template <int LIK, bool BF16, int RPT = 4, class Chain, class Spec,
          class Done>
__device__ inline void probe_tiles(Smem& sm, Ring& ring, int n_active, int S,
                                   int n, const float* __restrict__ y,
                                   const float* __restrict__ mask,
                                   float* rowsum, Chain chain_of, Spec spec,
                                   Done done) {
  const int n_tiles = col_tiles(n);
  const int n_rb = row_blocks(S);
  const int per_tile = n_active * n_rb;
  const int n_items = n_tiles * per_tile;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---------------------------------------------------------- producer
    const int lane = tid - kConsumers;
    const uint64_t stream_once = evict_first_policy();
    const bool aligned = (n & 3) == 0;
    const int r4 = lane >> 3, q4 = (lane & 7) * 4;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item it = item_of(w, n_tiles, per_tile, n_rb);
      const int t = it.t, rb = it.rb;
      const ProbeSpec p = spec(chain_of(it.j));
      const int rows = min(kRows, S - rb * kRows);
      const int n_chunks = (min(kCols * (t + 1), n) + kDepth - 1) / kDepth;
      const float* u_rows = p.u + size_t(rb) * kRows * n;
      const float* v_rows = p.v ? p.v + size_t(rb) * kRows * n : nullptr;
      const float* c_rows = p.c + size_t(t) * kCols * n;
      // 16-byte aligned rows and every row of C real: every chunk of the
      // item takes the plain strided copies (one branch an item: with a
      // branch a chunk, the rotated entries took 5 % longer, PERF.md)
      const bool whole_tile = aligned && (t + 1) * kCols <= n;
      // the next empty stage's pointers for this lane: u, v, C
      auto next_stage = [&](float*& u_dst, float*& v_dst, float*& c_dst) {
        Stage& st = sm.stage[ring.stage];
        if (lane == 0) mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1u);
        __syncwarp();
        u_dst = st.u + r4 * kLdp + q4;
        v_dst = st.v + r4 * kDepth + q4;
        c_dst = st.c + r4 * kLdp + q4;
      };
      float *u_dst, *v_dst, *c_dst;
      if (whole_tile) {
        for (int kc = 0; kc < n_chunks; ++kc) {
          next_stage(u_dst, v_dst, c_dst);
          // 4 floats per copy, 8 per row of a chunk: lane (row lane / 8 +
          // 4 j, floats 4 (lane % 8) ..) for j = 0..15, the addresses
          // stepping by a fixed stride
          const int k0 = kc * kDepth + q4;
          const float* u_src = u_rows + size_t(r4) * n + k0;
          const float* v_src = p.v ? v_rows + size_t(r4) * n + k0 : nullptr;
          const float* c_src = c_rows + size_t(r4) * n + k0;
#pragma unroll
          for (int j = 0; j < kRows / 4; ++j) {
            if (r4 + 4 * j < rows) {
              cp_async16(u_dst + j * 4 * kLdp, u_src + size_t(j) * 4 * n);
              if (p.v)
                cp_async16(v_dst + j * 4 * kDepth, v_src + size_t(j) * 4 * n);
            }
            cp_async16(c_dst + j * 4 * kLdp, c_src + size_t(j) * 4 * n,
                       stream_once);
          }
          cp_async_arrive(&sm.full[ring.stage]);
          ring.advance();
        }
      } else {
        for (int kc = 0; kc < n_chunks; ++kc) {
          next_stage(u_dst, v_dst, c_dst);
          copy_ragged_chunk(u_dst, v_dst, c_dst, u_rows, v_rows, c_rows, p.c,
                            r4, kc * kDepth + q4, n, rows, t * kCols, aligned,
                            stream_once);
          cp_async_arrive(&sm.full[ring.stage]);
          ring.advance();
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int tx = tid & 7, ty = tid >> 3;   // rows RPT ty.., columns tx + 8 c
    const int rot_row = tid >> 1, rot_col = (tid & 1) * 16;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item it = item_of(w, n_tiles, per_tile, n_rb);
      const int t = it.t, rb = it.rb;
      const int b = chain_of(it.j);
      const ProbeSpec p = spec(b);
      const int rows = min(kRows, S - rb * kRows);
      const int n_chunks = (min(kCols * (t + 1), n) + kDepth - 1) / kDepth;
      const bool scale_c = BF16 || p.c_scale != 1.0f;
      float acc[RPT][8];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

      for (int kc = 0; kc < n_chunks; ++kc) {
        Stage& st = sm.stage[ring.stage];
        mbar_wait(&sm.full[ring.stage], ring.phase);
        // the operands as the product takes them, in place
        // thread: row tid / 2, columns 16 (tid % 2) .. + 15, as float4
        if ((p.v || BF16) && rot_row < rows) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float4* x = reinterpret_cast<float4*>(st.u + rot_row * kLdp +
                                                  rot_col + 4 * q);
            float4 a = *x;
            if (p.v) {
              const float4 d = *reinterpret_cast<const float4*>(
                  st.v + rot_row * kDepth + rot_col + 4 * q);
              a.x = a.x * p.ca + d.x * p.sa;
              a.y = a.y * p.ca + d.y * p.sa;
              a.z = a.z * p.ca + d.z * p.sa;
              a.w = a.w * p.ca + d.w * p.sa;
            }
            *x = make_float4(
                round_operand<BF16>(a.x), round_operand<BF16>(a.y),
                round_operand<BF16>(a.z), round_operand<BF16>(a.w));
          }
        }
        if (scale_c) {   // rows tid / 2 of C, the same columns
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float4* x = reinterpret_cast<float4*>(st.c + rot_row * kLdp +
                                                  rot_col + 4 * q);
            const float4 c = *x;
            *x = make_float4(round_operand<BF16>(p.c_scale * c.x),
                             round_operand<BF16>(p.c_scale * c.y),
                             round_operand<BF16>(p.c_scale * c.z),
                             round_operand<BF16>(p.c_scale * c.w));
          }
        }
        if (p.v || scale_c) consumer_barrier();
        const float* a_base = st.u + (ty * RPT) * kLdp;
        const float* b_base = st.c + tx * kLdp;
#pragma unroll
        for (int k = 0; k < kDepth; k += 4) {
          float4 a[RPT], bv[8];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            a[r] = *reinterpret_cast<const float4*>(a_base + r * kLdp + k);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            bv[c] = *reinterpret_cast<const float4*>(b_base + 8 * c * kLdp + k);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[r][c] = fmaf(a[r].x, bv[c].x, acc[r][c]);
              acc[r][c] = fmaf(a[r].y, bv[c].y, acc[r][c]);
              acc[r][c] = fmaf(a[r].z, bv[c].z, acc[r][c]);
              acc[r][c] = fmaf(a[r].w, bv[c].w, acc[r][c]);
            }
        }
        mbar_arrive(&sm.empty[ring.stage]);
        ring.advance();
      }

      // likelihood on the finished tile, summed over its columns j < n
      float rowacc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) rowacc[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = t * kCols + tx + 8 * c;
        if (j < n) {
          const float yj = y[j], mj = mask[j];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            rowacc[r] += log_lik<LIK>(yj * acc[r][c]) * mj;
        }
      }
      const int row0 = ty * RPT;
      float* out = rowsum + (size_t(b) * n_tiles + t) * S + rb * kRows + row0;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float v = rowacc[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        if (tx == 0 && row0 + r < rows) out[r] = v;
      }
      done(b, t);
    }
  }
  __syncthreads();
}

// Warp 0: the chain's per-sample log-weights, each row's tile sums folded in
// tile order, into lw[0..S) (shared or global memory; visible to the warp
// on return).  A row's weight depends on that row alone.  lw may be the
// chain's tile-0 slots of rowsum: lane s reads row s's sums before it
// writes row s, and no other lane touches row s.
__device__ inline void fold_rows(float* lw, const float* rowsum, int b,
                                 int n_tiles, int S) {
  const int lane = threadIdx.x & 31;
  const float* base = rowsum + size_t(b) * n_tiles * S;
  __syncwarp();           // lw may still be read from the warp's last fold
  for (int s = lane; s < S; s += 32) {
    float acc = 0.0f;
#pragma unroll 10
    for (int t = 0; t < n_tiles; ++t) acc += __ldcg(base + size_t(t) * S + s);
    lw[s] = acc;
  }
  __syncwarp();
}

// Phase B helper, warp 0: fold_rows into lw, then the blocked log-sum-exp
// minus log S (same value on every lane).
__device__ inline float fold_estimate(float* lw, const float* rowsum, int b,
                                      int n_tiles, int S, int n_blocks,
                                      float log_s) {
  fold_rows(lw, rowsum, b, n_tiles, S);
  return blocked_lse(lw, S, n_blocks) - log_s;
}

// The `done` hook of a one-round kernel, on the consumers: counts item
// arrivals of chain b (its stores fenced, then atomicAdd on arrivals[b],
// zero at the launch) and runs `fold()` on warp 0 of the block that
// completes the chain's last of `items` items, after a second fence, so
// that it sees the other blocks' row sums of chain b.
template <class Fold>
__device__ inline void fold_when_last(int* arrivals, int b, int items,
                                      Fold fold) {
  __threadfence();        // this item's row sums, visible card-wide
  consumer_barrier();     // ... from every consumer that wrote one
  if (threadIdx.x < 32) {
    int last = 0;
    if (threadIdx.x == 0) last = atomicAdd(arrivals + b, 1) == items - 1;
    if (__shfl_sync(0xffffffffu, last, 0)) {
      __threadfence();    // the other blocks' row sums of chain b
      fold();
    }
  }
}

// Blocks of a grid that is resident on the current device all at once
// (occupancy x SMs) for a kernel of this body, into *grid.
template <class K>
cudaError_t sweep_grid(K kernel, int* grid) {
  cudaError_t err = allow_smem(kernel, sizeof(Smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, sizeof(Smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// ONE cooperative launch of a sweep kernel on its resident grid.  Returns
// the CUDA error, that of a launch the card refuses included: the wrappers
// raise on it, nothing falls back.
template <class K>
cudaError_t launch_cooperative(K kernel, void** args, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = sweep_grid(kernel, &grid);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                      kThreads, args, sizeof(Smem), stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

}  // namespace sweep
}  // namespace auxpm
