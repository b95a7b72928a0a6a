// Cholesky factor of a batch of 128 x 128 SPD tiles, and its inverse: one
// kernel, three output modes, one per panel route of ops/chol_hopper.py.
//
// Replaces the TPU kernels of auxpm_tpu/ops/chol_pallas.py:
//   v3  _chol_panel_kernel3 (wrapper chol_panel_batched3): L (lower) and
//       inv(L)^T (upper), the two operands the blocked right-looking
//       factorisation consumes (L_ij = A_ij @ inv(L_jj)^T);
//   v1  _chol_panel_kernel (chol_panel_batched): L and inv(L), both lower;
//   v2  _chol_panel_kernel2 (chol_panel_batched2): L only (the blocked loop
//       inverts it by Newton iteration, outside the kernel).
// The TPU kernels reach these outputs three ways (masked full-tile
// reductions for v1, the symmetric row slice and rsqrt for v2, 8-wide
// mini-panels with rank-8 matrix-unit updates for v3), each vectorising a
// batch of tiles over its lanes; those choices answer a TPU's shape and are
// not carried over.  What each computes is a subset of v3's work, so here
// the three share one body and differ only in what they write: v1 stores
// inv(L) row by row instead of transposing it, v2 skips the inverse (half
// the shared memory).  All three run the same factor code, so their L are
// the same bits, and v1's inv(L) is v3's inv(L)^T transposed, bit for bit.
//
// One block of 256 threads owns one tile, held in shared memory (A,
// overwritten by L, and X = inv(L); 2 x 66 KB, one block per SM), and
// factors it in four 32-wide column blocks j:
//   1. warp 0 factors the diagonal block A_jj in registers, lane i holding
//      row i; column k is broadcast with __shfl_sync, so the 32 dependent
//      steps need no block barrier.  It publishes L_jj and 1 / diag and
//      arrives on a named barrier;
//   2. warp 0 then inverts L_jj (X_jj, lane m solving column m by forward
//      substitution; not in v2) while warps 1-3 solve the rows below,
//      L_ij = A_ij inv(L_jj)^T, one thread per row, forward substitution
//      against L_jj;
//   3. after a block barrier all 8 warps update the trailing matrix,
//      A_pq -= L_pj L_qj^T, over its LOWER 32 x 32 blocks only (q <= p), a
//      64-thread group per block with a 4 x 4 register tile each, fed by
//      float4 shared loads (a first version with scalar loads and an odd
//      stride took 0.062 ms per launch).
// inv(L) is assembled after the four columns by block forward substitution
// (v3 and v1), X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj, row block i = 1, 2, 3
// in turn, the partial sums T_ij parked in the unused upper blocks of the L
// buffer.  17 block-wide barriers in all, against 128 in the column-at-a-time
// kernels this design replaced, and ~1.1 M FMAs per tile against their 2.1 M
// (the full square of A at each of 128 steps; 4.2 M in v3's first kernel,
// which updated inv(L) the same way).
// 32-wide blocks: a warp's width, so the diagonal factor is one warp in
// registers; 16-wide blocks would halve that serial part and double the
// barriers.
//
// A non-positive (or NaN) pivot becomes NaN on L's diagonal and spreads to
// every later column (through the rows below and the trailing update): that
// is the failure signal robust_cholesky escalates on, so nothing is clamped.
// v2 takes 1 / sqrtf of the pivot, as v3 does, not the TPU v2 body's rsqrt.
//
// Bound: bytes (three 64 KB tiles moved per matrix for v3 and v1, two for v2,
// against 2*128^3/3 FLOPs).  What limits the kernel is its serial part: warp
// 0's four diagonal factors (32 dependent steps each) and the barriers
// between the phases.
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kTile = 128;
constexpr int kLd = kTile + 4;   // rows 16-byte aligned, 4 banks apart
constexpr int kNb = 32;          // column block
constexpr int kCholThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Warp 0: factor the diagonal block at (j0, j0) of Ls in registers and write
// it back, lower with exact zeros above; inv_diag[j0 + k] = 1 / L_kk.
__device__ __forceinline__ void factor_diag(float* Ls, float* inv_diag,
                                            int j0) {
  const int lane = threadIdx.x & 31;
  float* row = Ls + (j0 + lane) * kLd + j0;
  float a[kNb];
#pragma unroll
  for (int m = 0; m < kNb; ++m) a[m] = row[m];
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const float pivot = __shfl_sync(kFull, a[k], k);
    const float d = pivot > 0.0f ? sqrtf(pivot) : NAN;
    const float inv_d = 1.0f / d;
    const float l = lane > k ? a[k] * inv_d : (lane == k ? d : 0.0f);
    a[k] = l;
    if (lane == 0) inv_diag[j0 + k] = inv_d;
#pragma unroll
    for (int m = k + 1; m < kNb; ++m)
      a[m] = fmaf(-l, __shfl_sync(kFull, l, m), a[m]);
  }
#pragma unroll
  for (int m = 0; m < kNb; ++m) row[m] = m <= lane ? a[m] : 0.0f;
}

// Warp 0: X_jj = inv(L_jj), lane m solving column m; exact zeros above the
// diagonal (a finite L gives 0 * (1 / L_rr) there).
__device__ __forceinline__ void invert_diag(const float* Ls,
                                            const float* inv_diag, float* Xs,
                                            int j0) {
  const int lane = threadIdx.x & 31;
  float x[kNb];
#pragma unroll
  for (int r = 0; r < kNb; ++r) {
    const float* lrow = Ls + (j0 + r) * kLd + j0;
    float s = r == lane ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < r; ++k) s = fmaf(-lrow[k], x[k], s);
    x[r] = s * inv_diag[j0 + r];
  }
#pragma unroll
  for (int r = 0; r < kNb; ++r) Xs[(j0 + r) * kLd + j0 + lane] = x[r];
}

// One thread: row `i` of the column block j0 below the diagonal,
// L_ij = A_ij inv(L_jj)^T by forward substitution against L_jj.
__device__ __forceinline__ void solve_row(float* Ls, const float* inv_diag,
                                          int i, int j0) {
  float* row = Ls + i * kLd + j0;
  float a[kNb];
#pragma unroll
  for (int m = 0; m < kNb; ++m) a[m] = row[m];
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const float l = a[k] * inv_diag[j0 + k];
    a[k] = l;
#pragma unroll
    for (int m = k + 1; m < kNb; ++m)
      a[m] = fmaf(-l, Ls[(j0 + m) * kLd + j0 + k], a[m]);
  }
#pragma unroll
  for (int m = 0; m < kNb; ++m) row[m] = a[m];
}

// A 32 x 32 block product for one 64-thread group (g = its thread index):
//   out = (accumulate ? out : 0) + sign * sum_t A_t B_t   (B_t^T if BT)
// A_t, B_t, out: top-left elements of 32 x 32 blocks of stride kLd.
struct Unit {
  const float* a[3];
  const float* b[3];
  int terms;
  float* out;
};

template <bool BT>
__device__ __forceinline__ void block_mm(const Unit& u, float sign,
                                         bool accumulate, int g) {
  // rows ty + 8 r; columns tx + 8 c (BT: float4 down B's rows) or 4 tx + c
  // (float4 along B's rows).  With kLd = 132 every float4 load of a warp is
  // one conflict-free wavefront.
  const int ty = g >> 3, tx = g & 7;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t >= u.terms) break;
    const float* A = u.a[t];
    const float* Bm = u.b[t];
#pragma unroll 2
    for (int k = 0; k < kNb; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(A + (ty + 8 * r) * kLd + k);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bv[c] = *reinterpret_cast<const float4*>(
            BT ? Bm + (tx + 8 * c) * kLd + k : Bm + (k + c) * kLd + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (BT) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
          }
        } else {   // bv[q] = row k + q of B, columns 4 tx .. 4 tx + 3
          const float a4[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][0] = fmaf(a4[q], bv[q].x, acc[r][0]);
            acc[r][1] = fmaf(a4[q], bv[q].y, acc[r][1]);
            acc[r][2] = fmaf(a4[q], bv[q].z, acc[r][2]);
            acc[r][3] = fmaf(a4[q], bv[q].w, acc[r][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = BT ? tx + 8 * c : 4 * tx + c;
      float* o = u.out + (ty + 8 * r) * kLd + col;
      *o = accumulate ? fmaf(sign, acc[r][c], *o) : sign * acc[r][c];
    }
}

// What a launch writes: the outputs of one panel route.
enum class PanelOut {
  kV3,   // L and inv(L)^T (upper)
  kV1,   // L and inv(L), both lower
  kV2,   // L only
};

// Rows of the lower triangle of S (stride kLd) to the dense tile `out`,
// exact zeros above the diagonal: one float4 per thread and step.
__device__ __forceinline__ void store_lower(const float* S, float* out) {
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll 4
  for (int q = 0; q < kTile * kTile / 4 / kCholThreads; ++q) {
    const int idx = q * kCholThreads + threadIdx.x;
    const int i = idx >> 5, j = (idx & 31) * 4;
    float4 l = *reinterpret_cast<const float4*>(S + i * kLd + j);
    l.x = j <= i ? l.x : 0.0f;
    l.y = j + 1 <= i ? l.y : 0.0f;
    l.z = j + 2 <= i ? l.z : 0.0f;
    l.w = j + 3 <= i ? l.w : 0.0f;
    o4[idx] = l;
  }
}

template <PanelOut kOut>
__global__ void __launch_bounds__(kCholThreads, 1)
chol_panel_kernel(const float* __restrict__ a, float* __restrict__ l_out,
                  float* __restrict__ x_out) {
  constexpr bool kInverse = kOut != PanelOut::kV2;
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;                    // A, becoming L (lower blocks)
  float* Xs = smem + kTile * kLd;      // inv(L) (lower blocks; not in v2)
  __shared__ float inv_diag[kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int group = tid >> 6, g = tid & 63;   // 4 groups of 64 threads
  const size_t off = size_t(blockIdx.x) * kTile * kTile;
  auto blk = [](float* base, int p, int q) {
    return base + p * kNb * kLd + q * kNb;
  };

  // the tile in: 16 float4 loads per thread, all in flight at once
  const float4* a4 = reinterpret_cast<const float4*>(a + off);
#pragma unroll
  for (int q = 0; q < kTile * kTile / 4 / kCholThreads; ++q) {
    const int idx = q * kCholThreads + tid;
    *reinterpret_cast<float4*>(Ls + (idx >> 5) * kLd + (idx & 31) * 4) =
        __ldg(a4 + idx);
  }
  __syncthreads();

  constexpr int kBlocks = kTile / kNb;
  for (int j = 0; j < kBlocks; ++j) {
    const int j0 = j * kNb;
    if (warp == 0) {
      factor_diag(Ls, inv_diag, j0);
      __syncwarp();
      if (j + 1 < kBlocks)
        asm volatile("bar.arrive 1, %0;" ::"n"(kCholThreads) : "memory");
      if constexpr (kInverse) invert_diag(Ls, inv_diag, Xs, j0);
    } else if (j + 1 < kBlocks) {
      asm volatile("bar.sync 1, %0;" ::"n"(kCholThreads) : "memory");
      const int i = j0 + kNb + tid - 32;
      if (i < kTile) solve_row(Ls, inv_diag, i, j0);
    }
    __syncthreads();
    if (j + 1 == kBlocks) break;
    // trailing update of the lower blocks (p, q), j < q <= p
    int unit = 0;
    for (int p = j + 1; p < kBlocks; ++p)
      for (int q = j + 1; q <= p; ++q, ++unit) {
        if (unit % 4 != group) continue;
        Unit u{{blk(Ls, p, j)}, {blk(Ls, q, j)}, 1, blk(Ls, p, q)};
        block_mm<true>(u, -1.0f, true, g);
      }
    __syncthreads();
  }

  // inv(L) by block forward substitution, row block i = 1, 2, 3
  if constexpr (kInverse) {
    for (int i = 1; i < kBlocks; ++i) {
      for (int j = group; j < i; j += 4) {   // T_ij -> upper block (j, i) of Ls
        Unit u{{}, {}, i - j, blk(Ls, j, i)};
        for (int k = j; k < i; ++k) {
          u.a[k - j] = blk(Ls, i, k);
          u.b[k - j] = blk(Xs, k, j);
        }
        block_mm<false>(u, 1.0f, false, g);
      }
      __syncthreads();
      for (int j = group; j < i; j += 4) {   // X_ij = -X_ii T_ij
        Unit u{{blk(Xs, i, i)}, {blk(Ls, j, i)}, 1, blk(Xs, i, j)};
        block_mm<false>(u, -1.0f, false, g);
      }
      __syncthreads();
    }
  }

  store_lower(Ls, l_out + off);
  if constexpr (kOut == PanelOut::kV1) store_lower(Xs, x_out + off);
  if constexpr (kOut == PanelOut::kV3) {
    // inv(L)^T: thread (i, 8 columns) reads column i of inv(L) (neighbouring
    // threads, neighbouring banks) and writes one 32-byte sector of row i
#pragma unroll 2
    for (int q = 0; q < kTile * kTile / 8 / kCholThreads; ++q) {
      const int idx = q * kCholThreads + tid;
      const int i = idx & (kTile - 1), j = (idx >> 7) * 8;
      float x[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        x[c] = j + c >= i ? Xs[(j + c) * kLd + i] : 0.0f;
      float4* dst = reinterpret_cast<float4*>(x_out + off + i * kTile + j);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

template <PanelOut kOut>
int launch_panel(const void* a, void* l_out, void* x_out, int B,
                 void* stream) {
  const int buffers = kOut == PanelOut::kV2 ? 1 : 2;
  const size_t smem = sizeof(float) * buffers * kTile * kLd;
  cudaError_t err = cudaFuncSetAttribute(
      chol_panel_kernel<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_panel_kernel<kOut><<<B, kCholThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l_out),
      static_cast<float*>(x_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace auxpm

extern "C" int auxpm_chol_panel(const void* a, void* l_out, void* xt_out,
                                int B, void* stream) {
  return auxpm::launch_panel<auxpm::PanelOut::kV3>(a, l_out, xt_out, B,
                                                   stream);
}

extern "C" int auxpm_chol_panel_v1(const void* a, void* l_out, void* linv_out,
                                   int B, void* stream) {
  return auxpm::launch_panel<auxpm::PanelOut::kV1>(a, l_out, linv_out, B,
                                                   stream);
}

extern "C" int auxpm_chol_panel_v2(const void* a, void* l_out, int B,
                                   void* stream) {
  return auxpm::launch_panel<auxpm::PanelOut::kV2>(a, l_out, nullptr, B,
                                                   stream);
}
