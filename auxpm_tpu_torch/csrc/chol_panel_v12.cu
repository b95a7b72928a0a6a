// The two earlier Cholesky panel routes, for a batch of 128 x 128 SPD tiles.
//
// v1 replaces the TPU kernel auxpm_tpu/ops/chol_pallas.py::_chol_panel_kernel
// (wrapper chol_panel_batched): tile -> L and inv(L), both lower, by
// right-looking rank-1 steps on column k, with inv(L) found by forward
// substitution inside the kernel.
// v2 replaces ::_chol_panel_kernel2 (wrapper chol_panel_batched2): tile -> L
// only, each step working from ROW k of the trailing block (which stays
// symmetric under the rank-1 updates) scaled by rsqrt of the pivot; the
// inverse is the blocked loop's Newton iteration, outside the kernel.
//
// The TPU bodies pick row and column k out of the tile by masked full-tile
// reductions, because their compiler has no dynamic slice, and ride a batch
// of tiles on the vector lanes.  Neither is carried over.  As in the v3
// kernel (chol_panel.cu) one block of 256 threads owns one tile and keeps it
// in registers, thread (ty, tx) holding A[ty + 16 r][tx + 16 c]; the owners
// of line k publish it through a double-buffered 128-float line in shared
// memory, ONE barrier follows, and every thread updates its 8 x 8 elements
// from registers.  The update runs over the full square with L[i][k] taken as
// 0 for i <= k: no masks in the inner loop.
//
// v1's inverse: after the 128 steps L is in shared memory, and column j of
// X = inv(L) depends on no other column, so thread j runs the forward
// substitution X[k][j] = (delta_kj - sum_{m<k} L[k][m] X[m][j]) / L[k][k]
// for k = j..127 alone, with no barrier (it reads only what it wrote).  That
// leaves half of the block idle for the tail and is the simple version.
//
// A non-positive (or NaN) pivot becomes NaN on L's diagonal and spreads from
// there, as in v3, so the escalating factorisation could sit on any of the
// three.
//
// Bound: bytes (v1 moves three 64 KB tiles per matrix, v2 two, against
// 2*128^3/3 FLOPs).  What limits both is the chain of 128 dependent steps.
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kT = 128;
constexpr int kTld = kT + 1;       // odd stride for the tiles in shared memory
constexpr int kTThreads = 256;
constexpr int kE = 8;              // elements per thread along each axis

// The 128 factor steps on the register tile A; leaves L's lower triangle in
// Ls (column k written at step k).  kRowForm: publish row k (v2) instead of
// column k (v1), and scale by rsqrtf instead of 1 / sqrtf.
template <bool kRowForm>
__device__ inline void factor_tile(float (&A)[kE][kE], float* Ls,
                                   float (*line)[kT]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  for (int k = 0; k < kT; ++k) {
    const int buf = k & 1;
    const int kc = k >> 4, kx = k & 15;
    if (kRowForm) {
      if (ty == kx) {
#pragma unroll
        for (int c = 0; c < kE; ++c) {
          float v = 0.0f;
#pragma unroll
          for (int r = 0; r < kE; ++r)
            if (r == kc) v = A[r][c];
          line[buf][tx + 16 * c] = v;
        }
      }
    } else {
      if (tx == kx) {
#pragma unroll
        for (int r = 0; r < kE; ++r) {
          float v = 0.0f;
#pragma unroll
          for (int c = 0; c < kE; ++c)
            if (c == kc) v = A[r][c];
          line[buf][ty + 16 * r] = v;
        }
      }
    }
    // the only barrier of the step; the other buffer is written next step,
    // after every thread has passed this point and is done reading it
    __syncthreads();

    const float pivot = line[buf][k];
    float d, inv_d;
    if (kRowForm) {
      inv_d = pivot > 0.0f ? rsqrtf(pivot) : NAN;
      d = pivot > 0.0f ? sqrtf(pivot) : NAN;
    } else {
      d = pivot > 0.0f ? sqrtf(pivot) : NAN;
      inv_d = 1.0f / d;
    }
    float li[kE], lj[kE];
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int i = ty + 16 * r;
      li[r] = (i > k) ? line[buf][i] * inv_d : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kE; ++c) {
      const int j = tx + 16 * c;
      lj[c] = (j > k) ? line[buf][j] * inv_d : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kE; ++r)
#pragma unroll
      for (int c = 0; c < kE; ++c) A[r][c] = fmaf(-li[r], lj[c], A[r][c]);
    if (tid >= k && tid < kT)  // column k of L, rows k..127
      Ls[tid * kTld + k] = (tid == k) ? d : line[buf][tid] * inv_d;
  }
  __syncthreads();
}

__device__ inline void load_tile(const float* __restrict__ a, size_t off,
                                 float (&A)[kE][kE]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < kE; ++r)
#pragma unroll
    for (int c = 0; c < kE; ++c)
      A[r][c] = a[off + (ty + 16 * r) * kT + (tx + 16 * c)];
}

__global__ void __launch_bounds__(kTThreads, 1)
chol_panel_v1_kernel(const float* __restrict__ a, float* __restrict__ l_out,
                     float* __restrict__ linv_out) {
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;               // L
  float* Xs = smem + kT * kTld;   // inv(L)
  __shared__ float line[2][kT];

  const int tid = threadIdx.x;
  const size_t off = size_t(blockIdx.x) * kT * kT;
  float A[kE][kE];
  load_tile(a, off, A);
  factor_tile<false>(A, Ls, line);

  if (tid < kT) {
    // column j of inv(L); the loops start at the warp's first column so that
    // a warp stays converged (X[m][j] = 0 for m < j)
    const int j = tid;
    const int m0 = j & ~31;
    for (int k = m0; k < kT; ++k) {
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
      const float* lrow = Ls + k * kTld;
      int m = m0;
      for (; m + 3 < k; m += 4) {
        acc0 = fmaf(lrow[m], Xs[m * kTld + j], acc0);
        acc1 = fmaf(lrow[m + 1], Xs[(m + 1) * kTld + j], acc1);
        acc2 = fmaf(lrow[m + 2], Xs[(m + 2) * kTld + j], acc2);
        acc3 = fmaf(lrow[m + 3], Xs[(m + 3) * kTld + j], acc3);
      }
      for (; m < k; ++m) acc0 = fmaf(lrow[m], Xs[m * kTld + j], acc0);
      const float rhs = (k == j) ? 1.0f : 0.0f;
      const float x = (rhs - ((acc0 + acc1) + (acc2 + acc3))) / lrow[k];
      Xs[k * kTld + j] = (k < j) ? 0.0f : x;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < kT * kT; idx += kTThreads) {
    const int i = idx >> 7, j = idx & 127;
    l_out[off + idx] = (j <= i) ? Ls[i * kTld + j] : 0.0f;
    linv_out[off + idx] = (j <= i) ? Xs[i * kTld + j] : 0.0f;
  }
}

__global__ void __launch_bounds__(kTThreads, 1)
chol_panel_v2_kernel(const float* __restrict__ a, float* __restrict__ l_out) {
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;
  __shared__ float line[2][kT];

  const size_t off = size_t(blockIdx.x) * kT * kT;
  float A[kE][kE];
  load_tile(a, off, A);
  factor_tile<true>(A, Ls, line);

  for (int idx = threadIdx.x; idx < kT * kT; idx += kTThreads) {
    const int i = idx >> 7, j = idx & 127;
    l_out[off + idx] = (j <= i) ? Ls[i * kTld + j] : 0.0f;
  }
}

}  // namespace auxpm

extern "C" int auxpm_chol_panel_v1(const void* a, void* l_out, void* linv_out,
                                   int B, void* stream) {
  using namespace auxpm;
  const size_t smem = sizeof(float) * 2 * kT * kTld;
  cudaError_t err = cudaFuncSetAttribute(
      chol_panel_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_panel_v1_kernel<<<B, kTThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l_out),
      static_cast<float*>(linv_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int auxpm_chol_panel_v2(const void* a, void* l_out, int B,
                                   void* stream) {
  using namespace auxpm;
  const size_t smem = sizeof(float) * kT * kTld;
  cudaError_t err = cudaFuncSetAttribute(
      chol_panel_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_panel_v2_kernel<<<B, kTThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l_out));
  return static_cast<int>(cudaGetLastError());
}
