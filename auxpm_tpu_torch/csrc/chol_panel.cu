// Cholesky factor and transposed inverse of a batch of 128 x 128 SPD tiles.
//
// Replaces the TPU kernel auxpm_tpu/ops/chol_pallas.py::_chol_panel_kernel3
// (wrapper chol_panel_batched3): (B,128,128) SPD -> L (lower) and inv(L)^T
// (upper), the two operands the blocked right-looking factorisation consumes
// (L_ij = A_ij @ inv(L_jj)^T).  The TPU kernel vectorises a batch of tiles
// over its lanes and groups columns into 8-wide mini-panels with rank-8
// matrix-unit updates; that structure answers a TPU's shape and is not
// carried over.
//
// Here one block of 256 threads owns one tile and keeps it in REGISTERS: the
// threads form a 16 x 16 grid and thread (ty, tx) holds the 8 x 8 elements
// A[ty + 16 r][tx + 16 c] of the working matrix and the same elements of
// W, which starts as the identity and ends as inv(L).  Both are updated
// right-looking, one column k at a time:
//     L[i][k] = A[i][k] / sqrt(A[k][k])            (i > k)
//     X[k][:] = W[k][:] / L[k][k]                  (row k of inv(L), final)
//     A[i][j] -= L[i][k] L[j][k],  W[i][:] -= L[i][k] X[k][:]     (i > k)
// Per step the owners of column k of A and of row k of W publish them through
// a double-buffered 128-float line in shared memory, ONE block barrier
// follows, and every thread then does its 128 FMAs out of registers.  The
// updates run over the full square (the symmetric input keeps both triangles
// consistent, and L[i][k] is taken as 0 for i <= k), so there is no masking
// and no divergence in the inner loop.
//
// A non-positive (or NaN) pivot becomes NaN on L's diagonal and spreads from
// there: that is the failure signal robust_cholesky escalates on, so nothing
// is clamped.
//
// Bound: bytes (three 64 KB tiles moved per matrix against 2*128^3/3 FLOPs).
// What limits the kernel is the chain of 128 dependent steps, one barrier
// each; a first version that kept the tile in shared memory, used three
// barriers per step and found the inverse by a separate substitution on half
// the block took about three times as long (PERF.md).
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kTile = 128;
constexpr int kLd = kTile + 1;   // odd stride for the staging tiles
constexpr int kCholThreads = 256;
constexpr int kPer = 8;          // elements per thread along each axis

__global__ void __launch_bounds__(kCholThreads, 1)
chol_panel_kernel(const float* __restrict__ a, float* __restrict__ l_out,
                  float* __restrict__ xt_out) {
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;                // L, written one column per step
  float* Xs = smem + kTile * kLd;  // inv(L)^T, staged once at the end
  __shared__ float colbuf[2][kTile];  // column k of A (unscaled)
  __shared__ float rowbuf[2][kTile];  // row k of W (unscaled)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t off = size_t(blockIdx.x) * kTile * kTile;

  float A[kPer][kPer], W[kPer][kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      A[r][c] = a[off + i * kTile + j];
      W[r][c] = (i == j) ? 1.0f : 0.0f;
    }

  for (int k = 0; k < kTile; ++k) {
    const int buf = k & 1;
    const int kc = k >> 4, kx = k & 15;
    if (tx == kx) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          if (c == kc) v = A[r][c];
        colbuf[buf][ty + 16 * r] = v;
      }
    }
    if (ty == kx) {
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        float v = 0.0f;
#pragma unroll
        for (int r = 0; r < kPer; ++r)
          if (r == kc) v = W[r][c];
        rowbuf[buf][tx + 16 * c] = v;
      }
    }
    // the only barrier of the step; the other buffer is written next step,
    // after every thread has passed this point and is done reading it
    __syncthreads();

    const float pivot = colbuf[buf][k];
    const float d = pivot > 0.0f ? sqrtf(pivot) : NAN;
    const float inv_d = 1.0f / d;
    float li[kPer], lj[kPer], xr[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = ty + 16 * r;
      li[r] = (i > k) ? colbuf[buf][i] * inv_d : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = tx + 16 * c;
      lj[c] = (j > k) ? colbuf[buf][j] * inv_d : 0.0f;
      xr[c] = rowbuf[buf][j] * inv_d;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r)
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        A[r][c] = fmaf(-li[r], lj[c], A[r][c]);
        W[r][c] = fmaf(-li[r], xr[c], W[r][c]);
      }
    if (ty == kx) {  // row k of inv(L) is final
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (r == kc) {
#pragma unroll
          for (int c = 0; c < kPer; ++c) W[r][c] = xr[c];
        }
    }
    if (tx == kx) {  // column k of L, rows k..127
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = ty + 16 * r;
        if (i >= k) Ls[i * kLd + k] = (i == k) ? d : li[r];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      Xs[(tx + 16 * c) * kLd + (ty + 16 * r)] = W[r][c];  // transposed
  __syncthreads();

  for (int idx = tid; idx < kTile * kTile; idx += kCholThreads) {
    const int i = idx >> 7, j = idx & 127;
    l_out[off + idx] = (j <= i) ? Ls[i * kLd + j] : 0.0f;
    xt_out[off + idx] = (j >= i) ? Xs[i * kLd + j] : 0.0f;
  }
}

}  // namespace auxpm

extern "C" int auxpm_chol_panel(const void* a, void* l_out, void* xt_out,
                                int B, void* stream) {
  using namespace auxpm;
  const size_t smem = sizeof(float) * 2 * kTile * kLd;
  cudaError_t err = cudaFuncSetAttribute(
      chol_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_panel_kernel<<<B, kCholThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l_out),
      static_cast<float*>(xt_out));
  return static_cast<int>(cudaGetLastError());
}
