// ARD squared-exponential correlation matrix, one launch for a batch of
// chains:
//
//     d2[i,j]  = max(sq_i + sq_j - 2 * sum_k xs[i,k] xs[j,k], 0)
//     R[i,j]   = exp(-0.5 * d2[i,j]) + jitter * (i == j)
//     out[i,j] = R[i,j] * mask_i * mask_j + (i == j) * (1 - mask_i)
//
// with xs = x / ell the per-chain pre-scaled data (B, n, d).
//
// Replaces the TPU kernel auxpm_tpu/ops/gram.py::_se_gram_kernel (wrapper
// _se_gram_ard_pallas).  What is kept: the reference's expression, i.e. the
// expansion sq_i + sq_j - 2 xs_i.xs_j with the cross term in exact float32
// (sequential FMAs on the CUDA cores; no tensor cores, no TF32: the expansion
// cancels for nearby points and a reduced-precision cross term makes the
// matrix indefinite), the clamp at 0 and exp(-0.5 .).  What differs: the TPU
// kernel leaves the jitter and the pad fix-up to elementwise passes outside
// the kernel because its batching rule cannot tile a scalar operand; nothing
// of the sort holds here, so the epilogue (jitter on the diagonal, zero
// covariance to and from pad rows, unit pad diagonal) is applied before the
// one write of each element.
//
// Bound: bytes.  The work is a write of B*n*n*4 bytes (105 MB at B=64,
// n=640) against 2*d + ~6 FLOPs and one expf per element; the inputs
// (B*n*d*4 bytes) are noise.  Design: a block of 256 threads owns a 64 x 64
// tile; the tile's 64 + 64 rows of xs and their squared norms sit in shared
// memory; each thread computes 4 rows x 4 consecutive columns and writes one
// float4 per row, so a warp writes two full 256-byte row segments.
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kGramTile = 64;
constexpr int kGramThreads = 256;
constexpr int kGramMaxD = 32;

__global__ void __launch_bounds__(kGramThreads)
se_gram_ard_kernel(const float* __restrict__ xs,
                   const float* __restrict__ mask,  // (n,) or nullptr
                   float* __restrict__ out, int n, int d, float jitter) {
  __shared__ float xi[kGramTile][kGramMaxD + 1];
  __shared__ float xj[kGramTile][kGramMaxD + 1];
  __shared__ float sqi[kGramTile], sqj[kGramTile];
  __shared__ float mi[kGramTile], mj[kGramTile];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kGramTile;
  const int j0 = blockIdx.x * kGramTile;
  const float* xb = xs + size_t(blockIdx.z) * n * d;
  float* ob = out + size_t(blockIdx.z) * n * n;

  for (int idx = tid; idx < kGramTile * d; idx += kGramThreads) {
    const int r = idx / d, k = idx - r * d;
    xi[r][k] = (i0 + r < n) ? xb[size_t(i0 + r) * d + k] : 0.0f;
    xj[r][k] = (j0 + r < n) ? xb[size_t(j0 + r) * d + k] : 0.0f;
  }
  __syncthreads();
  if (tid < 2 * kGramTile) {
    const bool rows = tid < kGramTile;
    const int r = rows ? tid : tid - kGramTile;
    const float* row = rows ? xi[r] : xj[r];
    float s = 0.0f;
    for (int k = 0; k < d; ++k) s = fmaf(row[k], row[k], s);
    const int g = (rows ? i0 : j0) + r;
    const float m = (mask != nullptr && g < n) ? mask[g] : 1.0f;
    if (rows) { sqi[r] = s; mi[r] = m; } else { sqj[r] = s; mj[r] = m; }
  }
  __syncthreads();

  const int c0 = (tid & 15) * 4;  // 4 consecutive columns
  const int r0 = tid >> 4;        // rows r0, r0 + 16, r0 + 32, r0 + 48
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = r0 + 16 * rr;
    const int gi = i0 + r;
    if (gi >= n) continue;
    float cross[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < d; ++k) {
      const float a = xi[r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) cross[c] = fmaf(a, xj[c0 + c][k], cross[c]);
    }
    float res[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + c0 + c;
      const float d2 = fmaxf(sqi[r] + sqj[c0 + c] - 2.0f * cross[c], 0.0f);
      float v = expf(-0.5f * d2);
      if (gi == gj) v += jitter;
      if (mask != nullptr) {
        v = v * mi[r] * mj[c0 + c];
        if (gi == gj) v += 1.0f - mi[r];
      }
      res[c] = v;
    }
    float* dst = ob + size_t(gi) * n + j0 + c0;
    if (j0 + c0 + 3 < n) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(res[0], res[1], res[2], res[3]);
    } else {
      for (int c = 0; c < 4; ++c)
        if (j0 + c0 + c < n) dst[c] = res[c];
    }
  }
}

}  // namespace auxpm

// xs (B, n, d) pre-scaled, mask (n,) or null -> out (B, n, n).  n % 4 == 0
// (float4 stores), d <= 32.
extern "C" int auxpm_se_gram_ard(const void* xs, const void* mask, void* out,
                                 int B, int n, int d, float jitter,
                                 void* stream) {
  using namespace auxpm;
  const int tiles = (n + kGramTile - 1) / kGramTile;
  const dim3 grid(tiles, tiles, B);
  se_gram_ard_kernel<<<grid, kGramThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(mask),
      static_cast<float*>(out), n, d, jitter);
  return static_cast<int>(cudaGetLastError());
}
