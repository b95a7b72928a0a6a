// ARD squared-exponential correlation matrix, one launch for a batch of
// chains:
//
//     d2[i,j]  = max(sq_i + sq_j - 2 * sum_k xs[i,k] xs[j,k], 0)
//     R[i,j]   = exp(-0.5 * d2[i,j]) + jitter * (i == j)
//     out[i,j] = R[i,j] * mask_i * mask_j + (i == j) * (1 - mask_i)
//
// with xs = x * exp(-log_ell) the per-chain scaled data (B, n, d), formed
// in the kernel from x (n, d) and log_ells (B, d).
//
// Replaces the TPU kernel auxpm_tpu/ops/gram.py::_se_gram_kernel (wrapper
// _se_gram_ard_pallas).  What is kept: the reference's expression, i.e. the
// expansion sq_i + sq_j - 2 xs_i.xs_j with the cross term in exact float32
// (sequential FMAs on the CUDA cores; no tensor cores, no TF32, no
// ex2.approx: the expansion cancels for nearby points, R(ell) is close to
// singular, and a Gram ~1e-6 away moves log L-hat by ~2e-2), the clamp at 0
// and exp(-0.5 .).  What differs: the TPU kernel leaves the jitter and the
// pad fix-up to elementwise passes outside the kernel because its batching
// rule cannot tile a scalar operand; here the epilogue (jitter on the
// diagonal, zero covariance to and from pad rows, unit pad diagonal) is
// applied before the one write of each element, and the scaling of x by
// exp(-log_ell) happens as the data are staged (three elementwise launches
// fewer per Gram than scaling in PyTorch first, the same floats: the
// element's expf(-log_ell_k) and one product, as torch.exp and mul form it).
//
// Bound: bytes.  The work is a write of B*n*n*4 bytes (105 MB at B=64,
// n=640) against 2*d + ~8 FLOPs and one expf per element; the inputs
// (x, log_ells, mask) are noise.  Design for Hopper:
//   * a persistent grid (resident blocks x SMs) over the items (chain, tile
//     pair ti >= tj) of 64 x 64 tiles: 55 items per chain at n = 640 where
//     the full square has 100 tiles.  Block g takes a contiguous run of
//     items, so it meets one or two chains;
//   * per (block, chain) the chain's xs is formed and staged once in shared
//     memory as [k][row] (row pitch n rounded up to 64, pad rows zero) with
//     its squared norms and mask: a thread reads 4 columns as one float4
//     with no bank conflict and the staging needs no integer division;
//   * a thread computes 4 rows x 4 consecutive columns of a tile and stores
//     each row's 4 as one streaming float4 (__stcs), 16 threads covering a
//     256-byte row segment (where 4 does not divide n, the kernel's other
//     instantiation: rows start unaligned and the four go out one by one,
//     columns past n left out; the reference pads any n to its tiles); an
//     off-diagonal tile is also written at its mirror position: the tile
//     goes through shared memory (pitch 65), transposed, so the mirror's
//     stores are whole row segments too;
//   * every element keeps the expression of the full-square kernel this
//     replaced (one 64 x 64 tile per block, both triangles computed):
//     fmaf over k ascending for the cross term and for sq, fmaxf(sq_i + sq_j
//     - 2 cross, 0), expf(-0.5 d2), then the jitter and the pad fix-up.
//     fmaf(a, b, c) == fmaf(b, a, c) and sq_i + sq_j == sq_j + sq_i, so the
//     mirror element (j, i) is bitwise the one the full-square kernel
//     computed; its mask product is taken in its own order, (v m_j) m_i.
// Shared memory per block: 4 (n_pad (d + 2) + 64 * 65) bytes (40 KB at
// n = 640, d = 7); the wrapper refuses shapes past a block's 227 KB.
#include <cuda_runtime.h>
#include <math.h>

namespace auxpm {

constexpr int kGramTile = 64;
constexpr int kGramThreads = 256;
constexpr int kGramLdT = kGramTile + 1;   // pitch of the transposed tile

__host__ __device__ inline int gram_pad(int n) {
  return (n + kGramTile - 1) / kGramTile * kGramTile;
}

inline size_t gram_smem_bytes(int n, int d) {
  return sizeof(float) *
         (size_t(gram_pad(n)) * (d + 2) + size_t(kGramTile) * kGramLdT);
}

// Columns j .. j + 3 of one output row, those below n: one streaming float4
// where 4 divides n (kQuads: the row then starts 16-byte aligned), else
// float by float.  The values are stored as given.
template <bool kQuads>
__device__ __forceinline__ void store_quad(float* dst, const float* v, int j,
                                           int n) {
  if constexpr (kQuads) {
    if (j < n)   // all four columns or none
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2],
                                                         v[3]));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < n) __stcs(dst + c, v[c]);
  }
}

template <bool kQuads>
__global__ void __launch_bounds__(kGramThreads)
se_gram_ard_kernel(const float* __restrict__ x,         // (n, d)
                   const float* __restrict__ log_ells,  // (B, d), row stride
                   const float* __restrict__ mask,      // (n,) or nullptr
                   float* __restrict__ out, int B, int n, int d,
                   int le_stride, float jitter) {
  extern __shared__ __align__(16) float gsm[];
  const int np = gram_pad(n);
  float* xt = gsm;                   // [k][row], pitch np
  float* sq = xt + size_t(d) * np;   // [row]
  float* mk = sq + np;               // [row]
  float* tt = mk + np;               // the tile, transposed: [col][row]

  const int tid = threadIdx.x;
  const int n_tiles = np / kGramTile;
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  const long long total = (long long)B * pairs;
  const long long w0 = total * blockIdx.x / gridDim.x;
  const long long w1 = total * (blockIdx.x + 1) / gridDim.x;
  if (w0 >= w1) return;

  // the first item's (chain, ti, tj); later items step through the lower
  // triangle row by row
  int b = int(w0 / pairs);
  int p = int(w0 - (long long)b * pairs);
  int ti = 0;
  while (p > ti) p -= ++ti;
  int tj = p;
  int staged = -1;

  const int c0 = (tid & 15) * 4;   // 4 consecutive columns
  const int r0 = tid >> 4;         // rows r0, r0 + 16, r0 + 32, r0 + 48

  for (long long w = w0; w < w1; ++w) {
    if (b != staged) {             // the chain's xs, norms and mask
      __syncthreads();
      const float* le = log_ells + size_t(b) * le_stride;
      for (int k = 0; k < d; ++k) {
        const float scale = expf(-le[k]);
        for (int r = tid; r < np; r += kGramThreads)
          xt[k * np + r] = r < n ? x[size_t(r) * d + k] * scale : 0.0f;
      }
      __syncthreads();
      for (int r = tid; r < np; r += kGramThreads) {
        float s = 0.0f;
        for (int k = 0; k < d; ++k)
          s = fmaf(xt[k * np + r], xt[k * np + r], s);
        sq[r] = s;
        mk[r] = (mask != nullptr && r < n) ? mask[r] : 1.0f;
      }
      __syncthreads();
      staged = b;
    }
    const int i0 = ti * kGramTile, j0 = tj * kGramTile;
    float cross[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) cross[rr][c] = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float* row = xt + k * np;
      const float4 xj = *reinterpret_cast<const float4*>(row + j0 + c0);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float a = row[i0 + r0 + 16 * rr];
        cross[rr][0] = fmaf(a, xj.x, cross[rr][0]);
        cross[rr][1] = fmaf(a, xj.y, cross[rr][1]);
        cross[rr][2] = fmaf(a, xj.z, cross[rr][2]);
        cross[rr][3] = fmaf(a, xj.w, cross[rr][3]);
      }
    }
    float* ob = out + size_t(b) * n * n;
    const bool mirror = ti != tj;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = r0 + 16 * rr;
      const int gi = i0 + r;
      const float sqi = sq[gi], mi = mk[gi];
      float res[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gj = j0 + c0 + c;
        const float sqj = sq[gj], mj = mk[gj];
        const float d2 = fmaxf(sqi + sqj - 2.0f * cross[rr][c], 0.0f);
        float v = expf(-0.5f * d2);
        if (gi == gj) v += jitter;
        float vt = v;
        if (mask != nullptr) {
          vt = v * mj * mi;
          v = v * mi * mj;
          if (gi == gj) v += 1.0f - mi;
        }
        res[c] = v;
        if (mirror) tt[(c0 + c) * kGramLdT + r] = vt;
      }
      if (gi < n)
        store_quad<kQuads>(ob + size_t(gi) * n + j0 + c0, res, j0 + c0, n);
    }
    if (mirror) {                  // uniform in the block
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int jr = r0 + 16 * rr;
        const float* src = tt + jr * kGramLdT + c0;
        if (j0 + jr < n)
          store_quad<kQuads>(ob + size_t(j0 + jr) * n + i0 + c0, src, i0 + c0,
                             n);
      }
      __syncthreads();             // tt is rewritten by the next item
    }
    if (++tj > ti) {               // the next item
      tj = 0;
      if (++ti == n_tiles) {
        ti = 0;
        ++b;
      }
    }
  }
}

}  // namespace auxpm

// x (n, d), log_ells (B, d) with row stride le_stride, mask (n,) or null
// -> out (B, n, n), any n with gram_smem_bytes(n, d) within a block's
// shared memory (the wrapper checks it).
extern "C" int auxpm_se_gram_ard(const void* x, const void* log_ells,
                                 const void* mask, void* out, int B, int n,
                                 int d, int le_stride, float jitter,
                                 void* stream) {
  using namespace auxpm;
  // float4 stores where 4 divides n, else float by float
  const auto kernel =
      n % 4 == 0 ? se_gram_ard_kernel<true> : se_gram_ard_kernel<false>;
  const size_t smem = gram_smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kGramThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pad_tiles = gram_pad(n) / kGramTile;
  const long long items =
      (long long)B * (pad_tiles * (pad_tiles + 1) / 2);
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (items < grid) grid = items;
  kernel<<<int(grid), kGramThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_ells),
      static_cast<const float*>(mask), static_cast<float*>(out), B, n, d,
      le_stride, jitter);
  return static_cast<int>(cudaGetLastError());
}
