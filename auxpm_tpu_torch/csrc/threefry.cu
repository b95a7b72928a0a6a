// threefry2x32 (20 rounds) fused with what turns its words into draws.
//
// Replaces no TPU kernel: the JAX package takes its random numbers from
// jax.random, which XLA compiles (partitionable threefry2x32, JAX's
// default).  Its plain version is ops/threefry.py's draw_plain, about two
// hundred small launches per draw; this kernel computes the same function in
// one launch.  ops/threefry.py is also its wrapper.
//
// One thread per (key, counter) element, grid-stride over all of them.  Key
// i (two uint32 words, held in int64 as core/prng.py holds them) meets the
// counters c0 + j, j < m (the low words of iota_2x32_shape; the high word is
// 0), or, where a data array is given, data[i * m + j] (fold_in's data).
// Outputs, by mode:
//   0 words   : int64 (n, m, 2), both cipher words (split, fold_in);
//   1 bits    : int64 (n, m), y0 ^ y1 (jax.random.bits);
//   2 uniform : float32 (n, m), max(lo, f (hi - lo) + lo) with f in [0, 1)
//               from the 23 high bits (jax.random.uniform);
//   3 normal  : float32 (n, m), sqrt(2) erf_inv(u), u uniform on
//               (nextafter(-1, 0), 1) passed as lo, hi; erf_inv is XLA's
//               float32 polynomial.
// Every a * b + c that XLA contracts into an FMA (the uniform's scale, each
// Horner step) is __fmaf_rn; every other product and sum is an explicitly
// rounded intrinsic, so nvcc contracts nothing else and the draws equal the
// plain version's: words, bits and uniforms bitwise, normals to log1pf.
//
// Bound on this card: integer operations.  A cipher call is 71 int32
// operations (x1's first add; 20 rounds of add, rotate, xor; five key
// injections of two adds each), plus up to 3 for the output (xor, shift,
// or), for 4 or 8 bytes of output: far above the 16.7 T int32 ops/s :
// 3.35 TB/s balance.
// The design does nothing about it yet: one thread per counter, words
// straight to device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace auxpm {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float unit_uniform(uint32_t bits) {
  // the 23 high bits as the mantissa of a float in [1, 2), minus 1
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float uniform(uint32_t bits, float lo, float hi) {
  const float f = unit_uniform(bits);
  return fmaxf(lo, __fmaf_rn(f, __fsub_rn(hi, lo), lo));
}

// XLA's ErfInv32, highest degree first (ops/threefry.py _W_LT_5 / _W_GE_5)
__constant__ float kLt5[9] = {2.81022636e-08f, 3.43273939e-07f,
                              -3.5233877e-06f, -4.39150654e-06f,
                              0.00021858087f, -0.00125372503f,
                              -0.00417768164f, 0.246640727f, 1.50140941f};
__constant__ float kGe5[9] = {-0.000200214257f, 0.000100950558f,
                              0.00134934322f, -0.00367342844f,
                              0.00573950773f, -0.0076224613f,
                              0.00943887047f, 1.00167406f, 2.83297682f};

__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  const float* c = lt ? kLt5 : kGe5;
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, c[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.40282347e+38f) : __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ keys,
                const int64_t* __restrict__ data, int64_t n, int64_t m,
                int64_t c0, int mode, float lo, float hi, float sqrt2,
                void* __restrict__ out) {
  const int64_t total = n * m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += stride) {
    const int64_t i = e / m;
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * i]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * i + 1]);
    const uint32_t ctr = static_cast<uint32_t>(
        data != nullptr ? data[e] : c0 + (e - i * m));
    uint32_t y0, y1;
    threefry2x32(k0, k1, 0u, ctr, y0, y1);
    switch (mode) {
      case 0: {
        int64_t* o = static_cast<int64_t*>(out);
        o[2 * e] = static_cast<int64_t>(y0);
        o[2 * e + 1] = static_cast<int64_t>(y1);
        break;
      }
      case 1:
        static_cast<int64_t*>(out)[e] = static_cast<int64_t>(y0 ^ y1);
        break;
      case 2:
        static_cast<float*>(out)[e] = uniform(y0 ^ y1, lo, hi);
        break;
      default:
        static_cast<float*>(out)[e] =
            __fmul_rn(sqrt2, erf_inv(uniform(y0 ^ y1, lo, hi)));
        break;
    }
  }
}

}  // namespace auxpm

extern "C" int auxpm_threefry(const int64_t* keys, const int64_t* data,
                              int64_t n, int64_t m, int64_t c0, int mode,
                              float lo, float hi, float sqrt2, void* out,
                              cudaStream_t stream) {
  const int64_t total = n * m;
  if (total <= 0) return 0;
  int64_t blocks = (total + auxpm::kThreads - 1) / auxpm::kThreads;
  const int64_t max_blocks = 132 * 64;   // grid-stride beyond 64 blocks / SM
  if (blocks > max_blocks) blocks = max_blocks;
  auxpm::threefry_kernel<<<static_cast<unsigned>(blocks), auxpm::kThreads,
                            0, stream>>>(keys, data, n, m, c0, mode, lo, hi,
                                         sqrt2, out);
  return static_cast<int>(cudaGetLastError());
}
