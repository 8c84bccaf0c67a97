// JAX's threefry2x32 hash and its float draws, as device functions: the
// arithmetic of threefry.cu's draw kernel, which neuron_step.cu's drawing
// Izhikevich kernel runs too, so that a drive hashed in registers there
// equals the draw kernel's output bit for bit.
//
// Both sources build with -fmad=false (kernels/_build.py); every rounding
// below is an explicit round-to-nearest intrinsic, so neither the flag nor
// the caller's context changes a bit.

#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, as jax/_src/prng.py's _threefry2x32_lowering.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// XLA's float32 erf_inv (chlo.erf_inv), operation by operation.
__device__ __forceinline__ float erf_inv_xla(float x) {
  const float w = -log1pf(__fmul_rn(x, -x));
  const bool small = w < 5.0f;
  const float z = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  const float cs[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                       -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                       -0.00417768164f, 0.246640727f, 1.50140941f};
  const float cl[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                       -0.00367342844f, 0.00573950773f, -0.0076224613f,
                       0.00943887047f, 1.00167406f, 2.83297682f};
  float p = small ? cs[0] : cl[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, z, small ? cs[i] : cl[i]);
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : __fmul_rn(p, x);
}

// The partitionable scheme's 32 bits of element j under key (k0, k1): the
// xor of the two words of the hash of the counter (j >> 32, j).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         unsigned long long j) {
  uint32_t x0 = static_cast<uint32_t>(j >> 32);
  uint32_t x1 = static_cast<uint32_t>(j);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random.uniform's float32 of 32 bits: 23 mantissa bits under 1.0's
// exponent, minus 1.
__device__ __forceinline__ float uniform(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

// jax.random.normal's float32 of 32 bits: sqrt(2) erf_inv(u), u uniform on
// (nextafter(-1, 0), 1).
__device__ __forceinline__ float normal(uint32_t b) {
  const float u_lo = -0.99999994f;              // nextafter(-1, 0)
  const float u = fmaxf(u_lo, __fadd_rn(__fmul_rn(uniform(b), 2.0f), u_lo));
  return __fmul_rn(erf_inv_xla(u), 1.41421354f);
}

}  // namespace threefry
