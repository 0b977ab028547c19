// The threefry2x32 rounds and the bits-to-uniform step of jax.random, shared
// by the kernels that draw: csrc/threefry.cu (the draws alone) and
// csrc/gi_bounce.cu (the GI bounce round, which draws its two uniforms
// inline).  Bit for bit jax/_src/prng.py _threefry2x32_lowering and
// jax/_src/random.py _uniform; ops/prng.py holds the plain version.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32 with 20 rounds, as jax/_src/prng.py _threefry2x32_lowering
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x0, uint32_t& x1) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k1, k2, k3};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k1;
  x1 += k2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

template <class T>
__device__ __forceinline__ T to_uniform(uint32_t b1, uint32_t b2);

template <>
__device__ __forceinline__ float to_uniform<float>(uint32_t b1, uint32_t b2) {
  const uint32_t bits = ((b1 ^ b2) >> 9) | 0x3f800000u;
  return __uint_as_float(bits) - 1.0f;
}

template <>
__device__ __forceinline__ double to_uniform<double>(uint32_t b1, uint32_t b2) {
  const unsigned long long bits =
      ((((unsigned long long)b1 << 32) | b2) >> 12) | 0x3ff0000000000000ull;
  return __longlong_as_double((long long)bits) - 1.0;
}

// the most keys one launch takes, as a kernel argument by value (2 KB)
constexpr int MAX_KEYS = 256;
struct KeyTable {
  uint32_t k[MAX_KEYS][2];
};

}  // namespace
