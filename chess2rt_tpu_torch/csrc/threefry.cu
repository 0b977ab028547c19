// The uniform draw of jax.random for Hopper: threefry2x32 in its
// partitionable form, one thread per element.
//
// Replaces no Pallas kernel: the JAX package draws its random numbers with
// jax.random.uniform, which XLA computes (jax/_src/prng.py
// _threefry_random_bits_partitionable, jax/_src/random.py _uniform).  This
// kernel computes the same bits.  Element i of a draw of shape S (flat,
// row-major) hashes the 64-bit counter i, split as (i >> 32, i & 0xffffffff),
// under the key (k1, k2) with 20 rounds of threefry2x32, giving (b1, b2):
// f32 takes the 32 bits b1 ^ b2, f64 the 64 bits b1 << 32 | b2, and the
// mantissa bits become a float in [1, 2) less 1.  The draw is positional:
// element i depends on i and the key only, so a draw of n elements gathered
// at some lanes equals what those lanes of the full draw hold.
//
// What bounds it on this card: about 80 integer operations per element
// against 4 or 8 bytes written, so the integer pipes, not the memory; a
// thread computes one element and writes it, neighbouring threads
// neighbouring addresses.  The key arrives as two kernel arguments: keys are
// derived on the host (ops/prng.py), so no draw waits on the device.
//
// The batched draw (c2rt_uniform_keys) is K draws of C elements under K
// keys in one launch, slab j of the output the draw of key j: element i
// takes key i / C and counter i % C, as jax.vmap of jax.random.uniform over
// a [K, 2] key array gives them (the GI renderer's K path-slabs,
// ops/gi.py).  Block row blockIdx.y is the slab, so a block reads one key.
// The key table travels by value as a kernel argument (up to MAX_KEYS keys,
// 2 KB): a device buffer would need a copy from the host per draw, and a
// copy from pageable memory makes the host wait.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"  // threefry2x32, to_uniform, KeyTable

namespace {

constexpr int BLOCK = 256;

template <class T>
__global__ void __launch_bounds__(BLOCK) uniform_kernel(uint32_t k1, uint32_t k2, long long n, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32), x1 = (uint32_t)i;
  threefry2x32(k1, k2, x0, x1);
  out[i] = to_uniform<T>(x0, x1);
}

template <class T>
__global__ void __launch_bounds__(BLOCK) uniform_keys_kernel(KeyTable keys, long long c, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= c) return;
  const unsigned j = blockIdx.y;
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32), x1 = (uint32_t)i;
  threefry2x32(keys.k[j][0], keys.k[j][1], x0, x1);
  out[(long long)j * c + i] = to_uniform<T>(x0, x1);
}

// ---- host side -------------------------------------------------------------

}  // namespace

extern "C" {

// Writes n uniforms in [0, 1) of the key (k1, k2) to `out` on `stream`:
// f32 when f64 == 0, else f64.  Returns cudaGetLastError() after the
// launch (0 = launched; nothing to do when n <= 0).
int c2rt_uniform(unsigned k1, unsigned k2, long long n, void* out, int f64, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    uniform_kernel<double><<<(unsigned)blocks, BLOCK, 0, st>>>(k1, k2, n, static_cast<double*>(out));
  } else {
    uniform_kernel<float><<<(unsigned)blocks, BLOCK, 0, st>>>(k1, k2, n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Writes K draws of c uniforms each to `out` ([K, c], row j under the key
// (keys[2j], keys[2j + 1])) on `stream` in one launch: f32 when f64 == 0,
// else f64.  `keys` is a host array of 2K words, 1 <= K <= MAX_KEYS.
// Returns cudaGetLastError() after the launch (0 = launched; nothing to do
// when K * c == 0).
int c2rt_uniform_keys(const unsigned* keys, int K, long long c, void* out, int f64, void* stream) {
  if (K <= 0 || c <= 0) return 0;
  const long long blocks = (c + BLOCK - 1) / BLOCK;
  if (K > MAX_KEYS || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  KeyTable table{};
  for (int j = 0; j < K; ++j) {
    table.k[j][0] = keys[2 * j];
    table.k[j][1] = keys[2 * j + 1];
  }
  const dim3 grid((unsigned)blocks, (unsigned)K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    uniform_keys_kernel<double><<<grid, BLOCK, 0, st>>>(table, c, static_cast<double*>(out));
  } else {
    uniform_keys_kernel<float><<<grid, BLOCK, 0, st>>>(table, c, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c2rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
