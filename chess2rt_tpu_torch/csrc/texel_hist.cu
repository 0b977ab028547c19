// K2 for Hopper: the texel-gradient histogram, a segmented sum over sorted
// keys.
//
// Replaces the TPU kernel chess2rt_tpu/ops/texel_hist.py texel_histogram
// (kernel :102, pallas_call :190).  It computes what that kernel computes:
// for keys[N] int32 sorted ascending and vals[N, C] f32 (C <= 16),
//     out[t, c] = sum of vals[i, c] over the rows i with keys[i] == t,
// for t in [0, n_texels); rows whose key lies outside that range are
// dropped.  The caller zeroes out[n_texels, C]; texels no row names stay 0.
//
// Design.  The TPU kernel built one-hot matrices and contracted them on the
// MXU (with a bf16 hi/lo split of the f32 cotangents) only because Mosaic
// had no scatter.  Here one warp owns one texel: it finds the texel's run
// [lo, hi) of the sorted keys by two binary searches, its 32 lanes stride
// over the run's rows (a warp reads 32 consecutive rows, C floats each, in
// one pass), and a shuffle tree sums the lanes.  Runs are disjoint, so no
// atomics; the summation order is fixed, so the result is deterministic.
// A long run (every ray that missed the scene shares one key) is spread over
// 32 lanes instead of one thread.  Per-channel accumulators are a fully
// unrolled array of 16 guarded by C, so they stay in registers.
//
// Plain f32 arithmetic, no --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 16;            // ops/texel_hist.py MAX_CHANNELS
constexpr int WARPS_PER_BLOCK = 8;

// first index in [0, n) with keys[i] >= t (n if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < t) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
texel_hist_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                  float* __restrict__ out, int n, int c, int n_texels) {
  const int t = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_texels) return;  // warp-uniform
  const int lo = lower_bound(keys, n, t);
  if (lo >= n || __ldg(keys + lo) != t) return;  // no row: stays zero
  const int hi = lower_bound(keys, n, t + 1);

  float acc[MAX_C];
#pragma unroll
  for (int k = 0; k < MAX_C; ++k) acc[k] = 0.0f;
  for (int i = lo + lane; i < hi; i += 32) {
    const float* row = vals + (size_t)i * c;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) acc[k] += __ldg(row + k);
  }
#pragma unroll
  for (int k = 0; k < MAX_C; ++k) {
    if (k < c) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      acc[k] = v;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) out[(size_t)t * c + k] = acc[k];
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`: keys [n] int32 sorted ascending, vals [n, c] f32
// row-major, out [n_texels, c] f32 zeroed by the caller.  Returns
// cudaGetLastError() after the launch (0 = launched).
int c2rt_texel_hist(const int* keys, const float* vals, float* out, int n, int c, int n_texels,
                    void* stream) {
  if (n <= 0 || n_texels <= 0) return 0;
  if (c <= 0 || c > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_texels + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  texel_hist_kernel<<<grid, WARPS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, vals, out, n, c, n_texels);
  return static_cast<int>(cudaGetLastError());
}

const char* c2rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
