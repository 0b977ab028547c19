// One GI bounce round after K1, fused: the NEE term, the two uniform
// draws, the hemisphere sample and the path's next ray (ops/gi.py).
//
// Replaces no Pallas kernel: it is the torch glue between two K1 launches
// of the GI tracer (ops/gi.py bounce_reference, its plain version, with
// render/pipeline.hemisphere_bounce), which the JAX package computes with
// XLA (chess2rt_tpu/ops/pallas_trace.py build_gi_tracer).  One thread per
// lane of the n = K * C lanes, K path-slabs of C lanes; block row
// blockIdx.y is the slab j, so a block reads one key of each table.  Per
// lane, in the glue's order:
//
//   hit   = alive && win >= 0
//   N     = faceforward(dir, normal): normal if dot(dir, normal) < 0
//   acc  += hit ? mult_eff * diffuse / pi * (L - ambient) : 0    (NEE on)
//   u, v  = threefry2x32 of counter lane % C under slab j's two keys
//   w     = the uniform hemisphere direction about N from (u, v), mult
//           times its BRDF weight (every lane, as the glue does)
//   orig  = hit ? orig + dir * t + N * eps : orig;  dir = hit ? w : dir
//   alive = hit
//
// mult_eff is 1 under gi_multiplier_quirk, else mult.  The environment's
// miss term stays in torch, added to acc before this kernel.  K1's rows
// are read where K1 wrote them ([rows, n], one row each); the diffuse
// albedo is K1's three rows, or the [n, 3] result of the bitmap gather
// (stride 3).  orig, dir, mult and acc ([n, 3] f32) and alive (bool) are
// updated in place.
//
// The arithmetic is the glue's, op for op in float32: each torch op is its
// own kernel, so no product is fused into an add (built with -fmad=false,
// cuda_build.py); the constants are the float32 images of the glue's Python
// scalars; a division of a tensor by a Python scalar is, on the card, a
// product with the scalar's float32 reciprocal, and so it is here; a row
// sum of three is torch's reduction order over a dimension of 3; acosf,
// sinf and cosf are CUDA's IEEE functions, as torch's.  The draws are
// csrc/threefry.cu's bit for bit (threefry.cuh).
//
// What bounds it: memory.  A lane reads 11 of K1's words, 12 words of
// state and a byte, and writes 12 words and a byte: 142 bytes, against ~170
// integer operations of the two draws and ~180 floating ones (acosf, sinf
// and cosf at ~20 each).  The key tables travel by value (2 x 2 KB of
// kernel argument): no copy from the host, no wait.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "threefry.cuh"  // threefry2x32, to_uniform, KeyTable, MAX_KEYS

namespace {

constexpr int BLOCK = 256;

// the glue's Python scalars as torch hands them to a float32 kernel: the
// double rounded to float
constexpr double PI = 3.141592653589793;  // torch.pi
constexpr float INV_PI = static_cast<float>(1.0 / PI);  // 1 / torch.pi
constexpr float TWO_PI = static_cast<float>(2.0 * PI);  // 2 * torch.pi
constexpr float HALF_PI = static_cast<float>(PI / 2.0);  // torch.pi / 2
// x / (1 / (2 * torch.pi)) on the card: x times the float32 reciprocal of
// the float32 scalar
constexpr float BRDF_DIV = 1.0f / static_cast<float>(1.0 / (2.0 * PI));

// K1's rows of the round and the scene's ambient colour (device pointers)
struct Hit {
  const float* t;
  const float* normal[3];
  const float* light[3];
  const float* diffuse[3];
  long long diffuse_stride;
  const int* win;
  const float* ambient;
};

// the path state, updated in place: [n, 3] f32 each, alive [n] bool
struct Path {
  float* orig;
  float* dir;
  float* mult;
  float* acc;
  unsigned char* alive;
};

// (a * b).sum(-1) over [n, 3] as torch's reduction adds a dimension of 3 on
// the card: two threads share a row, one adding elements 0 and 2, the
// other element 1, then the two sums
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
}

__global__ void __launch_bounds__(BLOCK)
    gi_bounce_kernel(const KeyTable keys_u, const KeyTable keys_v, long long c, Hit h, Path p, float eps, int quirk,
                     int nee) {
  const long long ci = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (ci >= c) return;
  const unsigned j = blockIdx.y;
  const long long i = (long long)j * c + ci;
  const bool hit = p.alive[i] && h.win[i] >= 0;
  float o[3], d[3], m[3], nr[3], N[3], diff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = p.orig[3 * i + k];
    d[k] = p.dir[3 * i + k];
    m[k] = p.mult[3 * i + k];
    nr[k] = h.normal[k][i];
    diff[k] = h.diffuse[k][i * h.diffuse_stride];
  }
  const bool front = dot3(d, nr) < 0.0f;  // S.faceforward
#pragma unroll
  for (int k = 0; k < 3; ++k) N[k] = front ? nr[k] : -nr[k];
  if (nee) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float term = (diff[k] * INV_PI) * (h.light[k][i] - h.ambient[k]);
      const float weighted = quirk ? term : m[k] * term;
      p.acc[3 * i + k] = p.acc[3 * i + k] + (hit ? weighted : 0.0f);
    }
  }

  // the draws: uniform_keys_kernel's element ci of slab j, under each table
  uint32_t x0 = (uint32_t)((unsigned long long)ci >> 32), x1 = (uint32_t)ci;
  threefry2x32(keys_u.k[j][0], keys_u.k[j][1], x0, x1);
  const float u = to_uniform<float>(x0, x1);
  x0 = (uint32_t)((unsigned long long)ci >> 32);
  x1 = (uint32_t)ci;
  threefry2x32(keys_v.k[j][0], keys_v.k[j][1], x0, x1);
  const float v = to_uniform<float>(x0, x1);

  // render/pipeline.hemisphere_bounce
  const float theta = TWO_PI * u;
  const float phi = acosf(fminf(fmaxf(2.0f * v - 1.0f, -1.0f), 1.0f)) - HALF_PI;
  const float cos_phi = cosf(phi);
  float w[3] = {cosf(theta) * cos_phi, sinf(phi), sinf(theta) * cos_phi};
  if (dot3(w, N) < 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = -w[k];
  }
  const float wn = dot3(w, N);
  const float cosine = wn < 0.0f ? 0.0f : wn;  // clamp_min(., 0), a NaN kept
  const float t = hit ? h.t[i] : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float color_eval = (diff[k] * INV_PI) * cosine;
    p.mult[3 * i + k] = (m[k] * color_eval) * BRDF_DIV;
    const float at = o[k] + d[k] * t;
    p.orig[3 * i + k] = hit ? at + N[k] * eps : o[k];
    p.dir[3 * i + k] = hit ? w[k] : d[k];
  }
  p.alive[i] = hit;
}

// ---- host side -------------------------------------------------------------

}  // namespace

extern "C" {

// One bounce round over K path-slabs of c lanes on `stream`.  keys_u and
// keys_v are host arrays of 2K words (slab j's key for u at 2j, 2j + 1),
// 1 <= K <= MAX_KEYS.  rows: 12 device pointers, K1's rows t, nx, ny, nz,
// lr, lg, lb, the diffuse albedo's three channels (diffuse_stride floats
// from lane to lane), win (int32) and the ambient colour ([3] f32).  path:
// 5 device pointers, orig, dir, mult, acc ([K * c, 3] f32) and alive
// ([K * c] bool).  flags: bit 0 gi_multiplier_quirk, bit 1 NEE.  Returns
// cudaGetLastError() after the launch (0 = launched; nothing to do when
// K * c == 0).
int c2rt_gi_bounce(const unsigned* keys_u, const unsigned* keys_v, int K, long long c, const void* const* rows,
                   long long diffuse_stride, void* const* path, float eps, int flags, void* stream) {
  if (K <= 0 || c <= 0) return 0;
  const long long blocks = (c + BLOCK - 1) / BLOCK;
  if (K > MAX_KEYS || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  KeyTable tu{}, tv{};
  for (int j = 0; j < K; ++j) {
    tu.k[j][0] = keys_u[2 * j];
    tu.k[j][1] = keys_u[2 * j + 1];
    tv.k[j][0] = keys_v[2 * j];
    tv.k[j][1] = keys_v[2 * j + 1];
  }
  const auto f = [&](int r) { return static_cast<const float*>(rows[r]); };
  const Hit h{f(0), {f(1), f(2), f(3)}, {f(4), f(5), f(6)}, {f(7), f(8), f(9)}, diffuse_stride,
              static_cast<const int*>(rows[10]), f(11)};
  const Path p{static_cast<float*>(path[0]), static_cast<float*>(path[1]), static_cast<float*>(path[2]),
               static_cast<float*>(path[3]), static_cast<unsigned char*>(path[4])};
  const dim3 grid((unsigned)blocks, (unsigned)K);
  gi_bounce_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(tu, tv, c, h, p, eps, flags & 1,
                                                                          (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

const char* c2rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
