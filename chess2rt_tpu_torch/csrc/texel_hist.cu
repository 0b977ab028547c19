// K2 for Hopper: the texel-gradient histogram, a row-parallel segmented sum
// over sorted keys.
//
// Replaces the TPU kernel chess2rt_tpu/ops/texel_hist.py texel_histogram
// (kernel :102, pallas_call :190).  It computes what that kernel computes:
// for keys[N] int32 sorted ascending and vals[N, C] f32 (C <= 16),
//     out[t, c] = sum of vals[i, c] over the rows i with keys[i] == t,
// for t in [0, n_texels); rows whose key lies outside that range are
// dropped.  Texel rows no key names stay 0: the wrapper hands in a zeroed
// out[n_texels, C] (torch.zeros, one memset; its time is part of a call).
//
// What bounds it on this card: bytes.  Every key and every cotangent row is
// read once and every named texel row written once (about 20 MB at the
// gradient step's shapes, 6 microseconds at the card's memory rate); the
// arithmetic is one add per value.  The work must therefore be spread
// evenly over the ROWS and read in wide, contiguous pieces.  The TPU kernel
// had no scatter and built one-hot matrices for the MXU; a design that gives
// each TEXEL a warp searches the keys twice per texel and leaves the one
// long run (every ray that missed the scene shares a key) to a single warp.
//
// Design.  A block owns a fixed span of consecutive rows and walks it in
// chunks of one row per thread.  A thread reads its row with 16-byte loads
// (8-byte or scalar loads when C or the pointer does not allow them: `vec`),
// its key and both neighbours' keys, and marks a run head (keys[i] !=
// keys[i-1]).  The chunk is reduced by run: a warp-shuffle segmented scan,
// the warps' open sums chained through shared memory, the open sum of a
// chunk's last run carried to the next chunk.  The thread on a run's last
// row holds the run's sum.  No search, no atomics; the work does not depend
// on n_texels, and a long run is cut into as many pieces as it has spans.
//
// A run that lies inside one span is stored straight to its texel row.  A
// run that crosses a span's edge (at most one at each end) is written as a
// partial sum with its key to a scratch table of two rows per span, and a
// second launch of the SAME kernel, one block over those 2 * n_spans rows,
// sums the partials of equal keys and stores them.  A span that one run
// covers entirely writes its sum to the first slot and the key with zeros
// to the second, so equal keys stay adjacent; an unused slot has key -1.
// Every texel row is written by exactly one thread in one of the two
// launches, and every sum is taken in a fixed order: the same inputs give
// the same bits, which float atomics on the long run's row would not.
//
// Plain f32 arithmetic, no --use_fast_math.  Tensor cores have no part in a
// sum of rows by key.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 16;      // ops/texel_hist.py MAX_CHANNELS
constexpr int MAX_WARPS = 32;  // a block has at most 1024 threads
constexpr unsigned FULL = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int c, float (&acc)[MAX_C]) {
  if (VEC == 4) {
#pragma unroll
    for (int q = 0; q < MAX_C / 4; ++q) {
      if (4 * q < c) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row) + q);
        acc[4 * q] = v.x;
        acc[4 * q + 1] = v.y;
        acc[4 * q + 2] = v.z;
        acc[4 * q + 3] = v.w;
      }
    }
  } else if (VEC == 2) {
#pragma unroll
    for (int q = 0; q < MAX_C / 2; ++q) {
      if (2 * q < c) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(row) + q);
        acc[2 * q] = v.x;
        acc[2 * q + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) acc[k] = __ldg(row + k);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int c, const float (&v)[MAX_C]) {
  if (VEC == 4) {
#pragma unroll
    for (int q = 0; q < MAX_C / 4; ++q)
      if (4 * q < c)
        reinterpret_cast<float4*>(row)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if (VEC == 2) {
#pragma unroll
    for (int q = 0; q < MAX_C / 2; ++q)
      if (2 * q < c) reinterpret_cast<float2*>(row)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) row[k] = v[k];
  }
}

// Block b sums the runs of rows [b * span, min(n, (b + 1) * span)).  With
// `skeys` / `svals` ([2 * gridDim.x] and [2 * gridDim.x, c]) the runs that
// cross the span's edges go there; without them the span must be all rows.
template <int VEC>
__global__ void __launch_bounds__(1024)
seg_sum_kernel(const int* __restrict__ keys, const float* __restrict__ vals, float* __restrict__ out,
               int n, int c, int n_texels, int span, int* __restrict__ skeys,
               float* __restrict__ svals) {
  // the warps' open sums and whether a warp holds a run head, the sum
  // carried into a chunk and whether its run began before the span; all
  // double-buffered by chunk parity, so one barrier per chunk is enough
  __shared__ float wtail[2][MAX_WARPS][MAX_C];
  __shared__ int whead[2][MAX_WARPS];
  __shared__ float ccarry[2][MAX_C];
  __shared__ int cleft[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockDim.x;
  const long long lo64 = (long long)blockIdx.x * span;
  const int lo = (int)lo64;
  const int hi = (int)(lo64 + span < (long long)n ? lo64 + span : (long long)n);

  if (tid < MAX_C) ccarry[0][tid] = 0.0f;
  if (tid == 0) {
    cleft[0] = 1;  // read only when the span's first row is no head: the run began before it
    if (skeys != nullptr) skeys[2 * blockIdx.x] = skeys[2 * blockIdx.x + 1] = -1;
  }
  __syncthreads();

  int buf = 0;
  for (int r0 = lo; r0 < hi; r0 += chunk, buf ^= 1) {
    const int i = r0 + tid;  // r0 + tid < hi + 1024 <= 2^31 - 1 + 1024: the wrapper keeps n below 2^31 - 1024
    const bool valid = i < hi;
    float acc[MAX_C];
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) acc[k] = 0.0f;
    int key = -1;
    bool head = true, last = false;  // rows past the span: heads of nothing
    if (valid) {
      key = __ldg(keys + i);
      head = i == 0 || __ldg(keys + i - 1) != key;
      last = i == n - 1 || __ldg(keys + i + 1) != key;
      load_row<VEC>(vals + (size_t)i * c, c, acc);
    }

    // segmented inclusive scan inside the warp: a segment starts at a head,
    // and at lane 0
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned starts = heads | 1u;
    const int seg = 31 - __clz(starts & (FULL >> (31 - lane)));  // my segment's first lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < MAX_C; ++k) {
        if (k < c) {
          const float v = __shfl_up_sync(FULL, acc[k], off);
          if (lane - off >= seg) acc[k] += v;
        }
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < MAX_C; ++k)
        if (k < c) wtail[buf][warp][k] = acc[k];
      whead[buf][warp] = heads != 0u;
    }
    __syncthreads();

    // a segment that starts at lane 0 without a head continues the run of
    // the warps before it (back to the last one that holds a head), or of
    // the chunks before it
    const bool open = !((heads >> seg) & 1u);  // then seg == 0
    const bool ends_chunk = tid == chunk - 1 || i == hi - 1;
    bool from_left = false;
    if (valid && open && (last || ends_chunk)) {
      int j = warp - 1;
      while (j >= 0 && !whead[buf][j]) --j;
      from_left = j < 0 && cleft[buf] != 0;
#pragma unroll
      for (int k = 0; k < MAX_C; ++k) {
        if (k < c) {
          float carry = j < 0 ? ccarry[buf][k] : 0.0f;
          for (int w = j < 0 ? 0 : j; w < warp; ++w) carry += wtail[buf][w][k];
          acc[k] = carry + acc[k];
        }
      }
    }

    if (valid && last) {
      if (from_left) {  // began before the span: a partial sum
        skeys[2 * blockIdx.x] = key;
        store_row<VEC>(svals + (size_t)(2 * blockIdx.x) * c, c, acc);
      } else if (key >= 0 && key < n_texels) {
        store_row<VEC>(out + (size_t)key * c, c, acc);
      }
    } else if (valid && i == hi - 1) {  // the run goes on past the span
      float* slot = svals + (size_t)(2 * blockIdx.x) * c;
      if (from_left) {  // it covers the whole span: the sum, then the key with zeros
        skeys[2 * blockIdx.x] = key;
        store_row<VEC>(slot, c, acc);
        float zero[MAX_C];
#pragma unroll
        for (int k = 0; k < MAX_C; ++k) zero[k] = 0.0f;
        skeys[2 * blockIdx.x + 1] = key;
        store_row<VEC>(slot + c, c, zero);
      } else {
        skeys[2 * blockIdx.x + 1] = key;
        store_row<VEC>(slot + c, c, acc);
      }
    }
    if (valid && tid == chunk - 1) {  // what the next chunk continues
#pragma unroll
      for (int k = 0; k < MAX_C; ++k)
        if (k < c) ccarry[buf ^ 1][k] = last ? 0.0f : acc[k];
      cleft[buf ^ 1] = !last && from_left;
    }
  }
}

template <int VEC>
int launch(const int* keys, const float* vals, float* out, int n, int c, int n_texels, int span,
           int threads, int* skeys, float* svals, cudaStream_t stream) {
  const int n_spans = (int)(((long long)n + span - 1) / span);
  seg_sum_kernel<VEC><<<n_spans, threads, 0, stream>>>(keys, vals, out, n, c, n_texels, span,
                                                        n_spans > 1 ? skeys : nullptr, svals);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_spans == 1) return err;
  // the runs that crossed a span's edge: one block over the 2 * n_spans partial rows
  const int m = 2 * n_spans;
  seg_sum_kernel<VEC><<<1, m > 256 ? 1024 : 256, 0, stream>>>(skeys, svals, out, m, c, n_texels, m,
                                                             nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 on `stream`: keys [n] int32 sorted ascending, vals [n, c] f32
// row-major, out [n_texels, c] f32 zeroed by the caller.  `span` rows go to
// a block (a multiple of `threads`, the block's size); `vec` is 4, 2 or 1:
// the widest load that c and the alignment of vals, out and svals allow.
// skeys [2 * n_spans] int32 and svals [2 * n_spans, c] f32 are scratch for
// the runs that cross a span's edge (n_spans = ceil(n / span); unused when
// it is 1).  Returns the first launch error (0 = both launched).
int c2rt_texel_hist(const int* keys, const float* vals, float* out, int n, int c, int n_texels,
                    int span, int threads, int vec, int* skeys, float* svals, void* stream) {
  if (n <= 0 || n_texels <= 0) return 0;
  if (c <= 0 || c > MAX_C || threads < 32 || threads > 1024 || threads % 32 != 0 || span <= 0 ||
      span % threads != 0 || (vec != 1 && c % vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) return launch<4>(keys, vals, out, n, c, n_texels, span, threads, skeys, svals, s);
  if (vec == 2) return launch<2>(keys, vals, out, n, c, n_texels, span, threads, skeys, svals, s);
  if (vec == 1) return launch<1>(keys, vals, out, n, c, n_texels, span, threads, skeys, svals, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* c2rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
