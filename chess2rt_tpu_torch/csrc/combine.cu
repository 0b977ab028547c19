// combine_outputs after K1, fused (ops/flagship.py): the deferred bitmap
// texels and the environment cubemap planned, fetched, blended into the
// direct colour, and the bounce state emitted, in one launch.
//
// Replaces no Pallas kernel: it is the torch glue after every K1 call of
// the Whitted and Monte-Carlo renderers (ops/flagship.py combine_reference,
// its plain version, with ops/shade.bitmap_plan and ops/env.cubemap_plan),
// which the JAX package computes with XLA (chess2rt_tpu/ops/pallas_trace.py
// combine_outputs).  One thread per lane.  Per lane, in the glue's order:
//
//   winc   = max(win, 0); the node's constants by static_select (node 0
//            past the table), its bitmap_scaling and mat_color by the
//            one-hot product (0 past the table)
//   bitmap = scaling, wrap, floor and clamp of (u, v) -> texel (ix, iy)
//            and fractions (p, q); the key base + iy * w + ix
//   sky    = the cubemap's face, (s, t), texel (x0, y0) and (p, q); a NaN
//            texel pinned to 0
//   fetch  = the key clamped to the table (bitmap rows, then the sky's),
//            its 2x2 texels read from the padded atlas with wrap-around
//            neighbours, or from the cubemap with neighbours clamped at the
//            face's edge: the quad tables' rows, never built
//   colour = bitmap and sky: rgb + bilerp * (bitmap hit ? L : 0) + (miss ? 1 : 0);
//            bitmap alone: rgb + (bitmap hit ? bilerp * L : 0);
//            sky alone: rgb + (miss ? bilerp : 0)
//   cont   = hit on a Reflection or Refraction node; atten = cont ?
//            mat_color : 1; ro, rd copied from K1's rows
//
// The arithmetic is the glue's, op for op in float32: each torch op is its
// own kernel, so no product is fused into an add (built with -fmad=false,
// cuda_build.py); division is IEEE; the Python integers of the glue become
// float32 (w - 1, size - 1); 1 - p is torch's rsub, exact as a subtraction;
// torch.minimum, clamp and clamp_min keep a NaN where CUDA's fminf and
// fmaxf drop it; nan_to_num pins it to 0 before the int32 cast.  Lanes
// whose weight is 0 run the same arithmetic, so a NaN or a -0.0 reaches
// the colour as in the glue.  The one-hot products read the winning row:
// the same bits for finite tables without negative zeros.
//
// What bounds it: memory.  A lane reads K1's 15 rows it uses and the
// direction (72 bytes) and writes 49 bytes; the texels come from L2 (the
// atlas and the sky are a few MB).  The per-node words and the bitmaps'
// sizes are a small table on the device, made once per scene
// (ops/flagship.py _combine_table): any number of nodes and bitmaps.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;
// a node word: bit 0 a Reflection or Refraction shader, bit 1 a bitmap
// texture, bits 2-31 its texture's row of the atlas
constexpr unsigned NODE_CONT = 1u;
constexpr unsigned NODE_BITMAP = 2u;
// flags: the parts the scene has
constexpr int F_BITMAP = 1;
constexpr int F_ENV = 2;
constexpr int F_REFL = 4;

// the scene's constants: sizes by value, the tables by device pointer
struct Scene {
  int n_nodes;
  int n_tex;
  int bitmap_rows;      // rows of the flat bitmap quad table: sum of h * w
  int hmax, wmax;       // the padded atlas [n_tex, hmax, wmax, 3]
  int env_size;         // S of the [6, S, S, 3] cubemap
  const unsigned* node;  // [n_nodes] node words
  const int* tex;        // [n_tex, 3]: h, w, the texture's first quad row
};

// a float row of n lanes, s floats apart
struct Row {
  const float* p;
  long long s;
};

struct In {
  const int* win;
  long long win_s;
  Row rgb[3], light[3], u, v, ro[3], rd[3], dir[3];
  const float* atlas;      // [n_tex, hmax, wmax, 3]
  const float* scaling;    // [n_nodes]
  const float* mat_color;  // [n_nodes, 3]
  const float* cubemap;    // [6, S, S, 3]
};

// [n, 3] f32 each, cont [n] bool
struct Out {
  float* color;
  unsigned char* cont;
  float* atten;
  float* ro;
  float* rd;
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
// torch.clamp_min(x, lo), torch.minimum(a, b) and torch.clamp(x, lo, hi) on
// the card: a NaN operand is the result
__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return is_nan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float minimum_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// nan_to_num(x, nan=0.0).to(torch.int32) of an in-range texel index
__device__ __forceinline__ int texel_index(float x) { return is_nan(x) ? 0 : static_cast<int>(x); }

__device__ __forceinline__ float at(const Row& r, long long i) { return r.p[i * r.s]; }

// ops/shade.bilerp_quad: t00 * (1 - p) * (1 - q) + t10 * p * (1 - q) +
// t01 * (1 - p) * q + t11 * p * q, left to right
__device__ __forceinline__ float bilerp(const float g[12], int k, float p, float q) {
  const float omp = 1.0f - p, omq = 1.0f - q;
  return (((g[k] * omp) * omq + (g[3 + k] * p) * omq) + (g[6 + k] * omp) * q) + (g[9 + k] * p) * q;
}

// the 2x2 texels of bitmap quad row k (ops/shade._quad_atlas_flat: the
// texture whose rows hold k, wrap-around neighbours)
__device__ void bitmap_quad(const Scene& sc, const float* atlas, int k, float g[12]) {
  int t = sc.n_tex - 1;
  while (t > 0 && k < sc.tex[3 * t + 2]) --t;
  const int h = sc.tex[3 * t], w = sc.tex[3 * t + 1];
  const int local = k - sc.tex[3 * t + 2];
  const int y = local / w, x = local - y * w;
  const int x1 = x + 1 == w ? 0 : x + 1, y1 = y + 1 == h ? 0 : y + 1;
  const long long img = (long long)t * sc.hmax;
  const long long taps[4] = {(img + y) * sc.wmax + x, (img + y) * sc.wmax + x1, (img + y1) * sc.wmax + x,
                             (img + y1) * sc.wmax + x1};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[3 * j + c] = atlas[3 * taps[j] + c];
  }
}

// the 2x2 texels of cubemap quad row k (ops/env.cubemap_quads: neighbours
// clamped at the face's edge)
__device__ void cube_quad(const float* cubemap, int size, int k, float g[12]) {
  const int face = k / (size * size), rem = k - face * size * size;
  const int y = rem / size, x = rem - y * size;
  const int x1 = x + 1 < size ? x + 1 : size - 1, y1 = y + 1 < size ? y + 1 : size - 1;
  const long long f = (long long)face * size;
  const long long taps[4] = {(f + y) * size + x, (f + y) * size + x1, (f + y1) * size + x, (f + y1) * size + x1};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g[3 * j + c] = cubemap[3 * taps[j] + c];
  }
}

struct Plan {
  int key;
  float p, q;
};

// ops/env.cubemap_plan of one direction
__device__ Plan cube_plan(float x, float y, float z, int size) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = (ay > ax) && (ay >= az);
  const int face = is_x ? (x > 0.0f ? 0 : 1) : (is_y ? (y > 0.0f ? 2 : 3) : (z > 0.0f ? 4 : 5));
  const float ma = is_x ? ax : (is_y ? ay : az);
  const float sc = is_x ? (x > 0.0f ? -z : z) : (is_y ? x : (z > 0.0f ? x : -x));
  const float tc = is_x ? -y : (is_y ? (y > 0.0f ? z : -z) : -y);
  const float s = (sc / ma + 1.0f) * 0.5f;
  const float t = (tc / ma + 1.0f) * 0.5f;
  const float last = static_cast<float>(size - 1);
  const float fx = s * last, fy = t * last;
  const int x0 = texel_index(clamp_nan(floorf(fx), 0.0f, last));
  const int y0 = texel_index(clamp_nan(floorf(fy), 0.0f, last));
  return {(face * size + y0) * size + x0, fx - static_cast<float>(x0), fy - static_cast<float>(y0)};
}

__global__ void __launch_bounds__(BLOCK) combine_kernel(const Scene sc, long long n, In in, Out out, int flags) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int win = in.win[i * in.win_s];
  const bool miss = win < 0;
  const int wc = miss ? 0 : win;
  const bool known = wc < sc.n_nodes;  // the one-hot row has its 1
  const unsigned node = sc.n_nodes > 0 ? sc.node[known ? wc : 0] : 0u;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = at(in.rgb[k], i);

  if (flags & F_BITMAP) {
    // ops/shade.bitmap_plan
    const int b = static_cast<int>(node >> 2);
    const int tw = sc.tex[3 * b + 1];
    const float h = static_cast<float>(sc.tex[3 * b]), w = static_cast<float>(tw);
    const float scaling = known ? in.scaling[wc] : 0.0f;
    float uu = at(in.u, i) * scaling, vv = at(in.v, i) * scaling;
    uu = uu - floorf(uu);
    vv = vv - floorf(vv);
    const float tx = uu * w, ty = vv * h;
    const float ix = minimum_nan(clamp_min_nan(floorf(tx), 0.0f), w - 1.0f);
    const float iy = minimum_nan(clamp_min_nan(floorf(ty), 0.0f), h - 1.0f);
    float p = tx - ix, q = ty - iy;
    int key = sc.tex[3 * b + 2] + texel_index(iy) * tw + texel_index(ix);
    const bool is_bmp = (node & NODE_BITMAP) && !miss;
    float L[3], g[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) L[k] = at(in.light[k], i);
    if (flags & F_ENV) {  // one table: the bitmap rows, then the sky's
      const Plan e = cube_plan(at(in.dir[0], i), at(in.dir[1], i), at(in.dir[2], i), sc.env_size);
      const int rows = sc.bitmap_rows + 6 * sc.env_size * sc.env_size;
      key = miss ? sc.bitmap_rows + e.key : key;
      key = key < 0 ? 0 : (key > rows - 1 ? rows - 1 : key);
      p = miss ? e.p : p;
      q = miss ? e.q : q;
      if (key < sc.bitmap_rows) {
        bitmap_quad(sc, in.atlas, key, g);
      } else {
        cube_quad(in.cubemap, sc.env_size, key - sc.bitmap_rows, g);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float w3 = (is_bmp ? L[k] : 0.0f) + (miss ? 1.0f : 0.0f);
        c[k] = c[k] + bilerp(g, k, p, q) * w3;
      }
    } else {
      key = key < 0 ? 0 : (key > sc.bitmap_rows - 1 ? sc.bitmap_rows - 1 : key);
      bitmap_quad(sc, in.atlas, key, g);
#pragma unroll
      for (int k = 0; k < 3; ++k) c[k] = c[k] + (is_bmp ? bilerp(g, k, p, q) * L[k] : 0.0f);
    }
  } else if (flags & F_ENV) {  // ops/env.sample_cubemap
    const Plan e = cube_plan(at(in.dir[0], i), at(in.dir[1], i), at(in.dir[2], i), sc.env_size);
    float g[12];
    cube_quad(in.cubemap, sc.env_size, e.key, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = c[k] + (miss ? bilerp(g, k, e.p, e.q) : 0.0f);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out.color[3 * i + k] = c[k];

  if (flags & F_REFL) {
    const bool cont = !miss && (node & NODE_CONT);
    out.cont[i] = cont;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out.atten[3 * i + k] = cont ? (known ? in.mat_color[3 * wc + k] : 0.0f) : 1.0f;
      out.ro[3 * i + k] = at(in.ro[k], i);
      out.rd[3 * i + k] = at(in.rd[k], i);
    }
  }
}

// c2rt_combine's arguments as the kernel's
void unpack(const unsigned* nodes, int n_nodes, const int* tex, int n_tex, const int* dims,
            const void* const* rows, const long long* strides, void* const* outs, Scene& sc, In& in, Out& out) {
  sc = Scene{n_nodes, n_tex, dims[0], dims[1], dims[2], dims[3], nodes, tex};
  const auto row = [&](int r) { return Row{static_cast<const float*>(rows[r]), strides[r]}; };
  const auto f = [&](int r) { return static_cast<const float*>(rows[r]); };
  in = In{static_cast<const int*>(rows[0]), strides[0],
          {row(1), row(2), row(3)}, {row(4), row(5), row(6)}, row(7), row(8),
          {row(9), row(10), row(11)}, {row(12), row(13), row(14)}, {row(15), row(16), row(17)},
          f(18), f(19), f(20), f(21)};
  out = Out{static_cast<float*>(outs[0]), static_cast<unsigned char*>(outs[1]), static_cast<float*>(outs[2]),
            static_cast<float*>(outs[3]), static_cast<float*>(outs[4])};
}

// ---- host side -------------------------------------------------------------

}  // namespace

extern "C" {

// combine_outputs over n lanes on `stream`.  nodes: n_nodes words and
// tex: n_tex triples (h, w, first row), both on the device; dims (host):
// bitmap_rows, hmax, wmax, env_size.  rows: 22 device pointers, win
// (int32), K1's rows r, g, b, lr, lg, lb, u, v, rox, roy, roz, rdx, rdy,
// rdz and the directions' three columns (float), strides: the 18 strides
// of those, in elements; then the atlas, bitmap_scaling, mat_color and the
// cubemap (contiguous).  A part the flags leave out may be null.  outs:
// colour, cont, atten, ro, rd (the last four null without F_REFL).
// flags: F_BITMAP, F_ENV, F_REFL.  Returns cudaGetLastError() after the
// launch (0 = launched; nothing to do when n == 0).
int c2rt_combine(const unsigned* nodes, int n_nodes, const int* tex, int n_tex, const int* dims, long long n,
                 const void* const* rows, const long long* strides, void* const* outs, int flags, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Scene sc;
  In in;
  Out out;
  unpack(nodes, n_nodes, tex, n_tex, dims, rows, strides, outs, sc, in, out);
  combine_kernel<<<(unsigned)blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(sc, n, in, out, flags);
  return static_cast<int>(cudaGetLastError());
}

const char* c2rt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
