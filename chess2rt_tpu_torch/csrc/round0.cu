// K1 for Hopper: the fused Whitted round-0 ray kernel, one thread per ray.
//
// Replaces the TPU kernel chess2rt_tpu/ops/pallas_trace.py
// build_round0_kernel (body `kernel`; its screen-tap and ray-input
// pallas_calls).  It computes what that kernel computes, lane for lane:
// pinhole ray-gen (screen-tap form; the lin-input form is the same ray-gen
// for the n pixels from the lane base in the parameter vector's lin slot,
// its pallas_call with lin_input=True) or caller rays (ray-input form), the
// closest hit over every node (plane / sphere / cube leaves, offset and
// full-matrix transforms with the dist rescaling, CSG union / inter / diff
// as fixed-capacity all-hits lists sorted by the same compare-exchange
// network and walked by parity), faceforward, the winning node's material
// with in-kernel checker and procedure2, spherical UVs through the same
// polynomial atan2 / asin, a dist-only shadow scan per light, Lambert and
// Phong direct light plus ambient, and the reflection / refraction
// continuation with TIR.  Bitmap texels stay deferred: the kernel emits
// (win, u, v) and the light sum, and ops/shade.py gathers the texels.
//
// The residual forms (the JAX kernel's want_hit / want_vis outputs, which
// the gradient's backward pins its discrete decisions to) are the same
// kernel with two more program flags: F_HIT adds the winning hit's t and
// raw normal and the in-kernel diffuse color, F_VIS one 0/1 shadow bit per
// light.  The flags are warp-uniform; a call without them writes no
// residual row.
//
// Design.  The TPU kernel was generated per scene structure (Python
// unrolled the node loops into the Mosaic program).  Here ONE compiled
// kernel reads the structure from the int32 scene program that
// ops/round0.py scene_program() writes: per node its transform kind, the
// geometry expression in postfix (leaf kind + parameter offset, CSG op +
// the right operand's instruction range + its compare-exchange pairs), its
// shader and texture kinds.  Every lane walks the same program, so the
// branches are warp-uniform and nothing is built per scene.  Parameters are
// the flat f32 vector of ops/round0.py make_packer(), read through __ldg
// (every lane reads the same word: a broadcast).
//
// What bounds it on this card: not DRAM bytes (a lane reads 24 bytes of
// ray and writes at most 60 bytes) but per-thread registers and the local
// memory that the CSG hit lists spill to: a list of MAX_HITS records is
// indexed by the program's compare-exchange pairs at run time, so it lives
// in local memory (L1-backed), and the long per-ray program keeps many
// values live.  The design keeps the spill small: records are six floats
// (position is recomputed from t), the "which operand" flags are one bit
// mask in a register, the inside tests of the CSG diff flip evaluate on a
// one-word bit stack, and the shadow scan breaks at the first occluder.
// Tuning (register caps, splitting the scan from the shading, a warp-level
// work queue for the bounce rounds) is later work.
//
// The stage probes (K3).  demos/kernel_probe.py build_stage traced four cut
// copies of the TPU kernel (empty, raygen, scan, shadow) to find where a
// tap's time goes.  Here the cut is made at compile time: -DC2RT_STAGE=k
// compiles this same device code with an early return after stage k, each
// stage writing the probe's two f32 rows, so the compiler drops what the
// stage does not reach and its registers, stack and time are the stage's
// own.  Without the define (stage 0) this file is K1.
//
// Arithmetic follows the JAX kernel's op order; no --use_fast_math (it
// changes division, sqrt and sin and moves knife-edge winners).  min/max
// propagate NaN like jnp.minimum / torch.minimum.

#include <cuda_runtime.h>

#ifndef C2RT_STAGE
#define C2RT_STAGE 0
#endif

namespace {

// stage cuts (ops/round0_probe.py STAGES); 0 is the whole kernel
enum { STAGE_FULL = 0, STAGE_EMPTY = 1, STAGE_RAYGEN = 2, STAGE_SCAN = 3, STAGE_SHADOW = 4 };
constexpr int STAGE = C2RT_STAGE;
static_assert(STAGE >= STAGE_FULL && STAGE <= STAGE_SHADOW, "C2RT_STAGE must be 0..4");

constexpr int MAX_HITS = 16;  // ops/round0.py MAX_HITS
constexpr float INF = 1e30f;
constexpr float EPS_SHADOW = 1e-3f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float HALF_PI_F = 1.57079632679489661923f;
constexpr float QUARTER_PI_F = 0.78539816339744830962f;

// scene program layout (ops/round0.py: H_*, NODE_STRIDE, INSTR_STRIDE)
constexpr int PROGRAM_VERSION = 3;
enum {
  H_VERSION, H_NODES, H_LIGHTS, H_CAM, H_AMBIENT, H_AA, H_LIN, H_FLAGS,
  H_LIGHT_TAB, H_NODE_TAB, H_INSTR_TAB, H_PAIR_TAB
};
constexpr int NODE_STRIDE = 10;
constexpr int INSTR_STRIDE = 8;
enum { F_PHONG = 1, F_REFR = 2, F_EMIT_L = 4, F_CONT = 8, F_HIT = 16, F_VIS = 32, F_UV = 64 };
enum { X_IDENT = 0, X_OFFSET = 1, X_MATRIX = 2 };
enum { OP_PLANE = 0, OP_SPHERE = 1, OP_CUBE = 2, OP_CSG = 3 };
enum { CSG_UNION = 0, CSG_INTER = 1, CSG_DIFF = 2 };
// node record fields
enum { N_XKIND, N_XOFF, N_MAT, N_SHADER, N_TEX, N_TEXOFF, N_UV, N_START, N_COUNT, N_HITS };
// shader and texture kinds (models/packed.py)
enum { LAMBERT = 0, PHONG = 1, REFLECTION = 2, REFRACTION = 3 };
enum { TEX_NONE = 0, TEX_CHECKER = 1, TEX_PROC2 = 2, TEX_BITMAP = 3 };

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// A hit record: distance, normal, UV (position is recomputed from t).
struct Rec {
  float t, nx, ny, nz, u, v;
};

__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(jmax(x, 1e-30f)); }

struct Scene {
  const float* __restrict__ prm;
  const int* __restrict__ prog;
  __device__ __forceinline__ float p(int k) const { return __ldg(prm + k); }
  __device__ __forceinline__ const int* node(int i) const {
    return prog + __ldg(prog + H_NODE_TAB) + NODE_STRIDE * i;
  }
  __device__ __forceinline__ const int* instr(int k) const {
    return prog + __ldg(prog + H_INSTR_TAB) + INSTR_STRIDE * k;
  }
  __device__ __forceinline__ int pair(int k, int side) const {
    return __ldg(prog + __ldg(prog + H_PAIR_TAB) + 2 * k + side);
  }
};

// ---- polynomial atan2 / asin (pallas_trace.atan2_poly / asin_poly) -------

__device__ __forceinline__ float atan01(float t) {
  const float AT0 = -3.33329491539e-1f, AT1 = 1.99777106478e-1f;
  const float AT2 = -1.38776856032e-1f, AT3 = 8.05374449538e-2f;
  const bool red = t > 0.4142135623730951f;
  const float tr = red ? (t - 1.0f) / (t + 1.0f) : t;
  const float z = tr * tr;
  const float p = tr + tr * z * (((AT3 * z + AT2) * z + AT1) * z + AT0);
  return red ? QUARTER_PI_F + p : p;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = jmax(ax, ay), lo = jmin(ax, ay);
  float a = atan01(lo / jmax(hi, 1e-30f));
  a = ay > ax ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float asin_poly(float x) {
  x = jmin(jmax(x, -1.0f), 1.0f);
  return atan2_poly(x, sqrtf(jmax((1.0f - x) * (1.0f + x), 0.0f)));
}

// ---- leaves ---------------------------------------------------------------

__device__ Rec plane_closest(const Scene& s, int b, const Ray& r, bool uv) {
  const float y0 = s.p(b), limit = s.p(b + 1);
  const bool miss = (r.oy > y0 && r.dy > -1e-9f) || (r.oy < y0 && r.dy < 1e-9f);
  const bool nonzero = r.dy != 0.0f;
  const float inv = nonzero ? -1.0f / r.dy : 0.0f;
  const float t = (r.oy - y0) * inv;
  const float px = r.ox + r.dx * t;
  const float pz = r.oz + r.dz * t;
  const bool ok = !miss && nonzero && fabsf(px) <= limit && fabsf(pz) <= limit;
  Rec h;
  h.t = ok ? t : INF;
  h.nx = 0.0f;
  h.ny = 1.0f;
  h.nz = 0.0f;
  h.u = uv ? px : 0.0f;
  h.v = uv ? pz : 0.0f;
  return h;
}

__device__ __forceinline__ bool sphere_roots(const Scene& s, int b, const Ray& r, float& x1,
                                             float& x2) {
  const float cx = s.p(b), cy = s.p(b + 1), cz = s.p(b + 2), rad = s.p(b + 3);
  const float hx = r.ox - cx, hy = r.oy - cy, hz = r.oz - cz;
  const float A = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float B = 2.0f * (hx * r.dx + hy * r.dy + hz * r.dz);
  const float C = hx * hx + hy * hy + hz * hz - rad * rad;
  const float D = B * B - 4.0f * A * C;
  const bool has = D >= 0.0f;
  const float sq = sqrtf(has ? D : 0.0f);
  const float inv2a = 1.0f / (2.0f * A);
  x1 = (-B + sq) * inv2a;
  x2 = (-B - sq) * inv2a;  // x2 <= x1
  return has;
}

__device__ Rec sphere_record(const Scene& s, int b, const Ray& r, float t, bool ok, bool uv) {
  const float cx = s.p(b), cy = s.p(b + 1), cz = s.p(b + 2), rad = s.p(b + 3);
  const float ts = ok ? t : 0.0f;
  const float rx = r.ox + r.dx * ts - cx;
  const float ry = r.oy + r.dy * ts - cy;
  const float rz = r.oz + r.dz * ts - cz;
  const float inv = rsq(rx * rx + ry * ry + rz * rz);
  Rec h;
  h.t = ok ? t : INF;
  h.nx = rx * inv;
  h.ny = ry * inv;
  h.nz = rz * inv;
  if (uv) {  // spherical UVs (geometry.d:110-117)
    h.u = (PI_F + atan2_poly(rz, rx)) / TWO_PI_F;
    h.v = 1.0f - (HALF_PI_F + asin_poly(ry / rad)) / PI_F;
  } else {
    h.u = h.v = 0.0f;
  }
  return h;
}

__device__ Rec sphere_closest(const Scene& s, int b, const Ray& r, bool uv) {
  float x1, x2;
  const bool has = sphere_roots(s, b, r, x1, x2);
  const float sol = x2 < 0.0f ? x1 : x2;  // nearer root unless behind
  return sphere_record(s, b, r, sol, has && sol >= 0.0f, uv);
}

// face f of the cube: (axis, sign, u axis, v axis), ops/geometry._CUBE_FACES
__device__ __forceinline__ Rec cube_face(const Scene& s, int b, const Ray& r, int f, bool uv) {
  const int axis = f < 2 ? 1 : (f < 4 ? 0 : 2);
  const int ua = (f == 2 || f == 3) ? 1 : 0;
  const int va = f < 4 ? 2 : 1;
  const float sgn = (f & 1) ? 1.0f : -1.0f;
  const float c3[3] = {s.p(b), s.p(b + 1), s.p(b + 2)};
  const float half = s.p(b + 3) * 0.5f;
  const float o3[3] = {r.ox, r.oy, r.oz};
  const float d3[3] = {r.dx, r.dy, r.dz};
  const float dk = d3[axis];
  const bool valid = fabsf(dk) >= 1e-9f;
  const float inv = valid ? -1.0f / dk : 0.0f;
  const float t = (o3[axis] - (c3[axis] + sgn * half)) * inv;
  float px[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) px[k] = o3[k] + d3[k] * t;
  const int oa = (axis + 1) % 3, ob = (axis + 2) % 3;
  const bool inside = px[oa] >= c3[oa] - half && px[oa] <= c3[oa] + half &&
                      px[ob] >= c3[ob] - half && px[ob] <= c3[ob] + half;
  const bool hit_ok = valid && t >= 0.0f && inside;
  Rec h;
  h.t = hit_ok ? t : INF;
  h.nx = axis == 0 ? sgn : 0.0f;
  h.ny = axis == 1 ? sgn : 0.0f;
  h.nz = axis == 2 ? sgn : 0.0f;
  h.u = uv ? px[ua] - c3[ua] : 0.0f;
  h.v = uv ? px[va] - c3[va] : 0.0f;
  return h;
}

// the (<= 2) valid face crossings, ascending, by the JAX kernel's running
// best/second pass; `best` alone is cube_closest
__device__ void cube_two_hits(const Scene& s, int b, const Ray& r, bool uv, Rec& best, Rec& second) {
  best = cube_face(s, b, r, 0, uv);
  second = cube_face(s, b, r, 1, uv);
  if (second.t < best.t) {
    const Rec tmp = best;
    best = second;
    second = tmp;
  }
#pragma unroll
  for (int f = 2; f < 6; ++f) {
    const Rec c = cube_face(s, b, r, f, uv);
    const bool bb = c.t < best.t;
    const bool bs = c.t < second.t;
    const Rec new_second = bb ? best : (bs ? c : second);
    if (bb) best = c;
    second = new_second;
  }
}

// slab-method (t_enter, t_exit) as sorted dists: the dist-only cube test
__device__ void cube_slab_dists(const Scene& s, int b, const Ray& r, float& lo, float& hi) {
  const float c3[3] = {s.p(b), s.p(b + 1), s.p(b + 2)};
  const float half = s.p(b + 3) * 0.5f;
  const float o3[3] = {r.ox, r.oy, r.oz};
  const float d3[3] = {r.dx, r.dy, r.dz};
  float t_enter = 0.0f, t_exit = 0.0f;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float dk = d3[axis], ok = o3[axis], ck = c3[axis];
    const bool valid = fabsf(dk) >= 1e-9f;
    const float inv = 1.0f / (valid ? dk : 1.0f);
    const float t1 = (ck - half - ok) * inv;
    const float t2 = (ck + half - ok) * inv;
    float tn = jmin(t1, t2), tf = jmax(t1, t2);
    const bool inside = ok >= ck - half && ok <= ck + half;
    tn = valid ? tn : (inside ? -INF : INF);
    tf = valid ? tf : (inside ? INF : -INF);
    t_enter = axis == 0 ? tn : jmax(t_enter, tn);
    t_exit = axis == 0 ? tf : jmin(t_exit, tf);
  }
  const bool hit = t_enter <= t_exit && t_exit >= 0.0f;
  const float d1 = (hit && t_enter >= 0.0f) ? t_enter : INF;
  const float d2 = hit ? t_exit : INF;
  lo = jmin(d1, d2);
  hi = jmax(d1, d2);
}

__device__ __forceinline__ bool bool_op(int op, bool l, bool r) {
  if (op == CSG_UNION) return l || r;
  if (op == CSG_INTER) return l && r;
  return l && !r;  // diff
}

// is_inside of the postfix range [a, b) (one whole subexpression), on a
// one-word bit stack
__device__ bool is_inside(const Scene& s, int a, int b, float px, float py, float pz) {
  unsigned stk = 0u;
  int sp = 0;
  for (int k = a; k < b; ++k) {
    const int* ins = s.instr(k);
    const int op = __ldg(ins);
    bool in;
    if (op == OP_CSG) {
      const bool r = (stk >> (sp - 1)) & 1u;
      const bool l = (stk >> (sp - 2)) & 1u;
      sp -= 2;
      in = bool_op(__ldg(ins + 1), l, r);
    } else if (op == OP_SPHERE) {
      const int g = __ldg(ins + 1);
      const float rx = s.p(g) - px, ry = s.p(g + 1) - py, rz = s.p(g + 2) - pz;
      in = rx * rx + ry * ry + rz * rz < s.p(g + 3) * s.p(g + 3);
    } else if (op == OP_CUBE) {
      const int g = __ldg(ins + 1);
      const float h = s.p(g + 3) * 0.5f;
      in = fabsf(px - s.p(g)) <= h && fabsf(py - s.p(g + 1)) <= h && fabsf(pz - s.p(g + 2)) <= h;
    } else {
      in = false;  // plane
    }
    stk = (stk & ~(1u << sp)) | ((unsigned)in << sp);
    ++sp;
  }
  return (stk >> (sp - 1)) & 1u;
}

// odd number of valid hits in st[a, a+n): the CSG operand started inside
__device__ __forceinline__ bool odd_valid(const float* t, int a, int n) {
  int c = 0;
  for (int m = 0; m < n; ++m) c += t[a + m] < INF;
  return (c & 1) != 0;
}

// ---- all-hits lists + CSG parity walk (pallas_trace all_hits) -------------

// Evaluates node expression instructions [start, start+count) into st[]
// (the whole expression's hit list, in the JAX kernel's order).
__device__ void all_hits(const Scene& s, int start, int count, const Ray& r, bool uv,
                         Rec* st) {
  int sp = 0;
  unsigned side = 0u;  // bit m: slot m came from a CSG's right operand
  for (int k = start; k < start + count; ++k) {
    const int* ins = s.instr(k);
    const int op = __ldg(ins);
    if (op == OP_PLANE) {
      st[sp++] = plane_closest(s, __ldg(ins + 1), r, uv);
    } else if (op == OP_SPHERE) {
      const int g = __ldg(ins + 1);
      float x1, x2;
      const bool has = sphere_roots(s, g, r, x1, x2);
      st[sp++] = sphere_record(s, g, r, x2, has && x2 >= 0.0f, uv);
      st[sp++] = sphere_record(s, g, r, x1, has && x1 >= 0.0f, uv);
    } else if (op == OP_CUBE) {
      cube_two_hits(s, __ldg(ins + 1), r, uv, st[sp], st[sp + 1]);
      sp += 2;
    } else {
      const int csg = __ldg(ins + 1), r_start = __ldg(ins + 2), r_end = __ldg(ins + 3);
      const int pair0 = __ldg(ins + 4), n_pairs = __ldg(ins + 5);
      const int n_l = __ldg(ins + 6), n_r = __ldg(ins + 7);
      const int base = sp - n_l - n_r;
      // initial parity: odd hit count => started inside (geometry.d:307-309)
      int c_l = 0, c_r = 0;
      for (int m = 0; m < n_l; ++m) c_l += st[base + m].t < INF;
      for (int m = 0; m < n_r; ++m) c_r += st[base + n_l + m].t < INF;
      bool in_l = c_l & 1, in_r = c_r & 1;
      const unsigned span = ((1u << (n_l + n_r)) - 1u) << base;
      side = (side & ~span) | ((((1u << n_r) - 1u) << n_l) << base);
      for (int q = pair0; q < pair0 + n_pairs; ++q) {
        const int i = base + s.pair(q, 0), j = base + s.pair(q, 1);
        if (st[i].t > st[j].t) {
          const Rec tmp = st[i];
          st[i] = st[j];
          st[j] = tmp;
          const unsigned bi = (side >> i) & 1u, bj = (side >> j) & 1u;
          side = (side & ~((1u << i) | (1u << j))) | (bj << i) | (bi << j);
        }
      }
      for (int m = base; m < sp; ++m) {
        Rec& h = st[m];
        const bool valid = h.t < INF;
        const bool from_right = (side >> m) & 1u;
        in_l = in_l ^ (!from_right && valid);
        in_r = in_r ^ (from_right && valid);
        const bool state = bool_op(csg, in_l, in_r) && valid;
        if (csg == CSG_DIFF && state) {
          // CsgDiff normal flip (geometry.d:377-397), probe step 1e-3
          const float hx = r.ox + r.dx * h.t, hy = r.oy + r.dy * h.t, hz = r.oz + r.dz * h.t;
          const bool before = is_inside(s, r_start, r_end, hx - r.dx * 1e-3f, hy - r.dy * 1e-3f,
                                        hz - r.dz * 1e-3f);
          const bool after = is_inside(s, r_start, r_end, hx + r.dx * 1e-3f, hy + r.dy * 1e-3f,
                                       hz + r.dz * 1e-3f);
          if (before != after) {
            h.nx = -h.nx;
            h.ny = -h.ny;
            h.nz = -h.nz;
          }
        }
        if (!state) h.t = INF;
      }
    }
  }
}

// closest hit of one node's expression, untransformed
__device__ Rec expr_closest(const Scene& s, const int* nd, const Ray& r, bool uv) {
  const int start = __ldg(nd + N_START), count = __ldg(nd + N_COUNT);
  if (count == 1) {
    const int* ins = s.instr(start);
    const int op = __ldg(ins), g = __ldg(ins + 1);
    if (op == OP_PLANE) return plane_closest(s, g, r, uv);
    if (op == OP_SPHERE) return sphere_closest(s, g, r, uv);
    Rec best, second;
    cube_two_hits(s, g, r, uv, best, second);
    return best;
  }
  Rec st[MAX_HITS];
  all_hits(s, start, count, r, uv, st);
  const int nh = __ldg(nd + N_HITS);
  Rec best = st[0];
  for (int m = 1; m < nh; ++m)
    if (st[m].t < best.t) best = st[m];
  return best;
}

// ---- dist-only variants for the shadow scans ------------------------------

__device__ float expr_min_dist(const Scene& s, const int* nd, const Ray& r) {
  const int start = __ldg(nd + N_START), count = __ldg(nd + N_COUNT);
  if (count == 1) {
    const int* ins = s.instr(start);
    const int op = __ldg(ins), g = __ldg(ins + 1);
    if (op == OP_PLANE) return plane_closest(s, g, r, false).t;
    if (op == OP_SPHERE) {
      float x1, x2;
      const bool has = sphere_roots(s, g, r, x1, x2);
      const float sol = x2 < 0.0f ? x1 : x2;
      return (has && sol >= 0.0f) ? sol : INF;
    }
    float lo, hi;
    cube_slab_dists(s, g, r, lo, hi);
    return lo;
  }
  float st[MAX_HITS];
  int sp = 0;
  unsigned side = 0u;
  for (int k = start; k < start + count; ++k) {
    const int* ins = s.instr(k);
    const int op = __ldg(ins);
    if (op == OP_PLANE) {
      st[sp++] = plane_closest(s, __ldg(ins + 1), r, false).t;
    } else if (op == OP_SPHERE) {
      float x1, x2;
      const bool has = sphere_roots(s, __ldg(ins + 1), r, x1, x2);
      st[sp++] = (has && x2 >= 0.0f) ? x2 : INF;
      st[sp++] = (has && x1 >= 0.0f) ? x1 : INF;
    } else if (op == OP_CUBE) {
      cube_slab_dists(s, __ldg(ins + 1), r, st[sp], st[sp + 1]);
      sp += 2;
    } else {
      const int csg = __ldg(ins + 1);
      const int pair0 = __ldg(ins + 4), n_pairs = __ldg(ins + 5);
      const int n_l = __ldg(ins + 6), n_r = __ldg(ins + 7);
      const int base = sp - n_l - n_r;
      bool in_l = odd_valid(st, base, n_l), in_r = odd_valid(st, base + n_l, n_r);
      const unsigned span = ((1u << (n_l + n_r)) - 1u) << base;
      side = (side & ~span) | ((((1u << n_r) - 1u) << n_l) << base);
      for (int q = pair0; q < pair0 + n_pairs; ++q) {
        const int i = base + s.pair(q, 0), j = base + s.pair(q, 1);
        if (st[i] > st[j]) {
          const float tmp = st[i];
          st[i] = st[j];
          st[j] = tmp;
          const unsigned bi = (side >> i) & 1u, bj = (side >> j) & 1u;
          side = (side & ~((1u << i) | (1u << j))) | (bj << i) | (bi << j);
        }
      }
      for (int m = base; m < sp; ++m) {
        const bool valid = st[m] < INF;
        const bool from_right = (side >> m) & 1u;
        in_l = in_l ^ (!from_right && valid);
        in_r = in_r ^ (from_right && valid);
        if (!(bool_op(csg, in_l, in_r) && valid)) st[m] = INF;
      }
    }
  }
  const int nh = __ldg(nd + N_HITS);
  float best = st[0];
  for (int m = 1; m < nh; ++m) best = jmin(best, st[m]);
  return best;
}

// ---- nodes: transforms (node.d:23-68) --------------------------------------

// row vector times the 3x3 matrix M (imported_types.d:13-20)
__device__ __forceinline__ void mulr(const float* M, float a, float b, float c, float& x, float& y,
                                     float& z) {
  x = a * M[0] + b * M[3] + c * M[6];
  y = a * M[1] + b * M[4] + c * M[7];
  z = a * M[2] + b * M[5] + c * M[8];
}

__device__ Rec node_closest(const Scene& s, int i, const Ray& r) {
  const int* nd = s.node(i);
  const int xk = __ldg(nd + N_XKIND), xo = __ldg(nd + N_XOFF);
  const bool uv = __ldg(nd + N_UV) != 0;
  if (xk == X_IDENT) return expr_closest(s, nd, r, uv);
  if (xk == X_OFFSET) {
    const Ray lr = {r.ox - s.p(xo), r.oy - s.p(xo + 1), r.oz - s.p(xo + 2), r.dx, r.dy, r.dz};
    return expr_closest(s, nd, lr, uv);
  }
  float mi[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) mi[k] = s.p(xo + 9 + k);
  const float fx = s.p(xo + 18), fy = s.p(xo + 19), fz = s.p(xo + 20);
  Ray lr;
  mulr(mi, r.ox - fx, r.oy - fy, r.oz - fz, lr.ox, lr.oy, lr.oz);
  float cx, cy, cz;
  mulr(mi, r.dx, r.dy, r.dz, cx, cy, cz);
  const float dlen = sqrtf(jmax(cx * cx + cy * cy + cz * cz, 1e-30f));
  const float inv_dl = 1.0f / dlen;
  lr.dx = cx * inv_dl;
  lr.dy = cy * inv_dl;
  lr.dz = cz * inv_dl;
  const Rec h = expr_closest(s, nd, lr, uv);
  // world normal: row vector times mi^T
  const float wx = h.nx * mi[0] + h.ny * mi[1] + h.nz * mi[2];
  const float wy = h.nx * mi[3] + h.ny * mi[4] + h.nz * mi[5];
  const float wz = h.nx * mi[6] + h.ny * mi[7] + h.nz * mi[8];
  const float ninv = rsq(wx * wx + wy * wy + wz * wz);
  Rec out;
  out.t = h.t >= INF ? INF : h.t * inv_dl;
  out.nx = wx * ninv;
  out.ny = wy * ninv;
  out.nz = wz * ninv;
  out.u = h.u;
  out.v = h.v;
  return out;
}

__device__ float node_min_dist(const Scene& s, int i, const Ray& r) {
  const int* nd = s.node(i);
  const int xk = __ldg(nd + N_XKIND), xo = __ldg(nd + N_XOFF);
  if (xk == X_IDENT) return expr_min_dist(s, nd, r);
  if (xk == X_OFFSET) {
    const Ray lr = {r.ox - s.p(xo), r.oy - s.p(xo + 1), r.oz - s.p(xo + 2), r.dx, r.dy, r.dz};
    return expr_min_dist(s, nd, lr);
  }
  float mi[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) mi[k] = s.p(xo + 9 + k);
  const float fx = s.p(xo + 18), fy = s.p(xo + 19), fz = s.p(xo + 20);
  Ray lr;
  mulr(mi, r.ox - fx, r.oy - fy, r.oz - fz, lr.ox, lr.oy, lr.oz);
  float cx, cy, cz;
  mulr(mi, r.dx, r.dy, r.dz, cx, cy, cz);
  const float dlen = sqrtf(jmax(cx * cx + cy * cy + cz * cz, 1e-30f));
  const float inv_dl = 1.0f / dlen;
  lr.dx = cx * inv_dl;
  lr.dy = cy * inv_dl;
  lr.dz = cz * inv_dl;
  const float d = expr_min_dist(s, nd, lr);
  return d >= INF ? INF : d * inv_dl;
}

// ---- the kernel -------------------------------------------------------------

__global__ void __launch_bounds__(128) round0_kernel(const float* __restrict__ prm,
                                                     const int* __restrict__ prog,
                                                     const float* __restrict__ orig,
                                                     const float* __restrict__ dir,
                                                     float* __restrict__ out,
                                                     int* __restrict__ win_out, int n, int width,
                                                     int height) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Scene s{prm, prog};
  const int n_nodes = __ldg(prog + H_NODES);
  const int n_lights = __ldg(prog + H_LIGHTS);
  const int flags = __ldg(prog + H_FLAGS);

  if (STAGE == STAGE_EMPTY) {
    // the grid and store floor: the lane index times the aa offset
    const float v = (float)lane * s.p(__ldg(prog + H_AA));
    out[lane] = v;
    out[(size_t)n + lane] = v + 1.0f;
    return;
  }

  Ray r;
  if (orig != nullptr) {
    r.ox = orig[3 * lane];
    r.oy = orig[3 * lane + 1];
    r.oz = orig[3 * lane + 2];
    r.dx = dir[3 * lane];
    r.dy = dir[3 * lane + 1];
    r.dz = dir[3 * lane + 2];
  } else {
    // pinhole ray-gen on the pos-free corner deltas (camera.d:119-147);
    // the deltas are unscaled and divided by width/height here, as in
    // ops/camera.screen_rays
    const int lin = (int)s.p(__ldg(prog + H_LIN)) + lane;
    const int aa = __ldg(prog + H_AA), c = __ldg(prog + H_CAM);
    const float xpix = ((float)(lin % width) + s.p(aa)) / (float)width;
    const float ypix = ((float)(lin / width) + s.p(aa + 1)) / (float)height;
    float dx = s.p(c + 0) + s.p(c + 3) * xpix + s.p(c + 6) * ypix;
    float dy = s.p(c + 1) + s.p(c + 4) * xpix + s.p(c + 7) * ypix;
    float dz = s.p(c + 2) + s.p(c + 5) * xpix + s.p(c + 8) * ypix;
    const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    r.dx = dx * inv_len;
    r.dy = dy * inv_len;
    r.dz = dz * inv_len;
    r.ox = s.p(c + 9);
    r.oy = s.p(c + 10);
    r.oz = s.p(c + 11);
  }
  if (STAGE == STAGE_RAYGEN) {
    out[lane] = r.dx + r.dy;
    out[(size_t)n + lane] = r.dz + r.ox + r.oy + r.oz;
    return;
  }

  // closest hit over every node; ties go to the later node (renderer.d:336-338)
  Rec hit = {INF, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int win = -1;
  for (int i = 0; i < n_nodes; ++i) {
    const Rec cand = node_closest(s, i, r);
    if (i == 0) {
      hit = cand;
      win = cand.t < INF ? 0 : -1;
    } else if (cand.t <= hit.t) {
      if (cand.t < INF) win = i;
      hit = cand;
    }
  }
  if (STAGE == STAGE_SCAN) {
    out[lane] = hit.t;
    out[(size_t)n + lane] = (float)win + ((flags & F_UV) ? hit.u : hit.nx);
    return;
  }
  const bool hitmask = win >= 0;
  const float ts = hitmask ? hit.t : 0.0f;
  const float hpx = r.ox + r.dx * ts, hpy = r.oy + r.dy * ts, hpz = r.oz + r.dz * ts;

  // faceforward (imported_types.d:69-73)
  const float ndotd = r.dx * hit.nx + r.dy * hit.ny + r.dz * hit.nz;
  const float fsg = ndotd < 0.0f ? 1.0f : -1.0f;
  const float nx = hit.nx * fsg, ny = hit.ny * fsg, nz = hit.nz * fsg;

  if (STAGE == STAGE_SHADOW) {
    // the shadow scans alone: lights the hit point sees (missed lanes
    // shade from t = 0, as in the whole kernel), and the winning t
    const float px = hpx + nx * EPS_SHADOW, py = hpy + ny * EPS_SHADOW, pz = hpz + nz * EPS_SHADOW;
    const int tab = __ldg(prog + H_LIGHT_TAB);
    float acc = 0.0f;
    for (int li = 0; li < n_lights; ++li) {
      const int lbase = __ldg(prog + tab + li);
      const float tx2 = s.p(lbase) - px, ty2 = s.p(lbase + 1) - py, tz2 = s.p(lbase + 2) - pz;
      const float target = sqrtf(jmax(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30f));
      const float inv_t = 1.0f / target;
      const Ray sray = {px, py, pz, tx2 * inv_t, ty2 * inv_t, tz2 * inv_t};
      bool occ = false;
      for (int i = 0; i < n_nodes && !occ; ++i) occ = node_min_dist(s, i, sray) <= target;
      acc += occ ? 0.0f : 1.0f;
    }
    out[lane] = acc;
    out[(size_t)n + lane] = hit.t;
    return;
  }

  // the winning node's diffuse color and material
  float dr = 0.0f, dg = 0.0f, db = 0.0f, exp_t = 1.0f, str_t = 0.0f;
  bool is_phong = false, is_direct = false;
  int shader = -1;
  if (hitmask) {
    const int* nd = s.node(win);
    const int bm = __ldg(nd + N_MAT), tex = __ldg(nd + N_TEX), bt = __ldg(nd + N_TEXOFF);
    shader = __ldg(nd + N_SHADER);
    if (tex == TEX_CHECKER) {
      const float size = s.p(bt + 6);
      const int cxi = (int)floorf(hit.u / size);
      const int cyi = (int)floorf(hit.v / size);
      const bool white = (((unsigned)cxi + (unsigned)cyi) & 1u) != 0u;
      dr = white ? s.p(bt + 3) : s.p(bt + 0);
      dg = white ? s.p(bt + 4) : s.p(bt + 1);
      db = white ? s.p(bt + 5) : s.p(bt + 2);
    } else if (tex == TEX_PROC2) {
      for (int band = 0; band < 3; ++band) {
        const float su = sinf(hit.u * s.p(bt + 18 + band));
        const float sv = sinf(hit.v * s.p(bt + 21 + band));
        dr += s.p(bt + band * 3 + 0) * su + s.p(bt + 9 + band * 3 + 0) * sv;
        dg += s.p(bt + band * 3 + 1) * su + s.p(bt + 9 + band * 3 + 1) * sv;
        db += s.p(bt + band * 3 + 2) * su + s.p(bt + 9 + band * 3 + 2) * sv;
      }
    } else if (tex == TEX_NONE) {
      dr = s.p(bm + 0);
      dg = s.p(bm + 1);
      db = s.p(bm + 2);
    }  // TEX_BITMAP: deferred to ops/shade.bitmap_color
    exp_t = s.p(bm + 3);
    str_t = s.p(bm + 4);
    is_phong = shader == PHONG;
    is_direct = shader == LAMBERT || shader == PHONG;
  }

  // output rows: r, g, b, [lr lg lb u v], [rox..rdz], [t nx ny nz dr dg db],
  // [vis0..]: the order of ops/round0.py layout()
  const int cont_row = 3 + ((flags & F_EMIT_L) ? 5 : 0);
  const int hit_row = cont_row + ((flags & F_CONT) ? 6 : 0);
  const int vis_row = hit_row + ((flags & F_HIT) ? 7 : 0);

  // direct light with in-kernel shadow scans
  const int amb = __ldg(prog + H_AMBIENT);
  float lr = s.p(amb), lg = s.p(amb + 1), lb = s.p(amb + 2);
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  const float sx = hpx + nx * EPS_SHADOW, sy = hpy + ny * EPS_SHADOW, sz = hpz + nz * EPS_SHADOW;
  const int light_tab = __ldg(prog + H_LIGHT_TAB);
  for (int li = 0; li < n_lights; ++li) {
    const int lbase = __ldg(prog + light_tab + li);
    const float lx = s.p(lbase), ly = s.p(lbase + 1), lz = s.p(lbase + 2);
    const float tlx = lx - hpx, tly = ly - hpy, tlz = lz - hpz;
    const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
    const float inv_l = rsq(dist2);
    const float ldx = tlx * inv_l, ldy = tly * inv_l, ldz = tlz * inv_l;
    // shadow scan (scene.d:62-78): any node with dist <= |to - from|
    const float tx2 = lx - sx, ty2 = ly - sy, tz2 = lz - sz;
    const float target = sqrtf(jmax(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30f));
    const float inv_t = 1.0f / target;
    const Ray sray = {sx, sy, sz, tx2 * inv_t, ty2 * inv_t, tz2 * inv_t};
    bool occ = false;
    for (int i = 0; i < n_nodes && !occ; ++i) occ = node_min_dist(s, i, sray) <= target;
    const bool vis = !occ;
    if (flags & F_VIS) out[(size_t)(vis_row + li) * n + lane] = vis ? 1.0f : 0.0f;
    const float cos_t = ldx * nx + ldy * ny + ldz * nz;
    const float w = (vis && cos_t > 0.0f) ? cos_t / dist2 : 0.0f;
    lr += s.p(lbase + 3) * w;
    lg += s.p(lbase + 4) * w;
    lb += s.p(lbase + 5) * w;
    if (flags & F_PHONG) {
      // R = reflect(-lightDir, N); cosGamma = R . -d (shader.d:226-249)
      const float mdotn = (-ldx) * nx + (-ldy) * ny + (-ldz) * nz;
      const float rx = -ldx - 2.0f * mdotn * nx;
      const float ry = -ldy - 2.0f * mdotn * ny;
      const float rz = -ldz - 2.0f * mdotn * nz;
      const float inv_r = rsq(rx * rx + ry * ry + rz * rz);
      const float cos_g = (rx * (-r.dx) + ry * (-r.dy) + rz * (-r.dz)) * inv_r;
      const float spec_w =
          (vis && cos_g > 0.0f) ? powf(jmax(cos_g, 0.0f), exp_t) * str_t / dist2 : 0.0f;
      sr += s.p(lbase + 3) * spec_w;
      sg += s.p(lbase + 4) * spec_w;
      sb += s.p(lbase + 5) * spec_w;
    }
  }

  float outr = dr * lr, outg = dg * lg, outb = db * lb;
  if (is_phong) {
    outr += sr;
    outg += sg;
    outb += sb;
  }
  const bool shaded = hitmask && is_direct;
  out[0 * (size_t)n + lane] = shaded ? outr : 0.0f;
  out[1 * (size_t)n + lane] = shaded ? outg : 0.0f;
  out[2 * (size_t)n + lane] = shaded ? outb : 0.0f;
  win_out[lane] = win;
  if (flags & F_EMIT_L) {
    out[(size_t)3 * n + lane] = shaded ? lr : 0.0f;
    out[(size_t)4 * n + lane] = shaded ? lg : 0.0f;
    out[(size_t)5 * n + lane] = shaded ? lb : 0.0f;
    out[(size_t)6 * n + lane] = hit.u;
    out[(size_t)7 * n + lane] = hit.v;
  }
  if (flags & F_HIT) {
    out[(size_t)(hit_row + 0) * n + lane] = hit.t;
    out[(size_t)(hit_row + 1) * n + lane] = hit.nx;
    out[(size_t)(hit_row + 2) * n + lane] = hit.ny;
    out[(size_t)(hit_row + 3) * n + lane] = hit.nz;
    out[(size_t)(hit_row + 4) * n + lane] = dr;
    out[(size_t)(hit_row + 5) * n + lane] = dg;
    out[(size_t)(hit_row + 6) * n + lane] = db;
  }
  if (flags & F_CONT) {
    // mirror continuation (render/pipeline._whitted_round)
    const float ddn = r.dx * nx + r.dy * ny + r.dz * nz;
    const float rdx = r.dx - 2.0f * ddn * nx;
    const float rdy = r.dy - 2.0f * ddn * ny;
    const float rdz = r.dz - 2.0f * ddn * nz;
    const float rinv = rsq(rdx * rdx + rdy * rdy + rdz * rdz);
    float cdx = rdx * rinv, cdy = rdy * rinv, cdz = rdz * rinv;
    float cox = sx, coy = sy, coz = sz;
    if ((flags & F_REFR) && shader == REFRACTION) {
      // single-sided refraction with TIR fallback, on the RAW
      // (pre-faceforward) normal like _whitted_round
      const float ior = s.p(__ldg(s.node(win) + N_MAT) + 5);
      const float cos_in = -(r.dx * hit.nx + r.dy * hit.ny + r.dz * hit.nz);
      const bool entering = cos_in > 0.0f;
      const float eta = entering ? 1.0f / ior : ior;
      const float fs = entering ? 1.0f : -1.0f;
      const float nfx = hit.nx * fs, nfy = hit.ny * fs, nfz = hit.nz * fs;
      const float ci = fabsf(cos_in);
      const float kk = 1.0f - eta * eta * (1.0f - ci * ci);
      const bool tir = kk < 0.0f;
      if (tir) {
        cox = hpx + nfx * EPS_SHADOW;
        coy = hpy + nfy * EPS_SHADOW;
        coz = hpz + nfz * EPS_SHADOW;
      } else {
        const float coef = eta * ci - sqrtf(jmax(kk, 0.0f));
        const float fx = eta * r.dx + coef * nfx;
        const float fy = eta * r.dy + coef * nfy;
        const float fz = eta * r.dz + coef * nfz;
        const float finv = rsq(fx * fx + fy * fy + fz * fz);
        cdx = fx * finv;
        cdy = fy * finv;
        cdz = fz * finv;
        cox = hpx - nfx * EPS_SHADOW;
        coy = hpy - nfy * EPS_SHADOW;
        coz = hpz - nfz * EPS_SHADOW;
      }
    }
    out[(size_t)(cont_row + 0) * n + lane] = cox;
    out[(size_t)(cont_row + 1) * n + lane] = coy;
    out[(size_t)(cont_row + 2) * n + lane] = coz;
    out[(size_t)(cont_row + 3) * n + lane] = cdx;
    out[(size_t)(cont_row + 4) * n + lane] = cdy;
    out[(size_t)(cont_row + 5) * n + lane] = cdz;
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` for n lanes.  `orig`/`dir` ([n, 3] f32) select
// the ray-input form; both null select in-kernel ray-gen for the n pixels
// from the lane base in prm's lin slot (the screen-tap form: base 0, n =
// width * height; the lin-input form: any slice).  `out` is [K, n] f32
// with K the layout's float outputs (the program's flags say which,
// residual rows included), `win` [n] int32.  A stage build (C2RT_STAGE
// 1..4) writes two rows into `out` and leaves `win` alone.  Returns
// cudaGetLastError() after the launch (0 = launched).
int c2rt_round0(const float* prm, const int* prog, const float* orig, const float* dir,
                float* out, int* win, int n, int width, int height, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  round0_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(prm, prog, orig, dir, out,
                                                                       win, n, width, height);
  return static_cast<int>(cudaGetLastError());
}

int c2rt_program_version() { return PROGRAM_VERSION; }

int c2rt_stage() { return STAGE; }

const char* c2rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
