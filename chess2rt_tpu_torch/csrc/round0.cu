// K1 for Hopper: the fused Whitted round-0 ray kernel, one thread per ray.
//
// Replaces the TPU kernel chess2rt_tpu/ops/pallas_trace.py
// build_round0_kernel (body `kernel`; its screen-tap, lin-input and
// ray-input pallas_calls).  It computes what that kernel computes, lane for
// lane: pinhole ray-gen (screen-tap form; the lin-input form is the same
// ray-gen for the n pixels from the lane base in the parameter vector's lin
// slot) or caller rays (ray-input form), the closest hit over every node
// (plane / sphere / cube leaves, offset and full-matrix transforms with the
// dist rescaling, CSG union / inter / diff as fixed-capacity all-hits lists
// sorted by the same compare-exchange network and walked by parity),
// faceforward, the winning node's material with in-kernel checker and
// procedure2, spherical UVs through the same polynomial atan2 / asin, a
// dist-only shadow scan per light, Lambert and Phong direct light plus
// ambient, and the reflection / refraction continuation with TIR.  Bitmap
// texels stay deferred: the kernel emits (win, u, v) and the light sum, and
// ops/shade.py gathers the texels.
//
// The residual forms (the JAX kernel's want_hit / want_vis outputs, which
// the gradient's backward pins its discrete decisions to) are the same
// kernel with two more program flags: F_HIT adds the winning hit's t and
// raw normal and the in-kernel diffuse color, F_VIS one 0/1 shadow bit per
// light.  The flags are warp-uniform; a call without them writes no
// residual row.
//
// One compiled kernel serves every scene.  The TPU kernel was generated per
// scene structure (Python unrolled the node loops into the Mosaic program);
// here the structure is data: the int32 scene program that ops/round0.py
// scene_program() writes (per node its transform kind, the geometry
// expression in postfix, each CSG merge's compare-exchange pairs, shader
// and texture kinds) beside the flat f32 parameter vector of make_packer().
// Every lane walks the same program, so its branches are warp-uniform.
//
// What bounds it on this card: neither DRAM bytes (a lane reads at most 24
// bytes of ray and writes at most 100) nor f32 arithmetic, but instruction
// throughput and latency: a few thousand dependent instructions per lane
// (IEEE division and square roots, the program decode, the CSG merges), at
// the occupancy its registers allow.  What the design does about it:
//
// * Scene tables on chip.  A block copies the program and the parameter
//   vector (a few KB, the same for every lane) into shared memory once, as
//   one array at a fixed address: a decode or a parameter read is one
//   broadcast shared-memory read at a word offset, with no pointer held in
//   registers, instead of dependent global loads.  The tables are dynamic
//   shared memory sized by the wrapper; a scene whose tables take more than
//   200 KB is refused.
// * Distances are scanned, one record is built.  The closest-hit scan
//   carries a distance and a small tag per node (which leaf, which root or
//   cube face, and the CSG merge that dropped the hit, if any); the hit
//   record (normal, UVs with their atan2 / asin, the CsgDiff normal flips
//   with their inside probes) is built ONCE per lane, for the hit that won
//   the scan, from the same expressions as the scan's.  The flips are
//   replayed from the tag: the program gives every leaf the set of CsgDiff
//   merges above it (a list in the program's diff table), and a hit is
//   flipped by those below the one that dropped it.  A lane that misses
//   everything keeps the last node's record, as a record-carrying scan
//   would.
// * CSG lists out of local memory.  A list slot is a distance and a 32-bit
//   tag.  A node that is one merge of two sphere or cube leaves (four hits;
//   both CSG nodes of the flagship scene) keeps its slots in registers and
//   runs the four-slot network unrolled.  Longer lists are laid out
//   [slot][thread] (conflict-free, and indexable at run time by the
//   network's pairs), with as many slots as the scene's longest list (the
//   program header's list capacity): in the block's dynamic shared memory
//   after the two tables when both fit in the 227 KB a block may have, else
//   in a per-lane scratch [2 * capacity, n] in global memory that the
//   wrapper allocates (ops/round0.py list_placement decides, from the
//   header).  No list length is refused below the tables' own limit.  The
//   shadow scans' dist-only lists take the same two paths.
// * Shadow scans only where the light sum is used.  Without F_VIS a lane
//   that missed the scene or won a mirror or glass node writes zeros to the
//   light rows whatever the scans say, so it skips them; such lanes are
//   screen-coherent, so whole warps skip.  With F_VIS every lane scans,
//   because the vis rows are defined on every lane.  The Phong highlight
//   (a powf per light) is computed on Phong winners only.
// * Few values live across the scans: the shading reads the material and
//   computes the light terms after each scan, and the diffuse color after
//   the last, which with the fixed-address tables brings the kernel to 92
//   registers and five resident blocks of 128 threads per SM, without
//   spills.
// * One block per 128-lane tile.  A persistent grid (resident blocks x SMs,
//   each looping over tiles, so that the table copy is paid once) was
//   measured slower: tiles differ widely in cost (sky against CSG), and the
//   hardware's block scheduler balances them better than a fixed stride.
// * Tensor cores have no part: the body has no matrix product.
//
// Two compile-time switches besides the stage, for the host build only
// (tests/test_torch_kernel_host.py): -DC2RT_TABLES_SHARED=0 reads the
// tables through global memory and needs no barrier, which is how a host
// compiler can run this device code thread by thread; -DC2RT_STACK_WORD=k
// keeps only k levels of is_inside's bit stack in a register, so that a
// small scene reaches the levels kept in the lists.
//
// The stage probes (K3).  demos/kernel_probe.py build_stage traced four cut
// copies of the TPU kernel (empty, raygen, scan, shadow) to find where a
// tap's time goes.  Here the cut is made at compile time: -DC2RT_STAGE=k
// compiles this same device code with an early return after stage k, each
// stage writing the probe's two f32 rows, so the compiler drops what the
// stage does not reach and its registers, stack and time are the stage's
// own.  The shadow stage scans on every lane, as its plain version does.
// Without the define (stage 0) this file is K1.
//
// Arithmetic follows the JAX kernel's op order; no --use_fast_math (it
// changes division, sqrt and sin and moves knife-edge winners).  min/max
// propagate NaN like jnp.minimum / torch.minimum.

#include <cuda_runtime.h>

#ifndef C2RT_STAGE
#define C2RT_STAGE 0
#endif
#ifndef C2RT_TABLES_SHARED
#define C2RT_TABLES_SHARED 1
#endif
#ifndef C2RT_STACK_WORD
#define C2RT_STACK_WORD 32
#endif

namespace {

// stage cuts (ops/round0_probe.py STAGES); 0 is the whole kernel
enum { STAGE_FULL = 0, STAGE_EMPTY = 1, STAGE_RAYGEN = 2, STAGE_SCAN = 3, STAGE_SHADOW = 4 };
constexpr int STAGE = C2RT_STAGE;
constexpr int STACK_WORD = C2RT_STACK_WORD;
static_assert(STACK_WORD >= 1 && STACK_WORD <= 32, "C2RT_STACK_WORD must be 1..32");
static_assert(STAGE >= STAGE_FULL && STAGE <= STAGE_SHADOW, "C2RT_STAGE must be 0..4");

constexpr int BLOCK = 128;    // threads of a block: one 128-lane tile
constexpr int MIN_BLOCKS = 5;  // resident blocks per SM that the registers are fitted to
constexpr float INF = 1e30f;
constexpr float EPS_SHADOW = 1e-3f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float HALF_PI_F = 1.57079632679489661923f;
constexpr float QUARTER_PI_F = 0.78539816339744830962f;

// scene program layout (ops/round0.py: H_*, NODE_STRIDE, INSTR_STRIDE)
constexpr int PROGRAM_VERSION = 5;
enum {
  H_VERSION, H_NODES, H_LIGHTS, H_CAM, H_AMBIENT, H_AA, H_LIN, H_FLAGS,
  H_LIGHT_TAB, H_NODE_TAB, H_INSTR_TAB, H_PAIR_TAB, H_DIFF_TAB, H_LIST_CAP
};
constexpr int NODE_STRIDE = 10;
constexpr int INSTR_STRIDE = 8;
// (F_PHONG is part of the layout but not read here: the highlight is
// computed per lane, on Phong winners)
enum { F_PHONG = 1, F_REFR = 2, F_EMIT_L = 4, F_CONT = 8, F_HIT = 16, F_VIS = 32, F_UV = 64 };
enum { X_IDENT = 0, X_OFFSET = 1, X_MATRIX = 2 };
enum { OP_PLANE = 0, OP_SPHERE = 1, OP_CUBE = 2, OP_CSG = 3 };
enum { CSG_UNION = 0, CSG_INTER = 1, CSG_DIFF = 2 };
// node record fields
enum { N_XKIND, N_XOFF, N_MAT, N_SHADER, N_TEX, N_TEXOFF, N_UV, N_START, N_COUNT, N_HITS };
// instruction fields: a leaf is (op, parameter offset, where its list of
// the CsgDiff instructions above it starts in the diff table, that list's
// length; the list holds indices relative to the node's first instruction,
// ascending); a CSG merge is (op, csg op, the right operand's instruction
// range, its pairs' range, the operands' hit counts)
enum { I_OP, I_ARG, I_DIFFS, I_NDIFFS };
enum { C_OP, C_CSG, C_RSTART, C_REND, C_PAIR0, C_NPAIRS, C_NL, C_NR };
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
__device__ __forceinline__ float sel3(int a, float x, float y, float z) {
  return a == 0 ? x : (a == 1 ? y : z);
}

// The scene's two tables.  In shared memory they are one array at a fixed
// address, the program first and the parameters after it, so a read needs
// no pointer register: an instruction, a node record and a light are word
// offsets into it; the hit lists, when they are in shared memory, follow.
// (C2RT_TABLES_SHARED=0, the host build: the same offsets into the tables
// in global memory, through the read-only path, and `tables` is memory the
// host harness provides for one block's lists.)
#if C2RT_TABLES_SHARED
extern __shared__ int tables[];
#else
int* tables;
#endif
struct Scene {
#if C2RT_TABLES_SHARED
  int prm0;  // the program's length: where the parameters start
  __device__ __forceinline__ void bind(const float*, const int*, int n_prog) {
    prm0 = n_prog;
    bind_tables();
  }
  __device__ __forceinline__ int word(int k) const { return tables[k]; }
  __device__ __forceinline__ float p(int k) const { return __int_as_float(tables[prm0 + k]); }
#else
  const float* prm;
  const int* prog;
  __device__ __forceinline__ void bind(const float* prm_, const int* prog_, int) {
    prm = prm_;
    prog = prog_;
    bind_tables();
  }
  __device__ __forceinline__ int word(int k) const { return __ldg(prog + k); }
  __device__ __forceinline__ float p(int k) const { return __ldg(prm + k); }
#endif
  int nodes, instrs;  // the node and the instruction table, resolved once
  __device__ __forceinline__ void bind_tables() {
    nodes = word(H_NODE_TAB);
    instrs = word(H_INSTR_TAB);
  }
  __device__ __forceinline__ int head(int h) const { return word(h); }
  __device__ __forceinline__ int light(int li) const { return word(word(H_LIGHT_TAB) + li); }
  __device__ __forceinline__ int node(int i) const { return nodes + NODE_STRIDE * i; }
  __device__ __forceinline__ int instr(int k) const { return instrs + INSTR_STRIDE * k; }
  __device__ __forceinline__ int pair(int k, int side) const {
    return word(word(H_PAIR_TAB) + 2 * k + side);
  }
};

// One thread's hit list: per slot a distance and a 32-bit tag.
//   tag bits 0-12   the leaf's instruction, relative to the node's first
//       bits 13-15  which hit of the leaf: a sphere's root (0 near, 1 far),
//                   a cube's face
//       bits 16-28  the instruction (relative) that dropped the hit: the
//                   leaf itself when it missed, a CSG merge whose parity
//                   walk rejected it, or TAG_KEPT
//       bit 31      during a merge: the slot came from the right operand
// A node's instructions number fewer than TAG_KEPT: 8191 instructions alone
// take more than the tables' 200 KB (ops/round0.py MAX_TABLE_BYTES).
constexpr int TAG_BITS = 13;
constexpr unsigned TAG_FIELD = (1u << TAG_BITS) - 1u;
constexpr unsigned TAG_KEPT = TAG_FIELD;
constexpr unsigned TAG_SIDE = 1u << 31;
__device__ __forceinline__ unsigned make_tag(int leaf, int which, bool valid) {
  return (unsigned)leaf | ((unsigned)which << TAG_BITS) | ((valid ? TAG_KEPT : (unsigned)leaf) << 16);
}
// the tag of a hit that instruction `rel` dropped (the side bit cleared)
__device__ __forceinline__ unsigned drop_tag(unsigned g, int rel) { return (g & 0xffffu) | ((unsigned)rel << 16); }

// The lists, laid out [slot][thread] with a slot's tags after its
// distances: conflict-free, and indexable at run time.  In the block's
// shared memory after the tables (SharedLists, `at` = this thread's first
// word), or in the wrapper's global scratch [2 * capacity, n] (GlobalLists,
// `base` = this lane's first distance).
struct SharedLists {
  int at;
  __device__ __forceinline__ float& t(int m) { return reinterpret_cast<float*>(tables)[at + 2 * m * BLOCK]; }
  __device__ __forceinline__ unsigned& tag(int m) {
    return reinterpret_cast<unsigned*>(tables)[at + (2 * m + 1) * BLOCK];
  }
};
struct GlobalLists {
  float* base;
  size_t n;
  __device__ __forceinline__ float& t(int m) { return base[2 * (size_t)m * n]; }
  __device__ __forceinline__ unsigned& tag(int m) {
    return reinterpret_cast<unsigned*>(base)[(2 * (size_t)m + 1) * n];
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

__device__ __forceinline__ Rec plane_closest(const Scene& s, int b, const Ray& r, bool uv) {
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

__device__ __forceinline__ Rec sphere_record(const Scene& s, int b, const Ray& r, float t, bool ok,
                                             bool uv) {
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

// face f of the cube: (axis, sign, u axis, v axis), ops/geometry._CUBE_FACES;
// f may be a run-time value (the selects fold when it is a constant)
__device__ __forceinline__ Rec cube_face(const Scene& s, int b, const Ray& r, int f, bool uv) {
  const int axis = f < 2 ? 1 : (f < 4 ? 0 : 2);
  const int ua = (f == 2 || f == 3) ? 1 : 0;
  const int va = f < 4 ? 2 : 1;
  const float sgn = (f & 1) ? 1.0f : -1.0f;
  const float cx = s.p(b), cy = s.p(b + 1), cz = s.p(b + 2);
  const float half = s.p(b + 3) * 0.5f;
  const float dk = sel3(axis, r.dx, r.dy, r.dz);
  const bool valid = fabsf(dk) >= 1e-9f;
  const float inv = valid ? -1.0f / dk : 0.0f;
  const float t = (sel3(axis, r.ox, r.oy, r.oz) - (sel3(axis, cx, cy, cz) + sgn * half)) * inv;
  const float px = r.ox + r.dx * t, py = r.oy + r.dy * t, pz = r.oz + r.dz * t;
  const int oa = axis == 2 ? 0 : axis + 1, ob = axis == 0 ? 2 : axis - 1;
  const float pa = sel3(oa, px, py, pz), ca = sel3(oa, cx, cy, cz);
  const float pb = sel3(ob, px, py, pz), cb = sel3(ob, cx, cy, cz);
  const bool inside = pa >= ca - half && pa <= ca + half && pb >= cb - half && pb <= cb + half;
  const bool hit_ok = valid && t >= 0.0f && inside;
  Rec h;
  h.t = hit_ok ? t : INF;
  h.nx = axis == 0 ? sgn : 0.0f;
  h.ny = axis == 1 ? sgn : 0.0f;
  h.nz = axis == 2 ? sgn : 0.0f;
  h.u = uv ? sel3(ua, px, py, pz) - sel3(ua, cx, cy, cz) : 0.0f;
  h.v = uv ? sel3(va, px, py, pz) - sel3(va, cx, cy, cz) : 0.0f;
  return h;
}

// the (<= 2) valid face crossings, ascending, by the JAX kernel's running
// best/second pass, as distances and face numbers; the first alone is the
// cube's closest hit
__device__ __forceinline__ void cube_two_faces(const Scene& s, int b, const Ray& r, float& t1,
                                               int& f1, float& t2, int& f2) {
  t1 = cube_face(s, b, r, 0, false).t;
  f1 = 0;
  t2 = cube_face(s, b, r, 1, false).t;
  f2 = 1;
  if (t2 < t1) {
    const float tt = t1;
    t1 = t2;
    t2 = tt;
    f1 = 1;
    f2 = 0;
  }
#pragma unroll
  for (int f = 2; f < 6; ++f) {
    const float c = cube_face(s, b, r, f, false).t;
    const bool bb = c < t1;
    const bool bs = c < t2;
    t2 = bb ? t1 : (bs ? c : t2);
    f2 = bb ? f1 : (bs ? f : f2);
    if (bb) {
      t1 = c;
      f1 = f;
    }
  }
}

// slab-method (t_enter, t_exit) as sorted dists: the dist-only cube test
__device__ __forceinline__ void cube_slab_dists(const Scene& s, int b, const Ray& r, float& lo,
                                                float& hi) {
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

// is_inside of the postfix range [a, b) (one whole subexpression), on a bit
// stack: its first STACK_WORD (32) levels in one register word, deeper ones
// in the lane's list tags (free once the scan is done; the stack is never
// deeper than the subexpression's leaves, so than the list's capacity)
template <class L>
__device__ bool is_inside(const Scene& s, L& H, int a, int b, float px, float py, float pz) {
  unsigned stk = 0u;
  int sp = 0;
  auto get = [&](int i) -> bool { return i < STACK_WORD ? ((stk >> i) & 1u) != 0u : H.tag(i) != 0u; };
  for (int k = a; k < b; ++k) {
    const int ins = s.instr(k);
    const int op = s.word(ins + I_OP);
    bool in;
    if (op == OP_CSG) {
      const bool r = get(sp - 1);
      const bool l = get(sp - 2);
      sp -= 2;
      in = bool_op(s.word(ins + C_CSG), l, r);
    } else if (op == OP_SPHERE) {
      const int g = s.word(ins + I_ARG);
      const float rx = s.p(g) - px, ry = s.p(g + 1) - py, rz = s.p(g + 2) - pz;
      in = rx * rx + ry * ry + rz * rz < s.p(g + 3) * s.p(g + 3);
    } else if (op == OP_CUBE) {
      const int g = s.word(ins + I_ARG);
      const float h = s.p(g + 3) * 0.5f;
      in = fabsf(px - s.p(g)) <= h && fabsf(py - s.p(g + 1)) <= h && fabsf(pz - s.p(g + 2)) <= h;
    } else {
      in = false;  // plane
    }
    if (sp < STACK_WORD) {
      stk = (stk & ~(1u << sp)) | ((unsigned)in << sp);
    } else {
      H.tag(sp) = in;
    }
    ++sp;
  }
  return get(sp - 1);
}

// ---- all-hits lists + CSG parity walk (pallas_trace all_hits) -------------

// The two crossings of a sphere or cube leaf, ascending, as distances (1e30 =
// none).  TAGS: also their tags, and a cube's crossings by its faces (the
// closest-hit scan); without, a cube's crossings by the slab test (the
// shadow scans).  `rel` is the leaf's instruction relative to its node's.
template <bool TAGS>
__device__ __forceinline__ void leaf_pair(const Scene& s, int ins, int rel, const Ray& r,
                                          float& ta, float& tb, unsigned& ga, unsigned& gb) {
  const int g = s.word(ins + I_ARG);
  ga = gb = 0u;
  if (s.word(ins + I_OP) == OP_SPHERE) {
    float x1, x2;
    const bool has = sphere_roots(s, g, r, x1, x2);
    const bool ok2 = has && x2 >= 0.0f, ok1 = has && x1 >= 0.0f;
    ta = ok2 ? x2 : INF;
    tb = ok1 ? x1 : INF;
    if (TAGS) {
      ga = make_tag(rel, 0, ok2);
      gb = make_tag(rel, 1, ok1);
    }
  } else if (TAGS) {
    int f1, f2;
    cube_two_faces(s, g, r, ta, f1, tb, f2);
    ga = make_tag(rel, f1, ta < INF);
    gb = make_tag(rel, f2, tb < INF);
  } else {
    cube_slab_dists(s, g, r, ta, tb);
  }
}

// A node that is one CSG merge of two sphere or cube leaves (instructions
// start, start + 1, start + 2; four hits): the same merge as all_hits makes,
// with the four slots in registers and the network of four unrolled:
// ops/round0.py _oddeven_pairs(4) is (0,1) (2,3) (0,2) (1,3) (1,2).
// Returns the closest hit's distance (TAGS: the first minimum and its tag;
// without: the NaN-propagating minimum).
template <bool TAGS>
__device__ __forceinline__ float csg_two_leaves(const Scene& s, int start, const Ray& r, unsigned& tag) {
  float t[4];
  unsigned g[4];
  leaf_pair<TAGS>(s, s.instr(start), 0, r, t[0], t[1], g[0], g[1]);
  leaf_pair<TAGS>(s, s.instr(start + 1), 1, r, t[2], t[3], g[2], g[3]);
  const int csg = s.word(s.instr(start + 2) + C_CSG);
  // initial parity: odd hit count => started inside (geometry.d:307-309)
  bool in_l = ((t[0] < INF) != (t[1] < INF)), in_r = ((t[2] < INF) != (t[3] < INF));
  bool right[4] = {false, false, true, true};
#define C2RT_CE(i, j)             \
  if (t[i] > t[j]) {              \
    const float tt = t[i];        \
    t[i] = t[j];                  \
    t[j] = tt;                    \
    const unsigned gg = g[i];     \
    g[i] = g[j];                  \
    g[j] = gg;                    \
    const bool rr = right[i];     \
    right[i] = right[j];          \
    right[j] = rr;                \
  }
  C2RT_CE(0, 1)
  C2RT_CE(2, 3)
  C2RT_CE(0, 2)
  C2RT_CE(1, 3)
  C2RT_CE(1, 2)
#undef C2RT_CE
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool valid = t[m] < INF;
    in_l = in_l ^ (!right[m] && valid);
    in_r = in_r ^ (right[m] && valid);
    if (valid && !bool_op(csg, in_l, in_r)) {  // dropped by this merge, instruction 2
      t[m] = INF;
      g[m] = drop_tag(g[m], 2);
    }
  }
  float best = t[0];
  tag = g[0];
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    if (TAGS) {
      if (t[m] < best) {
        best = t[m];
        tag = g[m];
      }
    } else {
      best = jmin(best, t[m]);
    }
  }
  return best;
}

// Evaluates node expression instructions [start, start+count) into the
// list: the whole expression's hits in the JAX kernel's order, as distances
// (1e30 = none); TAGS as in leaf_pair.  Without TAGS a slot's tag holds only
// the side bit a merge needs.
template <bool TAGS, class L>
__device__ void all_hits(const Scene& s, int start, int count, const Ray& r, L& H) {
  int sp = 0;
  for (int k = start; k < start + count; ++k) {
    const int ins = s.instr(k);
    const int op = s.word(ins + I_OP);
    const int rel = k - start;  // this instruction, relative to the node's first
    if (op == OP_PLANE) {
      const float t = plane_closest(s, s.word(ins + I_ARG), r, false).t;
      H.t(sp) = t;
      if (TAGS) H.tag(sp) = make_tag(rel, 0, t < INF);
      ++sp;
    } else if (op != OP_CSG) {
      float ta, tb;
      unsigned ga, gb;
      leaf_pair<TAGS>(s, ins, rel, r, ta, tb, ga, gb);
      H.t(sp) = ta;
      H.t(sp + 1) = tb;
      if (TAGS) {
        H.tag(sp) = ga;
        H.tag(sp + 1) = gb;
      }
      sp += 2;
    } else {
      const int csg = s.word(ins + C_CSG);
      const int pair0 = s.word(ins + C_PAIR0), n_pairs = s.word(ins + C_NPAIRS);
      const int n_l = s.word(ins + C_NL), n_r = s.word(ins + C_NR);
      const int base = sp - n_l - n_r;
      // initial parity: odd hit count => started inside (geometry.d:307-309);
      // and each slot's side
      int c_l = 0, c_r = 0;
      for (int m = base; m < sp; ++m) {
        const bool from_right = m >= base + n_l;
        (from_right ? c_r : c_l) += H.t(m) < INF;
        if (TAGS) {
          H.tag(m) = from_right ? (H.tag(m) | TAG_SIDE) : (H.tag(m) & ~TAG_SIDE);
        } else {
          H.tag(m) = from_right ? TAG_SIDE : 0u;
        }
      }
      bool in_l = c_l & 1, in_r = c_r & 1;
      for (int q = pair0; q < pair0 + n_pairs; ++q) {
        const int i = base + s.pair(q, 0), j = base + s.pair(q, 1);
        const float ti = H.t(i), tj = H.t(j);
        if (ti > tj) {
          H.t(i) = tj;
          H.t(j) = ti;
          const unsigned gi = H.tag(i);
          H.tag(i) = H.tag(j);
          H.tag(j) = gi;
        }
      }
      for (int m = base; m < sp; ++m) {
        const bool valid = H.t(m) < INF;
        const bool from_right = (H.tag(m) & TAG_SIDE) != 0u;
        in_l = in_l ^ (!from_right && valid);
        in_r = in_r ^ (from_right && valid);
        if (valid && !bool_op(csg, in_l, in_r)) {  // dropped here
          H.t(m) = INF;
          if (TAGS) H.tag(m) = drop_tag(H.tag(m), rel);
        }
      }
    }
  }
}

// Closest hit of one node's expression, untransformed, as a distance and the
// tag that hit_record rebuilds the record from.  Ties: the first minimum in
// list order.
template <class L>
__device__ float expr_closest(const Scene& s, int nd, const Ray& r, L& H, unsigned& tag) {
  const int start = s.word(nd + N_START), count = s.word(nd + N_COUNT);
  if (count == 1) {
    const int ins = s.instr(start);
    const int op = s.word(ins + I_OP), g = s.word(ins + I_ARG);
    if (op == OP_PLANE) {
      const float t = plane_closest(s, g, r, false).t;
      tag = make_tag(0, 0, t < INF);
      return t;
    }
    if (op == OP_SPHERE) {
      float x1, x2;
      const bool has = sphere_roots(s, g, r, x1, x2);
      const bool far = x2 < 0.0f;  // nearer root unless behind
      const float sol = far ? x1 : x2;
      const bool ok = has && sol >= 0.0f;
      tag = make_tag(0, far ? 1 : 0, ok);
      return ok ? sol : INF;
    }
    float t1, t2;
    int f1, f2;
    cube_two_faces(s, g, r, t1, f1, t2, f2);
    tag = make_tag(0, f1, t1 < INF);
    return t1;
  }
  const int nh = s.word(nd + N_HITS);
  if (count == 3 && nh == 4) return csg_two_leaves<true>(s, start, r, tag);
  all_hits<true>(s, start, count, r, H);
  float best = H.t(0);
  int slot = 0;
  for (int m = 1; m < nh; ++m) {
    const float t = H.t(m);
    if (t < best) {
      best = t;
      slot = m;
    }
  }
  tag = H.tag(slot);
  return best;
}

// The record of the hit that `tag` names in one node's expression: its leaf
// evaluated again (the same expressions as the scan's, so the same bits),
// the normal flipped by every CsgDiff above the leaf that kept the hit
// (geometry.d:377-397, probe step 1e-3), and `t`, the distance the scan
// ended with (1e30 when the hit missed or was dropped).
template <class L>
__device__ Rec hit_record(const Scene& s, L& H, int nd, const Ray& r, unsigned tag, float t, bool uv) {
  const int start = s.word(nd + N_START);
  const int ins = s.instr(start + (int)(tag & TAG_FIELD));
  const int op = s.word(ins + I_OP), g = s.word(ins + I_ARG);
  const int which = (int)((tag >> TAG_BITS) & 7u);
  Rec h;
  if (op == OP_PLANE) {
    h = plane_closest(s, g, r, uv);
  } else if (op == OP_SPHERE) {
    float x1, x2;
    const bool has = sphere_roots(s, g, r, x1, x2);
    const float x = which ? x1 : x2;
    h = sphere_record(s, g, r, x, has && x >= 0.0f, uv);
  } else {
    h = cube_face(s, g, r, which, uv);
  }
  // the CsgDiff merges above the leaf, ascending, up to the one that dropped it
  const int dropped = (int)((tag >> 16) & TAG_FIELD);
  const int d0 = s.word(ins + I_DIFFS), n_diffs = s.word(ins + I_NDIFFS);
  for (int q = 0; q < n_diffs; ++q) {
    const int rel = s.word(d0 + q);
    if (rel >= dropped) break;
    const int csg = s.instr(start + rel);
    const int r_start = s.word(csg + C_RSTART), r_end = s.word(csg + C_REND);
    const float hx = r.ox + r.dx * h.t, hy = r.oy + r.dy * h.t, hz = r.oz + r.dz * h.t;
    const bool before = is_inside(s, H, r_start, r_end, hx - r.dx * 1e-3f, hy - r.dy * 1e-3f,
                                  hz - r.dz * 1e-3f);
    const bool after = is_inside(s, H, r_start, r_end, hx + r.dx * 1e-3f, hy + r.dy * 1e-3f,
                                 hz + r.dz * 1e-3f);
    if (before != after) {
      h.nx = -h.nx;
      h.ny = -h.ny;
      h.nz = -h.nz;
    }
  }
  h.t = t;
  return h;
}

// ---- dist-only variant for the shadow scans --------------------------------

template <class L>
__device__ float expr_min_dist(const Scene& s, int nd, const Ray& r, L& H) {
  const int start = s.word(nd + N_START), count = s.word(nd + N_COUNT);
  if (count == 1) {
    const int ins = s.instr(start);
    const int op = s.word(ins + I_OP), g = s.word(ins + I_ARG);
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
  const int nh = s.word(nd + N_HITS);
  if (count == 3 && nh == 4) {
    unsigned unused;
    return csg_two_leaves<false>(s, start, r, unused);
  }
  all_hits<false>(s, start, count, r, H);
  float best = H.t(0);
  for (int m = 1; m < nh; ++m) best = jmin(best, H.t(m));
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

// the ray in the node's own frame; for a full matrix also 1 / |M^-1 d|,
// which rescales a distance back to the world
__device__ __forceinline__ Ray local_ray(const Scene& s, int nd, const Ray& r, float& inv_dl) {
  const int xk = s.word(nd + N_XKIND), xo = s.word(nd + N_XOFF);
  inv_dl = 1.0f;
  if (xk == X_IDENT) return r;
  if (xk == X_OFFSET) return Ray{r.ox - s.p(xo), r.oy - s.p(xo + 1), r.oz - s.p(xo + 2), r.dx, r.dy, r.dz};
  float mi[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) mi[k] = s.p(xo + 9 + k);
  const float fx = s.p(xo + 18), fy = s.p(xo + 19), fz = s.p(xo + 20);
  Ray lr;
  mulr(mi, r.ox - fx, r.oy - fy, r.oz - fz, lr.ox, lr.oy, lr.oz);
  float cx, cy, cz;
  mulr(mi, r.dx, r.dy, r.dz, cx, cy, cz);
  const float dlen = sqrtf(jmax(cx * cx + cy * cy + cz * cz, 1e-30f));
  inv_dl = 1.0f / dlen;
  lr.dx = cx * inv_dl;
  lr.dy = cy * inv_dl;
  lr.dz = cz * inv_dl;
  return lr;
}

// a local distance in the world: only a full matrix rescales
__device__ __forceinline__ float world_dist(const Scene& s, int nd, float d, float inv_dl) {
  if (s.word(nd + N_XKIND) != X_MATRIX) return d;
  return d >= INF ? INF : d * inv_dl;
}

// node i's closest hit along r: its distance, and the tag of the hit
template <class L>
__device__ float node_closest(const Scene& s, int i, const Ray& r, L& H, unsigned& tag) {
  const int nd = s.node(i);
  float inv_dl;
  const Ray lr = local_ray(s, nd, r, inv_dl);
  return world_dist(s, nd, expr_closest(s, nd, lr, H, tag), inv_dl);
}

// the record of node i's hit `tag` at world distance t, normal in the world
template <class L>
__device__ Rec node_record(const Scene& s, L& H, int i, const Ray& r, unsigned tag, float t) {
  const int nd = s.node(i);
  const bool uv = s.word(nd + N_UV) != 0;
  float inv_dl;
  const Ray lr = local_ray(s, nd, r, inv_dl);
  Rec h = hit_record(s, H, nd, lr, tag, t, uv);
  if (s.word(nd + N_XKIND) == X_MATRIX) {
    // world normal: row vector times mi^T (the inverse is read again
    // rather than kept in registers across the record)
    const int mi = s.word(nd + N_XOFF) + 9;
    const float wx = h.nx * s.p(mi + 0) + h.ny * s.p(mi + 1) + h.nz * s.p(mi + 2);
    const float wy = h.nx * s.p(mi + 3) + h.ny * s.p(mi + 4) + h.nz * s.p(mi + 5);
    const float wz = h.nx * s.p(mi + 6) + h.ny * s.p(mi + 7) + h.nz * s.p(mi + 8);
    const float ninv = rsq(wx * wx + wy * wy + wz * wz);
    h.nx = wx * ninv;
    h.ny = wy * ninv;
    h.nz = wz * ninv;
  }
  return h;
}

template <class L>
__device__ float node_min_dist(const Scene& s, int i, const Ray& r, L& H) {
  const int nd = s.node(i);
  float inv_dl;
  const Ray lr = local_ray(s, nd, r, inv_dl);
  return world_dist(s, nd, expr_min_dist(s, nd, lr, H), inv_dl);
}

// does any node lie between the ray's origin and `target` along it
// (scene.d:62-78); stops at the first that does
template <class L>
__device__ __forceinline__ bool occluded(const Scene& s, int n_nodes, const Ray& sray, float target, L& H) {
  bool occ = false;
  for (int i = 0; i < n_nodes && !occ; ++i) occ = node_min_dist(s, i, sray, H) <= target;
  return occ;
}

// ---- one lane ---------------------------------------------------------------

template <class L>
__device__ __forceinline__ void trace_lane(const Scene& s, L& H, int lane,
                                           const float* __restrict__ orig,
                                           const float* __restrict__ dir, float* __restrict__ out,
                                           int* __restrict__ win_out, int n, int width, int height) {
  const int n_nodes = s.head(H_NODES);
  const int n_lights = s.head(H_LIGHTS);
  const int flags = s.head(H_FLAGS);

  if (STAGE == STAGE_EMPTY) {
    // the grid and store floor: the lane index times the aa offset
    const float v = (float)lane * s.p(s.head(H_AA));
    out[lane] = v;
    out[(size_t)n + lane] = v + 1.0f;
    return;
  }

  Ray r;
  if (orig != nullptr) {
    r.ox = orig[3 * (size_t)lane];
    r.oy = orig[3 * (size_t)lane + 1];
    r.oz = orig[3 * (size_t)lane + 2];
    r.dx = dir[3 * (size_t)lane];
    r.dy = dir[3 * (size_t)lane + 1];
    r.dz = dir[3 * (size_t)lane + 2];
  } else {
    // pinhole ray-gen on the pos-free corner deltas (camera.d:119-147);
    // the deltas are unscaled and divided by width/height here, as in
    // ops/camera.screen_rays
    const int lin = (int)s.p(s.head(H_LIN)) + lane;
    const int aa = s.head(H_AA), c = s.head(H_CAM);
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

  // closest hit over every node, as distances; ties go to the later node
  // (renderer.d:336-338), and a lane that misses them all keeps the last
  // node's record, as the record-carrying scan did
  float best_t = INF;
  unsigned best_tag = 0u;
  int best_node = 0, win = -1;
  for (int i = 0; i < n_nodes; ++i) {
    unsigned tag;
    const float t = node_closest(s, i, r, H, tag);
    if (i == 0 || t <= best_t) {
      if (t < INF) win = i;
      best_t = t;
      best_tag = tag;
      best_node = i;
    }
  }
  // the one record this lane needs
  const Rec hit = node_record(s, H, best_node, r, best_tag, best_t);
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
  // shadow rays start a step off the surface
  const float sx = hpx + nx * EPS_SHADOW, sy = hpy + ny * EPS_SHADOW, sz = hpz + nz * EPS_SHADOW;

  if (STAGE == STAGE_SHADOW) {
    // the shadow scans alone: lights the hit point sees (missed lanes
    // shade from t = 0, as the plain version does), and the winning t
    float acc = 0.0f;
    for (int li = 0; li < n_lights; ++li) {
      const int lbase = s.light(li);
      const float tx2 = s.p(lbase) - sx, ty2 = s.p(lbase + 1) - sy, tz2 = s.p(lbase + 2) - sz;
      const float target = sqrtf(jmax(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30f));
      const float inv_t = 1.0f / target;
      const Ray sray = {sx, sy, sz, tx2 * inv_t, ty2 * inv_t, tz2 * inv_t};
      acc += occluded(s, n_nodes, sray, target, H) ? 0.0f : 1.0f;
    }
    out[lane] = acc;
    out[(size_t)n + lane] = hit.t;
    return;
  }

  // the winning node's shader; its material is read where it is used, and
  // its diffuse color after the scans, so that little is live across them
  const int wnd = s.node(hitmask ? win : 0);
  const int shader = hitmask ? s.word(wnd + N_SHADER) : -1;
  const int bm = s.word(wnd + N_MAT);
  const bool is_phong = shader == PHONG;
  const bool shaded = shader == LAMBERT || is_phong;  // a hit whose direct light is used

  // output rows: r, g, b, [lr lg lb u v], [rox..rdz], [t nx ny nz dr dg db],
  // [vis0..]: the order of ops/round0.py layout()
  const int cont_row = 3 + ((flags & F_EMIT_L) ? 5 : 0);
  const int hit_row = cont_row + ((flags & F_CONT) ? 6 : 0);
  const int vis_row = hit_row + ((flags & F_HIT) ? 7 : 0);

  // direct light with in-kernel shadow scans.  The light sums of a lane
  // that is not `shaded` are written as zeros below, so without the vis
  // rows such a lane scans nothing.
  const int amb = s.head(H_AMBIENT);
  float lr = s.p(amb), lg = s.p(amb + 1), lb = s.p(amb + 2);
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  const bool lit = shaded || (flags & F_VIS);
  for (int li = 0; lit && li < n_lights; ++li) {
    const int lbase = s.light(li);
    const float lx = s.p(lbase), ly = s.p(lbase + 1), lz = s.p(lbase + 2);
    // shadow scan (scene.d:62-78): any node with dist <= |to - from|
    const float tx2 = lx - sx, ty2 = ly - sy, tz2 = lz - sz;
    const float target = sqrtf(jmax(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30f));
    const float inv_t = 1.0f / target;
    const Ray sray = {sx, sy, sz, tx2 * inv_t, ty2 * inv_t, tz2 * inv_t};
    const bool vis = !occluded(s, n_nodes, sray, target, H);
    if (flags & F_VIS) out[(size_t)(vis_row + li) * n + lane] = vis ? 1.0f : 0.0f;
    const float tlx = lx - hpx, tly = ly - hpy, tlz = lz - hpz;
    const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
    const float inv_l = rsq(dist2);
    const float ldx = tlx * inv_l, ldy = tly * inv_l, ldz = tlz * inv_l;
    const float cos_t = ldx * nx + ldy * ny + ldz * nz;
    const float w = (vis && cos_t > 0.0f) ? cos_t / dist2 : 0.0f;
    lr += s.p(lbase + 3) * w;
    lg += s.p(lbase + 4) * w;
    lb += s.p(lbase + 5) * w;
    if (is_phong) {  // only a Phong winner adds the highlight below
      // R = reflect(-lightDir, N); cosGamma = R . -d (shader.d:226-249)
      const float mdotn = (-ldx) * nx + (-ldy) * ny + (-ldz) * nz;
      const float rx = -ldx - 2.0f * mdotn * nx;
      const float ry = -ldy - 2.0f * mdotn * ny;
      const float rz = -ldz - 2.0f * mdotn * nz;
      const float inv_r = rsq(rx * rx + ry * ry + rz * rz);
      const float cos_g = (rx * (-r.dx) + ry * (-r.dy) + rz * (-r.dz)) * inv_r;
      const float spec_w = (vis && cos_g > 0.0f)
                               ? powf(jmax(cos_g, 0.0f), s.p(bm + 3)) * s.p(bm + 4) / dist2
                               : 0.0f;
      sr += s.p(lbase + 3) * spec_w;
      sg += s.p(lbase + 4) * spec_w;
      sb += s.p(lbase + 5) * spec_w;
    }
  }

  // the winning node's diffuse color
  float dr = 0.0f, dg = 0.0f, db = 0.0f;
  if (hitmask) {
    const int tex = s.word(wnd + N_TEX), bt = s.word(wnd + N_TEXOFF);
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
  }

  float outr = dr * lr, outg = dg * lg, outb = db * lb;
  if (is_phong) {
    outr += sr;
    outg += sg;
    outb += sb;
  }
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
      const float ior = s.p(bm + 5);
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

// ---- the kernel -------------------------------------------------------------

// A block copies the two tables into shared memory, then traces the 128
// lanes of tile blockIdx.x.  GLOBAL_LISTS: the hit lists are in `lists`, a
// global [2 * capacity, n] scratch; otherwise after the tables in shared
// memory.
template <bool GLOBAL_LISTS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
round0_kernel(const float* __restrict__ prm, const int* __restrict__ prog, int n_prm, int n_prog,
              const float* __restrict__ orig, const float* __restrict__ dir, float* __restrict__ lists,
              float* __restrict__ out, int* __restrict__ win_out, int n, int width, int height) {
#if C2RT_TABLES_SHARED
  for (int k = threadIdx.x; k < n_prog; k += BLOCK) tables[k] = __ldg(prog + k);
  for (int k = threadIdx.x; k < n_prm; k += BLOCK) tables[n_prog + k] = __float_as_int(__ldg(prm + k));
  __syncthreads();
#endif
  Scene s;
  s.bind(prm, prog, n_prog);
  const unsigned lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= (unsigned)n) return;
  if constexpr (GLOBAL_LISTS) {
    GlobalLists H{lists + lane, (size_t)n};
    trace_lane(s, H, (int)lane, orig, dir, out, win_out, n, width, height);
  } else {
    SharedLists H{n_prog + n_prm + (int)threadIdx.x};
    trace_lane(s, H, (int)lane, orig, dir, out, win_out, n, width, height);
  }
}

// ---- host side -------------------------------------------------------------

// dynamic shared memory of a launch: the two tables, and the hit lists when
// they are not in global memory (a distance and a tag per slot and thread)
int shared_bytes(int n_prm, int n_prog, int list_cap, bool global_lists) {
  return 4 * (n_prm + n_prog) + (global_lists ? 0 : 8 * list_cap * BLOCK);
}

// Whether `dyn_bytes` fit in a block's shared memory on the current device;
// raises the kernel's dynamic limit to what the device allows.
template <bool GLOBAL_LISTS>
bool shared_fits(int dyn_bytes) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, round0_kernel<GLOBAL_LISTS>) != cudaSuccess)
    return false;
  if ((size_t)dyn_bytes + attr.sharedSizeBytes > (size_t)optin) return false;
  return cudaFuncSetAttribute(round0_kernel<GLOBAL_LISTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)attr.sharedSizeBytes) == cudaSuccess;
}

// the fit depends on the device, the placement and the bytes only
template <bool GLOBAL_LISTS>
bool fits_cached(int dyn) {
  static int cached_dev = -1, cached_dyn = -1;
  static bool cached_fit = false;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || dyn != cached_dyn) {
    cached_fit = shared_fits<GLOBAL_LISTS>(dyn);
    cached_dev = dev;
    cached_dyn = dyn;
  }
  return cached_fit;
}

}  // namespace

extern "C" {

// Launches K1 on `stream` for n lanes.  `prm` ([n_prm] f32) and `prog`
// ([n_prog] int32) are the scene's tables; `list_cap` is the program's
// list capacity (its header's H_LIST_CAP).  `orig`/`dir` ([n, 3] f32)
// select the ray-input form; both null select in-kernel ray-gen for the n
// pixels from the lane base in prm's lin slot (the screen-tap form: base
// 0, n = width * height; the lin-input form: any slice).  `lists` is null
// for hit lists in shared memory, or a [2 * list_cap, n] f32 scratch in
// global memory.  `out` is [K, n] f32 with K the layout's float outputs
// (the program's flags say which, residual rows included), `win` [n]
// int32.  A stage build (C2RT_STAGE 1..4) writes two rows into `out` and
// leaves `win` alone.  Returns cudaErrorInvalidValue when the tables (and
// the lists, if shared) do not fit in a block's shared memory, else
// cudaGetLastError() after the launch (0 = launched).
int c2rt_round0(const float* prm, const int* prog, int n_prm, int n_prog, int list_cap, const float* orig,
                const float* dir, float* lists, float* out, int* win, int n, int width, int height,
                void* stream) {
  if (n <= 0) return 0;
  const bool global_lists = lists != nullptr;
  const int dyn = shared_bytes(n_prm, n_prog, list_cap, global_lists);
  const int n_tiles = (int)(((unsigned)n + BLOCK - 1u) / BLOCK);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (global_lists) {
    if (!fits_cached<true>(dyn)) return static_cast<int>(cudaErrorInvalidValue);
    round0_kernel<true><<<n_tiles, BLOCK, dyn, st>>>(prm, prog, n_prm, n_prog, orig, dir, lists, out, win, n,
                                                     width, height);
  } else {
    if (!fits_cached<false>(dyn)) return static_cast<int>(cudaErrorInvalidValue);
    round0_kernel<false><<<n_tiles, BLOCK, dyn, st>>>(prm, prog, n_prm, n_prog, orig, dir, lists, out, win, n,
                                                      width, height);
  }
  return static_cast<int>(cudaGetLastError());
}

int c2rt_program_version() { return PROGRAM_VERSION; }

int c2rt_stage() { return STAGE; }

const char* c2rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
