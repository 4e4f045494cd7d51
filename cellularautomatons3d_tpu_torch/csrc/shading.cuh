// The per-pixel geometry and shading of the extended-lighting frames, shared
// by the queries kernel (lighting_queries.cu), the shade kernel
// (lighting_shade.cu), K1's composition (render_fast.cu) and the frame's
// composition kernel (compose.cu); and the tiled lighting kernels' blocks:
// a tile's pixels, their compacted hits and the GI tree's live nodes in
// shared memory (block_scan, TileNodes, expand_level).
//
// Device twins of the port's torch functions, each in its operations'
// order and rounding (built with --fmad=false, IEEE division and sqrt):
// render/intersect.py ray_cube_intersect (the reciprocal, then products),
// vec_norm (sqrt((x^2 + y^2) + z^2)), normalize (three divisions by the
// norm) and cube_face_normal (x, then y, then z on exact ties);
// render/renderer.py _face_index and _INDIRECT_LAYERS; render/render_slab.py
// _hit_geometry, hit_geometry's miss depth, soft_shadow_jitter (sin in
// float64, rounded once), _slot_geometry at any node of the GI tree and
// the tree's row layout; render/brdf.py
// trowbridge_reitz_ggx, schlick_ggx, fresnel_schlick, surface_brdf and
// calculate_lighting_at (the position rainbow when the material is all
// zero); the frame composition of renderer_fast.py _ext_frame (K1's own).
// Every min, max and clamp propagates NaN as torch's do (fminf / fmaxf
// would drop it).  Scalars the twins take from Python are rounded to f32
// from their double value ((float)12.9898, not 12.9898f), as torch rounds
// them; constants the twins round on the host (a^2 - 1, 1 - k, 1 - base,
// the emissive product, ...) arrive in LightConsts.
//
// Replaces: the XLA shading of cellularautomatons3d_tpu/render/
// render_slab.py lighting_passes (:1431), hit_geometry (:1661),
// soft_shadow_jitter (:1221), indirect_bounce (:1308), brdf.py (:32-109)
// and renderer_fast.py _ext_frame_blocked (:318) and render_frame_fast
// (:208), which JAX fuses under jit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace ca3d {

// Camera/params vector layout (render_fast.py P_* constants; the ray's are
// in sweep.cuh).
constexpr int P_LIGHT = 14;
constexpr int P_LMAG = 17;
constexpr int P_ROUGH = 19;
constexpr int P_REFL = 20;
constexpr int P_MATC = 23;
constexpr int P_LRAD = 26;
constexpr int P_EMIS = 27;
constexpr int P_EMISS = 30;
constexpr int P_TIME = 31;
constexpr int P_ALPHA = 33;
constexpr int P_GAMMA = 34;
constexpr int P_OVERLAY = 35;

// The host-rounded constants of a lighting launch (render_slab.py
// _light_consts builds them, in this order).
struct LightConsts {
  float cell;       // f32(1 / n)
  float chalf;      // f32(cell * 0.5)
  float vis_half;   // the visible cube's half size (_cell_half)
  float base;       // the jitter's time offset f32(0.07) * fract(t)
  float rad2;       // f32(2) * light_radius
  float a2, a2m1;   // roughness^2 and a2 - 1
  float kd, omk;    // the geometry term's k and 1 - k
  float refl[3];    // base reflectivity
  float omrefl[3];  // 1 - base reflectivity
  float mat[3];     // material colour (all zero: the position rainbow)
  float emis[3];    // emissive colour * strength
  float fn;         // float(n), the rainbow's divisor
  float occ_div;    // the soft occlusion's divisor (1 in temporal mode)
  float inv_g;      // f32(1) / gamma
};
constexpr int kLightConsts = 24;
static_assert(sizeof(LightConsts) == kLightConsts * sizeof(float),
              "LightConsts is the host's float vector");

// The occluded-shadow quotient (render_fast.py OCCLUDED).
__device__ __forceinline__ float occlusion_quotient(bool occluded) {
  return occluded ? (float)0.0095 : 1.0f;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// brdf.py _dot: the products, then (p0 + p1) + p2.
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return (p0 + p1) + p2;
}

__device__ __forceinline__ float vec_norm(V3 v) {
  const float s0 = v.x * v.x, s1 = v.y * v.y, s2 = v.z * v.z;
  return sqrtf((s0 + s1) + s2);
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = vec_norm(v);
  return {v.x / n, v.y / n, v.z / n};
}

// torch.clamp(x, min=0): NaN passes.
__device__ __forceinline__ float clamp_min0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// torch.clamp(x, 0, 1) and K1's clip01: NaN passes.
__device__ __forceinline__ float clamp01(float x) {
  return minp(maxp(x, 0.0f), 1.0f);
}

// intersect.py cube_face_normal: the dominant component of p - co (ties
// to x, then y, then z), divided by its length.
__device__ __forceinline__ V3 cube_face_normal(V3 p, V3 co) {
  const V3 d = p - co;
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const float m = maxp(maxp(ax, ay), az);
  const bool is_x = ax == m;
  const bool is_y = ay == m && !is_x;
  const bool is_z = !is_x && !is_y;
  const V3 n{is_x ? d.x : 0.0f, is_y ? d.y : 0.0f, is_z ? d.z : 0.0f};
  const float len = vec_norm(n);
  return {n.x / len, n.y / len, n.z / len};
}

// renderer.py _face_index: -x, +x, -y, +y, -z, +z.
__device__ __forceinline__ int face_index(V3 n) {
  if (fabsf(n.x) > 0.5f) return n.x < 0.0f ? 0 : 1;
  if (fabsf(n.y) > 0.5f) return n.y < 0.0f ? 2 : 3;
  return n.z < 0.0f ? 4 : 5;
}

// renderer.py _INDIRECT_LAYERS [face][slot][xyz], each component in
// {-1, 0, 1}, packed as 2-bit fields (value + 1) of one word a face: slot s,
// component c at bits 6 s + 2 c.
__device__ __forceinline__ void layer_offset(int face, int slot, int& ox,
                                             int& oy, int& oz) {
  // Faces -x, +x, -y, +y, -z, +z; slots (x, y, z) as in the table.
  constexpr uint32_t kFaces[6] = {
      // -x: (-1,1,0) (-1,-1,0) (-1,0,1) (-1,0,-1)
      (0u | 2u << 2 | 1u << 4) | (0u | 0u << 2 | 1u << 4) << 6 |
          (0u | 1u << 2 | 2u << 4) << 12 | (0u | 1u << 2 | 0u << 4) << 18,
      // +x: (1,1,0) (1,-1,0) (1,0,1) (1,0,-1)
      (2u | 2u << 2 | 1u << 4) | (2u | 0u << 2 | 1u << 4) << 6 |
          (2u | 1u << 2 | 2u << 4) << 12 | (2u | 1u << 2 | 0u << 4) << 18,
      // -y: (-1,-1,0) (1,-1,0) (0,-1,1) (0,-1,-1)
      (0u | 0u << 2 | 1u << 4) | (2u | 0u << 2 | 1u << 4) << 6 |
          (1u | 0u << 2 | 2u << 4) << 12 | (1u | 0u << 2 | 0u << 4) << 18,
      // +y: (-1,1,0) (1,1,0) (0,1,1) (0,1,-1)
      (0u | 2u << 2 | 1u << 4) | (2u | 2u << 2 | 1u << 4) << 6 |
          (1u | 2u << 2 | 2u << 4) << 12 | (1u | 2u << 2 | 0u << 4) << 18,
      // -z: (0,1,-1) (0,-1,-1) (-1,0,-1) (1,0,-1)
      (1u | 2u << 2 | 0u << 4) | (1u | 0u << 2 | 0u << 4) << 6 |
          (0u | 1u << 2 | 0u << 4) << 12 | (2u | 1u << 2 | 0u << 4) << 18,
      // +z: (0,1,1) (0,-1,1) (-1,0,1) (1,0,1)
      (1u | 2u << 2 | 2u << 4) | (1u | 0u << 2 | 2u << 4) << 6 |
          (0u | 1u << 2 | 2u << 4) << 12 | (2u | 1u << 2 | 2u << 4) << 18,
  };
  uint32_t word = kFaces[0];
#pragma unroll
  for (int f = 1; f < 6; ++f) {
    if (face == f) word = kFaces[f];
  }
  const uint32_t s = word >> (6 * slot);
  ox = (int)(s & 3u) - 1;
  oy = (int)((s >> 2) & 3u) - 1;
  oz = (int)((s >> 4) & 3u) - 1;
}

// intersect.py ray_cube_intersect: the slab test of the cube of half size h
// at c, by the reciprocal of d, then products.
__device__ __forceinline__ void ray_cube_intersect(V3 o, V3 d, V3 c, float h,
                                                   float& tn, float& tf) {
  const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
  const float t1x = ((c.x - h) - o.x) * ix, t2x = ((c.x + h) - o.x) * ix;
  const float t1y = ((c.y - h) - o.y) * iy, t2y = ((c.y + h) - o.y) * iy;
  const float t1z = ((c.z - h) - o.z) * iz, t2z = ((c.z + h) - o.z) * iz;
  tn = maxp(maxp(minp(t1x, t2x), minp(t1y, t2y)), minp(t1z, t2z));
  tf = minp(minp(maxp(t1x, t2x), maxp(t1y, t2y)), maxp(t1z, t2z));
}

// Python's floor division and modulo of an int by a positive int (torch's
// // and % on int tensors).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// The centre of cell (x, y, z), which may lie one cell outside the grid
// (a GI slot's unclamped neighbour).
__device__ __forceinline__ V3 cell_origin(const LightConsts& K, int x, int y, int z) {
  return {((float)x * K.cell + K.chalf) - 0.5f, ((float)y * K.cell + K.chalf) - 0.5f,
          ((float)z * K.cell + K.chalf) - 0.5f};
}

// render_slab.py _hit_geometry at one pixel: the camera ray (d, and the
// window's ux, uy), the surface point q = o + d * t, the cell coordinates
// decoded from the id (a miss, -1, gives (n-1, n-1, -1)), the cell centre
// and the hit flag.
struct Hit {
  V3 o, d, q, origin;
  int cx, cy, cz;
  float ux, uy;
  bool found;
};

__device__ __forceinline__ Hit hit_geometry(const float* P,
                                            const LightConsts& K, int n,
                                            int px, int py, int id, float t) {
  Hit h;
  const Ray r = camera_ray(P, px, py, h.ux);
  h.uy = 1.0f - ((float)py + P[P_ROW0] + 0.5f) / P[P_WIN + 1];
  h.o = {r.ox, r.oy, r.oz};
  h.d = {r.dx, r.dy, r.dz};
  h.q = {h.o.x + h.d.x * t, h.o.y + h.d.y * t, h.o.z + h.d.z * t};
  h.cx = floor_mod(id, n);
  h.cy = floor_mod(floor_div(id, n), n);
  h.cz = floor_div(id, n * n);
  h.origin = cell_origin(K, h.cx, h.cy, h.cz);
  h.found = id >= 0;
  return h;
}

// render_slab.py hit_geometry's miss depth: the volume's exit t of a ray
// that crosses the volume, else 0.
__device__ __forceinline__ float miss_depth(const float* P, V3 d) {
  const float t1x = (-0.5f - P[P_O]) / d.x, t2x = (0.5f - P[P_O]) / d.x;
  const float t1y = (-0.5f - P[P_O + 1]) / d.y, t2y = (0.5f - P[P_O + 1]) / d.y;
  const float t1z = (-0.5f - P[P_O + 2]) / d.z, t2z = (0.5f - P[P_O + 2]) / d.z;
  const float tf = minp(minp(maxp(t1x, t2x), maxp(t1y, t2y)), maxp(t1z, t2z));
  const float tn = maxp(maxp(minp(t1x, t2x), minp(t1y, t2y)), minp(t1z, t2z));
  return (tn <= tf && tf >= 0.0f) ? tf : 0.0f;
}

// render_slab.py soft_shadow_jitter at one pixel for sample k: the
// sin-fract hash of the global-window uvs per component, times 2 * radius.
__device__ __forceinline__ float jitter1(float ux, float uy, float base,
                                         float cst) {
  const float ax = (ux + base) + cst;
  const float ay = (uy + base) + cst;
  const float arg = ax * (float)12.9898 + ay * (float)78.233;
  const float v = (float)sin((double)arg) * (float)43758.5453;
  return (v - floorf(v)) - 0.5f;
}

// The jittered light target of soft-shadow sample k (_jitter_constants:
// the per-sample offsets in float64, rounded to f32 once).
__device__ __forceinline__ V3 jitter_target(const float* P,
                                            const LightConsts& K, float ux,
                                            float uy, int k) {
  const float c1 = (float)(0.17 * (double)k + 0.05);
  const float c2 = (float)(0.29 * (double)k + 0.11);
  const float c3 = (float)(0.41 * (double)k + 0.23);
  return {P[P_LIGHT] + jitter1(ux, uy, K.base, c1) * K.rad2,
          P[P_LIGHT + 1] + jitter1(ux, uy, K.base, c2) * K.rad2,
          P[P_LIGHT + 2] + jitter1(ux, uy, K.base, c3) * K.rad2};
}

// A node of the GI tree: a surface point on a cell (the primary hit, or a
// slot's entry point on its neighbour cell), the cell's centre and its
// integer coordinates (the hit's cell, or the slot's clamped n_cl).
struct Node {
  V3 point, origin;
  int cx, cy, cz;
};

__device__ __forceinline__ Node hit_node(const Hit& h) {
  return {h.q, h.origin, h.cx, h.cy, h.cz};
}

// render_slab.py _slot_geometry: GI neighbour slot `slot` of a node's face
// (face_index of its face normal): the clamped neighbour cell n_cl, its
// centre, where the ray from the node's point along the (unnormalised)
// offset enters its visible cube, and whether it does where `active`.
struct Slot {
  int nx, ny, nz;  // n_cl
  int ux, uy, uz;  // the neighbour cell unclamped (its centre's)
  V3 origin, point;
  bool ok;
};

__device__ __forceinline__ Slot node_slot(const LightConsts& K, const Node& p, bool active,
                                          int face, int slot) {
  int ox, oy, oz;
  layer_offset(face, slot, ox, oy, oz);
  const int ncx = p.cx + ox, ncy = p.cy + oy, ncz = p.cz + oz;
  Slot s;
  s.nx = max(ncx, 0);
  s.ny = max(ncy, 0);
  s.nz = max(ncz, 0);
  s.ux = ncx;
  s.uy = ncy;
  s.uz = ncz;
  s.origin = cell_origin(K, ncx, ncy, ncz);
  const V3 dir{(float)ox, (float)oy, (float)oz};
  float tn, tf;
  ray_cube_intersect(p.point, dir, s.origin, K.vis_half, tn, tf);
  s.ok = active && tn <= tf && tf >= 0.0f;
  s.point = {p.point.x + dir.x * tn, p.point.y + dir.y * tn, p.point.z + dir.z * tn};
  return s;
}

// The slot of the primary hit's face (active where the pixel hit).
__device__ __forceinline__ Slot slot_geometry(const LightConsts& K,
                                              const Hit& h, int face,
                                              int slot) {
  return node_slot(K, hit_node(h), h.found, face, slot);
}

__device__ __forceinline__ Node slot_node(const Slot& s) {
  return {s.point, s.origin, s.nx, s.ny, s.nz};
}

// The GI rows of a frame with b bounces: level k (1..b) holds 4^k slots,
// the children of level k-1's slot p at 4 p .. 4 p + 3, its rows from
// gi_level_start(k) on (render_slab.py Lighting.level_span).
constexpr int kMaxBounces = 4;
__host__ __device__ constexpr int gi_level_start(int k) {
  return ((1 << (2 * k)) - 4) / 3;
}
__host__ __device__ constexpr int gi_rows(int bounces) {
  return gi_level_start(bounces + 1);
}

// brdf.py calculate_lighting_at: the rendering-equation light at surface
// point p of the cell centred at co with integer coordinates (cx, cy) (the
// rainbow albedo), seen from eye, lit with radiance inc from lpos.
__device__ __forceinline__ V3 lighting_at(const LightConsts& K, V3 p, V3 co,
                                          int cx, int cy, V3 eye, V3 inc,
                                          V3 lpos) {
  constexpr float kPi = (float)3.14159265359;
  const V3 nrm = cube_face_normal(p, co);
  V3 alb;
  if (K.mat[0] != 0.0f || K.mat[1] != 0.0f || K.mat[2] != 0.0f) {
    alb = {K.mat[0], K.mat[1], K.mat[2]};
  } else {
    const float c0 = (float)cx / K.fn;
    const float c1 = (float)cy / K.fn;
    alb = {c0, c1, 1.0f - c0};
  }
  const V3 view = normalize(eye - p);
  const V3 ld = normalize(lpos - p);
  // surface_brdf
  const V3 half = normalize(ld + view);
  const float noh = dot3(nrm, half);
  const float f = noh * noh * K.a2m1 + 1.0f;
  const float dterm = K.a2 / (f * kPi * f);
  const float nov = clamp_min0(dot3(nrm, view));
  const float nol_c = clamp_min0(dot3(nrm, ld));
  const float g = (nov / (nov * K.omk + K.kd)) * (nol_c / (nol_c * K.omk + K.kd));
  const float p1 = 1.0f - dot3(half, view);
  const float p2 = p1 * p1;
  const float p5 = p1 * (p2 * p2);  // lax.integer_pow(x, 5) order
  const float denom = 4.0f * dot3(view, nrm) * dot3(ld, nrm);
  const float dg = dterm * g;
  const float dln = dot3(ld, nrm);
  const float fr = K.refl[0] + K.omrefl[0] * p5;
  const float fg = K.refl[1] + K.omrefl[1] * p5;
  const float fb = K.refl[2] + K.omrefl[2] * p5;
  const float br = alb.x / kPi + dg * fr / denom;
  const float bg = alb.y / kPi + dg * fg / denom;
  const float bb = alb.z / kPi + dg * fb / denom;
  return {clamp_min0(br * inc.x * dln), clamp_min0(bg * inc.y * dln),
          clamp_min0(bb * inc.z * dln)};
}

// The light-source cube (wgsl:866-874; renderer_fast.py _ext_frame and K1's
// composition): whether the ray o + t d meets the cube of half size 0.005
// at the light.
__device__ __forceinline__ bool light_cube_hit(const float* P, V3 o, V3 d) {
  const float lrad = (float)0.005;
  const V3 c{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]};
  float tn, tf;
  ray_cube_intersect(o, d, c, lrad, tn, tf);
  return tn <= tf && tf >= 0.0f;
}

// torch.pow(x, e) for a float tensor and a Python exponent: torch takes
// its fast forms for the exponents 0.5, 2 and 3 (sqrt, x * x, x * x * x),
// powf otherwise; 1 copies.
__device__ __forceinline__ float torch_pow(float x, float e) {
  if (e == 1.0f) return x;
  if (e == 0.5f) return sqrtf(x);
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return x * x * x;
  return powf(x, e);
}

// ------------------------------------------ the lighting kernels' tiles ---
// A block of the tiled lighting kernels (the shade kernel's GI tree, the
// queries kernel's one- and two-query forms) takes a tile of consecutive
// pixels of the frame.  The tile's hits, and below them the live nodes of
// its GI tree, are compacted in shared memory (block_scan, TileNodes,
// expand_level), so that the per-hit and per-slot work runs one item a
// lane, whatever share of the tile's pixels hit and of their slots live; no
// list leaves the block, so no counter needs a reset and no sum an atomic.

// The block's exclusive prefix sum of v in thread order, and its total
// (`total`, the same on every thread): each warp's by shuffles, the warps'
// through `sums` (THREADS / 32 ints of shared memory).  Every thread calls
// it; it holds two barriers, the last after its reads of `sums`.
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  total = all;
  return before + x - v;
}

// A warp's items, one a lane: lane L's live slots (the bits of `live`) are
// items first .. first + popc(live) - 1 (`first` its exclusive prefix over
// the lanes).  Item k's lane and slot; every lane calls it.
__device__ __forceinline__ void warp_item(int k, int first, uint32_t live, int& lane,
                                          int& slot) {
  int o = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int e = __shfl_sync(0xffffffffu, first, (o + step) & 31);
    if (o + step < 32 && e <= k) o += step;
  }
  const int r = k - __shfl_sync(0xffffffffu, first, o);
  uint32_t bits = __shfl_sync(0xffffffffu, live, o);
  for (int i = 0; i < r; ++i) bits &= bits - 1;
  lane = o;
  slot = __ffs(bits) - 1;
}

// The exclusive prefix sum of `count` over the warp's lanes, and its total.
__device__ __forceinline__ int warp_scan(int count, int& total) {
  const int lane = threadIdx.x & 31;
  int x = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  total = __shfl_sync(0xffffffffu, x, 31);
  return x - count;
}

// A tile's compacted hits (nodes 0 .. nh - 1), then the live nodes of a
// chunk of them, level after level, in shared memory: structures of arrays.
// A node is a surface point on a cell (the hit's, or a live GI slot's entry
// point on its neighbour): its cell unclamped (the centre's coordinates; the
// cell, n_cl, clamped at 0), its pixel, its index s in its level (the GI row
// gi_level_start(k) + s), its parent and its live slots' range [cs, ce).
template <int CAP>
struct TileNodes {
  float x[CAP], y[CAP], z[CAP];
  int16_t cx[CAP], cy[CAP], cz[CAP];
  uint16_t lp[CAP], s[CAP], parent[CAP], cs[CAP], ce[CAP];
  uint8_t face[CAP];

  __device__ __forceinline__ V3 point(int i) const { return {x[i], y[i], z[i]}; }
  __device__ __forceinline__ Node node(const LightConsts& K, int i) const {
    const int ux = cx[i], uy = cy[i], uz = cz[i];
    return {point(i), cell_origin(K, ux, uy, uz), max(ux, 0), max(uy, 0), max(uz, 0)};
  }
  // Node i is the hit of tile pixel `pixel` (hit_geometry's q and cell).
  __device__ __forceinline__ void set_hit(int i, const Hit& h, int pixel) {
    x[i] = h.q.x, y[i] = h.q.y, z[i] = h.q.z;
    cx[i] = (int16_t)h.cx, cy[i] = (int16_t)h.cy, cz[i] = (int16_t)h.cz;
    lp[i] = (uint16_t)pixel;
    s[i] = 0;
    face[i] = (uint8_t)face_index(cube_face_normal(h.q, h.origin));
  }
};

// Level k of the GI tree below the live nodes [a, b) of level k - 1 (the
// hits for k = 1), one slot a thread, each node's 4 slots in parent order.
// A slot is live where K3 found its neighbour alive (states row
// gi_level_start(k) + s) and its entry exists (node_slot's ok at a live
// parent): _slot_tree's ok.  The live slots are appended at `end` in that
// order and each parent's [cs, ce) is set; `with_face`: their faces too (for
// their own slots).  Returns false, having appended nothing, where they
// would pass CAP (the same on every thread).  Every thread calls it; it ends
// with a barrier.
template <int THREADS, int CAP>
__device__ bool expand_level(TileNodes<CAP>& T, const LightConsts& K,
                             const uint8_t* __restrict__ states, int npix, int tile, int k,
                             int a, int b, bool with_face, int& end, int* sums) {
  const int m = (b - a) * 4;
  int base = end;
  for (int r = 0; r < m; r += THREADS) {
    const int c = r + (int)threadIdx.x;
    int par = a, j = 0, s = 0;
    Slot sl;
    sl.ok = false;
    if (c < m) {
      par = a + (c >> 2);
      j = c & 3;
      s = k == 1 ? j : 4 * T.s[par] + j;
      if (states[(size_t)(gi_level_start(k) + s) * npix + tile + T.lp[par]] == 1) {
        sl = node_slot(K, T.node(K, par), true, T.face[par], j);
      }
    }
    int total;
    const int off = block_scan<THREADS>(sl.ok ? 1 : 0, sums, total);
    if (base + total > CAP) return false;
    if (c < m) {
      const int i = base + off;
      if (sl.ok) {
        T.x[i] = sl.point.x, T.y[i] = sl.point.y, T.z[i] = sl.point.z;
        T.cx[i] = (int16_t)sl.ux, T.cy[i] = (int16_t)sl.uy, T.cz[i] = (int16_t)sl.uz;
        T.lp[i] = T.lp[par];
        T.s[i] = (uint16_t)s;
        T.parent[i] = (uint16_t)par;
        if (with_face) T.face[i] = (uint8_t)face_index(cube_face_normal(sl.point, sl.origin));
      }
      if (j == 0) T.cs[par] = (uint16_t)i;
      if (j == 3) T.ce[par] = (uint16_t)(i + (sl.ok ? 1 : 0));
    }
    base += total;
  }
  __syncthreads();
  end = base;
  return true;
}

}  // namespace ca3d
