// The occlusion queries of an extended-lighting frame: one launch writes
// every operand that the frame's occlusion kernel (K2, or K5 through
// queries.cuh) and its neighbour lookups (K3) read.
//
// Replaces: the XLA geometry of cellularautomatons3d_tpu/render/
// render_slab.py lighting_passes (:1431; the hit geometry of hit_geometry
// :1661, the soft-shadow jitter of soft_shadow_jitter :1221, the GI slots'
// geometry) and the per-level geometry of the GI recursion indirect_bounce
// (:1308), which JAX fuses under jit.  The port's torch twin, render_slab.py
// lighting_queries_stacked (_hit_geometry, lighting_queries,
// stack_occlusion_queries), runs it as ~200 eager launches and a cat.
//
// It writes K2's active masks [nq, H, W] on every pixel and its stacked
// operands [nq, 3, H, W] (start, target, excluded cell) on the active lanes
// only: K2, K5 and K3 read a lane's operands only where its mask is set, so
// the other lanes are left as the caller allocated them (torch.empty).  A
// miss writes its nq zero masks and nothing else.  From the primary hit's
// id and t (K1's depth or K4's t) and the camera it forms the ray, the hit
// point q, the cell and its centre (shading.cuh hit_geometry), then:
//   * n_soft direct-shadow queries from q, excluding the hit cell, active
//     on hits: toward the light (jitter mode 0, the hard shadow), toward
//     jittered sample k = the query's index (mode 1), or toward the one
//     rotating sample jitter_k of the temporal mode (mode 2);
//   * n_slots GI slots (4, or the temporal mode's one slot gi_slot): from
//     the slot's entry point n_point toward the light, excluding the clamped
//     neighbour cell n_cl, active where the entry exists (ok_geo).
// Two forms, each the faster on its queries (PERF.md).  Full quality's 8
// queries a hit run a thread a pixel: a frame's hits cluster, so most warps
// have every lane or none hit, and compacting them gains less than its
// barriers cost.  One or two queries a hit (the hard shadow of the sliced
// frames, gi_temporal) run tiled (queries_tile): 128 threads take 512
// pixels, 4 a thread, the ids and t as 16-byte loads, the masks as 4-pixel
// words; the tile's hits are compacted by a block scan (shading.cuh
// block_scan), their geometry taken one a thread, and their queries one a
// thread in query order, the slots' masks gathered in a bitmap in shared
// memory; a miss computes no geometry.
// K3 reads the slots' cells and masks in place, as [3, H, W] slices of the
// excluded cells and the masks.  A temporal index the caller holds on the
// card (sample_k, sample_slot: int64 scalars) is read here, never on the
// host.  Every float expression is the twin's, in its order.
// The level mode (lighting_level_kernel, ca3d_lighting_level) writes the rows
// of one deeper level of a multi-bounce frame's GI tree (JAX's
// indirect_bounce recursion, render_slab.py:1308), a thread a pixel (two
// compacted forms measured slower, PERF.md): from the hit it walks the levels
// above, each slot active where its parent is, its entry exists and K3 found
// its neighbour alive (the states of those levels, K3's output), and writes
// for each slot of the level the query from its entry point toward the light
// excluding its clamped neighbour cell, active where its parent is and its
// entry exists (the cell doubles as K3's lookup).  It also gates the level
// above's masks by their states, so K2 traces no lane of theirs whose
// neighbour is dead (the last level's stay ungated: nothing reads their
// flags, and a gate would walk the whole tree again).
// Bound: bytes.  It reads 8 B a pixel and writes 1 B a query (the mask) and
// 36 B an active lane: 16 B a pixel for full quality's 8 queries plus 36 B
// on each active lane, whose count is the frame's (about 6 % of a 1080p
// frame's pixels hit at 256^3, gen-80).  The arithmetic, on hit pixels
// only, is ~100-250 flops a query and 3 double-precision sines a jittered
// sample.  At 1080p on an H100 the per-pixel form runs 2.3x its bound (full
// quality: the sines of its dense warps), the tiled form 1.8-2.4x, the level
// launch 4.9x (PERF.md).  Registers (ptxas, sm_90a): 48 per pixel, 52 tiled
// (each with the 40-byte stack frame of sin's slow path), the level mode 46 /
// 64 / 64; no spill.

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "shading.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 256;       // a thread a pixel
constexpr int kMaxQueries = 65535;  // K2's limit (gridDim.z)
// The tiled form: 128 threads, 4 pixels a thread.
constexpr int kTileThreads = 128;
constexpr int kTilePx = 4;
constexpr int kTile = kTileThreads * kTilePx;

struct QueryArgs {
  Cam cam;
  LightConsts k;
  int n, width, height;
  int n_soft, jitter_mode, jitter_k, n_slots, gi_slot;
  bool vec;  // the quads load and store whole (shading.cuh quads_aligned)
};

// The ids and t of a thread's pixels p0 .. p0 + 3 (id -1 beyond the frame):
// 16-byte loads when vec.
__device__ __forceinline__ void load_quad(const int* __restrict__ idx,
                                          const float* __restrict__ t, int p0, int npix,
                                          bool vec, int (&id)[kTilePx], float (&tt)[kTilePx]) {
  if (vec && p0 < npix) {
    const int4 a = *reinterpret_cast<const int4*>(idx + p0);
    const float4 b = *reinterpret_cast<const float4*>(t + p0);
    id[0] = a.x, id[1] = a.y, id[2] = a.z, id[3] = a.w;
    tt[0] = b.x, tt[1] = b.y, tt[2] = b.z, tt[3] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kTilePx; ++i) {
    const bool in = p0 + i < npix;
    id[i] = in ? idx[p0 + i] : -1;
    tt[i] = in ? t[p0 + i] : 0.0f;
  }
}

// Mask bytes (0 or 1) of a thread's 4 pixels p0 .. p0 + 3 in `row` from
// bits 0..3 of `bits`: one 4-byte word when vec.
__device__ __forceinline__ void store_mask_quad(uint8_t* __restrict__ row, int p0, int npix,
                                                bool vec, uint32_t bits) {
  if (vec && p0 < npix) {
    *reinterpret_cast<uint32_t*>(row + p0) = (bits & 1u) | (bits >> 1 & 1u) << 8 |
                                             (bits >> 2 & 1u) << 16 | (bits >> 3 & 1u) << 24;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p0 + i < npix) row[p0 + i] = (uint8_t)(bits >> i & 1u);
  }
}

// Whether a frame of npix pixels loads and stores whole 4-pixel quads:
// npix a multiple of 4 and every pointer (null or) 16-byte aligned.
__host__ inline bool quads_aligned(int npix, std::initializer_list<const void*> ptrs) {
  if (npix % 4 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// A query's operands on lane `pix` of row q: start, target, excluded cell.
struct QueryOut {
  float* start;
  float* target;
  int* excl;
  __device__ __forceinline__ void put(int q, int npix, int pix, V3 s, V3 g, int ex, int ey,
                                      int ez) const {
    const size_t b = (size_t)3 * q * npix + pix;
    start[b] = s.x;
    start[b + npix] = s.y;
    start[b + 2 * (size_t)npix] = s.z;
    target[b] = g.x;
    target[b + npix] = g.y;
    target[b + 2 * (size_t)npix] = g.z;
    excl[b] = ex;
    excl[b + npix] = ey;
    excl[b + 2 * (size_t)npix] = ez;
  }
};

// Rows of mask bits of a tile, one bit a pixel.
constexpr int kMaskWords = kTile / 32;

__device__ __forceinline__ void set_mask_bit(uint32_t* row, int lp) {
  atomicOr(&row[lp >> 5], 1u << (lp & 31));
}

// The thread's pixels' bits in a mask row.
__device__ __forceinline__ uint32_t quad_bits(const uint32_t* row, int q0) {
  return row[q0 >> 5] >> (q0 & 31) & ((1u << kTilePx) - 1u);
}

struct QueryTile {
  TileNodes<kTile> T;
  int id[kTile];
  float t[kTile];
  uint32_t slot_mask[4][kMaskWords];
  int sums[kTileThreads / 32];
};

// A thread a pixel: full quality's 8 queries a hit.
__device__ __forceinline__ void queries_pixel(const QueryArgs& a, const int* __restrict__ idx,
                                              const float* __restrict__ t,
                                              const int64_t* __restrict__ sample_k,
                                              const int64_t* __restrict__ sample_slot,
                                              const QueryOut& o, uint8_t* __restrict__ active) {
  const int npix = a.width * a.height;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int px = pix % a.width, py = pix / a.width;
  const float* P = a.cam.p;
  const Hit h = hit_geometry(P, a.k, a.n, px, py, idx[pix], t[pix]);
  const V3 light{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]};
  const int nq = a.n_soft + a.n_slots;
  if (!h.found) {
    for (int q = 0; q < nq; ++q) active[(size_t)q * npix + pix] = 0;
    return;
  }
  auto put = [&](int q, V3 s, V3 g, int ex, int ey, int ez, bool on) {
    active[(size_t)q * npix + pix] = on;
    if (on) o.put(q, npix, pix, s, g, ex, ey, ez);
  };
  const int jk = sample_k != nullptr ? (int)*sample_k : a.jitter_k;
  for (int s = 0; s < a.n_soft; ++s) {
    const V3 g = a.jitter_mode == 0 ? light
                                    : jitter_target(P, a.k, h.ux, h.uy,
                                                    a.jitter_mode == 1 ? s : jk);
    put(s, h.q, g, h.cx, h.cy, h.cz, true);
  }
  if (a.n_slots == 0) return;
  const int face = face_index(cube_face_normal(h.q, h.origin));
  const int gs = sample_slot != nullptr ? (int)*sample_slot : a.gi_slot;
  for (int i = 0; i < a.n_slots; ++i) {
    const Slot sl = slot_geometry(a.k, h, face, a.n_slots == 4 ? i : gs);
    put(a.n_soft + i, sl.point, light, sl.nx, sl.ny, sl.nz, sl.ok);
  }
}

// The tiled form (one or two queries a hit: the hard shadow, gi_temporal):
// 4 pixels a thread, the tile's hits compacted and their queries one a
// thread in query order, the masks 4-pixel words.
__device__ __forceinline__ void queries_tile(const QueryArgs& a, const int* __restrict__ idx,
                                             const float* __restrict__ t,
                                             const int64_t* __restrict__ sample_k,
                                             const int64_t* __restrict__ sample_slot,
                                             const QueryOut& o, uint8_t* __restrict__ active) {
  __shared__ QueryTile S;
  const int npix = a.width * a.height;
  const int tile = blockIdx.x * kTile;
  const int q0 = kTilePx * threadIdx.x;
  const int p0 = tile + q0;
  const float* P = a.cam.p;
  const LightConsts& K = a.k;
  for (int w = threadIdx.x; w < 4 * kMaskWords; w += kTileThreads) (&S.slot_mask[0][0])[w] = 0;
  // The tile's pixels: the thread's ids and t, its hits compacted (the
  // tile's first nh nodes) and their geometry, one a thread.
  int id[kTilePx];
  float tt[kTilePx];
  load_quad(idx, t, p0, npix, a.vec, id, tt);
  uint32_t found = 0;
#pragma unroll
  for (int i = 0; i < kTilePx; ++i) {
    S.id[q0 + i] = id[i];
    S.t[q0 + i] = tt[i];
    found |= (uint32_t)(id[i] >= 0) << i;
  }
  int nh;
  const int hb = block_scan<kTileThreads>(__popc(found), S.sums, nh);
  for (int i = 0, h = hb; i < kTilePx; ++i) {
    if (found >> i & 1u) S.T.lp[h++] = (uint16_t)(q0 + i);
  }
  __syncthreads();
  for (int h = threadIdx.x; h < nh; h += kTileThreads) {
    const int lp = S.T.lp[h], pix = tile + lp;
    S.T.set_hit(h, hit_geometry(P, K, a.n, pix % a.width, pix / a.width, S.id[lp], S.t[lp]),
                lp);
  }
  __syncthreads();
  // The direct-shadow queries' masks: the hits.
  for (int s = 0; s < a.n_soft; ++s) {
    store_mask_quad(active + (size_t)s * npix, p0, npix, a.vec, found);
  }

  // The queries of the hits, one (query, hit) a thread in query order.
  const V3 light{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]};
  const int jk = sample_k != nullptr ? (int)*sample_k : a.jitter_k;
  const int gs = sample_slot != nullptr ? (int)*sample_slot : a.gi_slot;
  const int nq = a.n_soft + a.n_slots;
  for (int g = threadIdx.x; g < nq * nh; g += kTileThreads) {
    const int q = g / nh, h = g - q * nh;
    const int lp = S.T.lp[h], pix = tile + lp;
    const Node hn = S.T.node(K, h);
    if (q < a.n_soft) {
      V3 target = light;
      if (a.jitter_mode != 0) {
        // The window's uvs, as camera_ray and hit_geometry take them.
        const int px = pix % a.width, py = pix / a.width;
        const float ux = ((float)px + 0.5f) / P[P_WIN];
        const float uy = 1.0f - ((float)py + P[P_ROW0] + 0.5f) / P[P_WIN + 1];
        target = jitter_target(P, K, ux, uy, a.jitter_mode == 1 ? q : jk);
      }
      o.put(q, npix, pix, hn.point, target, hn.cx, hn.cy, hn.cz);
    } else {
      const int i = q - a.n_soft;
      const Slot sl = node_slot(K, hn, true, S.T.face[h], a.n_slots == 4 ? i : gs);
      if (sl.ok) {
        set_mask_bit(S.slot_mask[i], lp);
        o.put(q, npix, pix, sl.point, light, sl.nx, sl.ny, sl.nz);
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < a.n_slots; ++i) {
    store_mask_quad(active + (size_t)(a.n_soft + i) * npix, p0, npix, a.vec,
                    quad_bits(S.slot_mask[i], q0));
  }
}

template <bool TILE>
__global__ void __launch_bounds__(TILE ? kTileThreads : kThreads)
    lighting_queries_kernel(const QueryArgs a, const int* __restrict__ idx,
                            const float* __restrict__ t,
                            const int64_t* __restrict__ sample_k,
                            const int64_t* __restrict__ sample_slot, const QueryOut o,
                            uint8_t* __restrict__ active) {
  if constexpr (TILE) {
    queries_tile(a, idx, t, sample_k, sample_slot, o, active);
  } else {
    queries_pixel(a, idx, t, sample_k, sample_slot, o, active);
  }
}

struct LevelArgs {
  Cam cam;
  LightConsts k;
  int n, width, height;
  int n_soft, bounces, level;
};

struct LevelOut {
  const uint8_t* states;  // [gi_rows, H, W]
  float* start;
  float* target;
  int* excl;
  uint8_t* active;
};

// Visit a node of the GI tree at level k with index s (ok: its slot is
// active, its entry exists and its neighbour lives), D levels above the
// parents of the launch's level.  D = 0: the node is such a parent; its mask
// is gated to ok and its 4 children's rows are written.
template <int D>
struct LevelWalk {
  __device__ static void visit(const LevelArgs& a, const LevelOut& o, int pix, int npix,
                               V3 light, const Node& node, bool ok, int k, int s) {
    const int face = ok ? face_index(cube_face_normal(node.point, node.origin)) : 0;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      Slot c{};
      if (ok) c = node_slot(a.k, node, true, face, j);
      else c.ok = false;
      const int cs = 4 * s + j;
      const bool c_ok =
          c.ok && o.states[(size_t)(gi_level_start(k + 1) + cs) * npix + pix] == 1;
      LevelWalk<D - 1>::visit(a, o, pix, npix, light, slot_node(c), c_ok, k + 1, cs);
    }
  }
};

template <>
struct LevelWalk<0> {
  __device__ static void visit(const LevelArgs& a, const LevelOut& o, int pix, int npix,
                               V3 light, const Node& node, bool ok, int k, int s) {
    o.active[(size_t)(a.n_soft + gi_level_start(k) + s) * npix + pix] = ok;
    const int face = ok ? face_index(cube_face_normal(node.point, node.origin)) : 0;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const int q = a.n_soft + gi_level_start(k + 1) + 4 * s + j;
      Slot c{};
      if (ok) c = node_slot(a.k, node, true, face, j);
      else c.ok = false;
      o.active[(size_t)q * npix + pix] = c.ok;
      if (!c.ok) continue;
      const size_t b = (size_t)3 * q * npix + pix;
      o.start[b] = c.point.x;
      o.start[b + npix] = c.point.y;
      o.start[b + 2 * (size_t)npix] = c.point.z;
      o.target[b] = light.x;
      o.target[b + npix] = light.y;
      o.target[b + 2 * (size_t)npix] = light.z;
      o.excl[b] = c.nx;
      o.excl[b + npix] = c.ny;
      o.excl[b + 2 * (size_t)npix] = c.nz;
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    lighting_level_kernel(const LevelArgs a, const int* __restrict__ idx,
                          const float* __restrict__ t, const LevelOut o) {
  const int npix = a.width * a.height;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int id = idx[pix];
  if (id < 0) {
    // A miss: no slot of the two levels is active.
    const int g0 = gi_level_start(a.level - 1), g2 = gi_level_start(a.level + 1);
    for (int r = g0; r < g2; ++r) o.active[(size_t)(a.n_soft + r) * npix + pix] = 0;
    return;
  }
  const float* P = a.cam.p;
  const Hit h = hit_geometry(P, a.k, a.n, pix % a.width, pix / a.width, id, t[pix]);
  const V3 light{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]};
  LevelWalk<D>::visit(a, o, pix, npix, light, hit_node(h), true, 0, 0);
}

using LevelKernel = decltype(&lighting_level_kernel<1>);

}  // namespace

extern "C" {

// cam: host float[40]; consts: host float[24] (shading.cuh LightConsts);
// idx: int32[H, W] primary hit ids (-1 = miss); t: float[H, W] their t (a
// miss's value enters q only).  n_soft direct-shadow queries of jitter_mode
// 0 (hard), 1 (sample = query index) or 2 (sample jitter_k, or *sample_k
// when given), then n_slots (0, 1 or 4) GI slots (slot i of 4, or gi_slot,
// or *sample_slot when given).  Outputs, nq = n_soft + n_slots: active
// uint8[nq, H, W], every element written; start and target float[nq, 3, H,
// W] and excl int32[nq, 3, H, W], written on the active lanes only.
// Returns the launch's cudaError_t.
int ca3d_lighting_queries(int device, const float* cam, const float* consts, int n,
                          int width, int height, int n_soft, int jitter_mode,
                          int jitter_k, int n_slots, int gi_slot, const void* sample_k,
                          const void* sample_slot, const void* idx, const void* t,
                          void* start, void* target, void* excl, void* active,
                          void* stream) {
  const int nq = n_soft + n_slots;
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 || n_soft < 0 ||
      (n_slots != 0 && n_slots != 1 && n_slots != 4) || nq < 1 || nq > kMaxQueries ||
      jitter_mode < 0 || jitter_mode > 2 || (jitter_mode == 2 && n_soft != 1) ||
      gi_slot < 0 || gi_slot > 3 || (long long)width * height > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  QueryArgs a;
  for (int i = 0; i < P_LEN; ++i) a.cam.p[i] = cam[i];
  a.k = *reinterpret_cast<const LightConsts*>(consts);
  a.n = n;
  a.width = width;
  a.height = height;
  a.n_soft = n_soft;
  a.jitter_mode = jitter_mode;
  a.jitter_k = jitter_k;
  a.n_slots = n_slots;
  a.gi_slot = gi_slot;
  const int npix = width * height;
  a.vec = quads_aligned(npix, {idx, t, active});
  const QueryOut o{static_cast<float*>(start), static_cast<float*>(target),
                   static_cast<int*>(excl)};
  const auto* id = static_cast<const int*>(idx);
  const auto* tt = static_cast<const float*>(t);
  const auto* sk = static_cast<const int64_t*>(sample_k);
  const auto* ss = static_cast<const int64_t*>(sample_slot);
  auto* act = static_cast<uint8_t*>(active);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // One or two queries a hit take the tiled form, more the per-pixel one
  // (each the faster on its forms, PERF.md).
  if (nq <= 2) {
    lighting_queries_kernel<true><<<(npix + kTile - 1) / kTile, kTileThreads, 0, st>>>(
        a, id, tt, sk, ss, o, act);
  } else {
    lighting_queries_kernel<false><<<(npix + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        a, id, tt, sk, ss, o, act);
  }
  return cudaGetLastError();
}

// The level mode: cam, consts, n, width, height, idx and t as above; the
// frame has n_soft direct-shadow rows, then gi_rows(bounces) GI rows
// (shading.cuh gi_level_start), bounces in [2, kMaxBounces], level in [2,
// bounces].  It writes level `level`'s masks on every pixel and its operands
// on the active lanes, reading states uint8[gi_rows, H, W] (K3's output) of
// the levels above, and gates level `level` - 1's masks by their states.
// start, target float[nq, 3, H,
// W], excl int32[nq, 3, H, W] and active uint8[nq, H, W], nq = n_soft +
// gi_rows(bounces), are the first launch's buffers.  Returns the launch's
// cudaError_t.
int ca3d_lighting_level(int device, const float* cam, const float* consts, int n, int width,
                        int height, int n_soft, int bounces, int level, const void* idx,
                        const void* t, const void* states, void* start, void* target,
                        void* excl, void* active, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 || n_soft < 0 ||
      bounces < 2 || bounces > kMaxBounces || level < 2 || level > bounces ||
      n_soft + gi_rows(bounces) > kMaxQueries || (long long)width * height > INT32_MAX ||
      states == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  LevelArgs a;
  for (int i = 0; i < P_LEN; ++i) a.cam.p[i] = cam[i];
  a.k = *reinterpret_cast<const LightConsts*>(consts);
  a.n = n;
  a.width = width;
  a.height = height;
  a.n_soft = n_soft;
  a.bounces = bounces;
  a.level = level;
  const LevelOut o{static_cast<const uint8_t*>(states), static_cast<float*>(start),
                   static_cast<float*>(target), static_cast<int*>(excl),
                   static_cast<uint8_t*>(active)};
  // The walk's depth from the hit to the parents of `level`.
  static_assert(kMaxBounces == 4, "one instantiation per walk depth");
  const LevelKernel kKernels[] = {lighting_level_kernel<1>, lighting_level_kernel<2>,
                                  lighting_level_kernel<3>};
  const int npix = width * height;
  kKernels[level - 2]<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(idx), static_cast<const float*>(t), o);
  return cudaGetLastError();
}

}  // extern "C"
