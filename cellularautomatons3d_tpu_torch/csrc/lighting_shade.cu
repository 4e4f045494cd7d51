// The shading of an extended-lighting frame: one launch takes the frame's
// occlusion flags (K2 or K5) and neighbour states (K3) to its light, and in
// the fused loop to its presentation and new history.
//
// Replaces: the XLA shading of cellularautomatons3d_tpu/render/
// render_slab.py lighting_passes (:1431; the occlusion quotient and the
// one-bounce double BRDF of brdf.py :32-109), raytrace_sliced's direct light
// and composition (:1714), renderer_fast.py's lighting on K1's frame
// (:84-206), the fused loop's frame composition _ext_frame_blocked (:318)
// and the GI recursion indirect_bounce (:1308), which JAX fuses under jit.
// The port's torch twin, render_slab.py lighting_shade, runs a full-quality
// frame's as ~1,000 eager launches.
//
// Each step is the twin's, in its order (shading.cuh), a thread a pixel:
//   * the pixel's loads first, before any geometry: its id and t and the
//     direct shadow's flags, then on hits the slots' states and flags (and
//     the age); K1's rgb and the history follow the GI;
//   * the hit geometry from the id, t and camera (hit_geometry), and at once
//     what the frame's tail needs of the ray (the light cube on it, the
//     overlay's half, the volume's exit), so that the ray is not live
//     across the GI;
//   * the soft occlusion quotient: the samples' quotients (0.0095 where
//     occluded, else 1) summed from 0 in order, then one IEEE division by
//     occ_div (soft_k, or 1 in the temporal mode);
//   * the GI, each slot's reflected = quotient * shade(n_point, ...) +
//     emissive and bounce = shade(q, ..., reflected, n_point), added where
//     the slot's entry exists and its neighbour is alive (live; the twin's
//     where(ok, bounce, 0): elsewhere it adds 0, which changes no sum from
//     +0), summed from 0 in slot order.  One bounce, 4 slots: each lane
//     finds its live slots, and the warp's live slots run one a lane
//     (shading.cuh warp_scan, warp_item: a lane's hit read from shared
//     memory, the bounces summed back on its lane in slot order), so a warp
//     runs ceil(live / 32) rounds of BRDFs, not the union of its lanes'
//     slots.  The temporal mode's one slot (then x4) runs on its lane.  B >
//     1 bounces, the tree of JAX's indirect_bounce recursion
//     (render_slab.py:1308), on the block's pixels as a tile (shade_tree):
//     the tile's hits are compacted by a block scan (shading.cuh
//     block_scan), their geometry taken one a thread; then, a chunk of hits
//     at a time, the tree's levels top down, one slot a thread (shading.cuh
//     expand_level: a slot lives where its entry exists and K3 found its
//     neighbour alive), each level's live slots compacted after the last in
//     shared memory; then bottom up, one live slot a thread, as the twin's
//     _gi_light: reflected = quotient * shade(point, ..., parent point) +
//     emissive plus its own live slots' bounces summed from 0 in slot
//     order, then its bounce shade(parent point, ..., viewer, reflected,
//     point) (the viewer: the camera at level 1, else the grandparent's
//     point); a hit's GI is its live slots' bounces summed from 0 in slot
//     order.  The levels roll, their bounds in shared memory, so the
//     registers do not grow with B; a chunk is as many hits as the node
//     store holds with their live slots (where a level would pass it, the
//     chunk halves and starts again; one hit's 341-node tree fits at four
//     bounces);
//   * K1's frame (SLICED = 0): K1's unshadowed, age-faded rgb times the
//     quotient, plus the GI where the pixel hit; with COMPOSE the id-checked
//     EMA against the f32 history, the light cube on black pixels, the new
//     history, the depth overlay and gamma (K1's composition);
//   * the sliced frame (SLICED = 1): the direct light clamp(shade(q, origin,
//     coords, o, lmag, light), 0) times the quotient and the age fade (occl *
//     fade, then shaded * occl), plus the GI, black on misses, and the
//     depth: t on hits, the volume's exit (hit_geometry's miss depth)
//     elsewhere;
//   * the emissive light on hits.
// Every min, max and clamp propagates NaN, so a 0/0 of the BRDF comes out
// NaN where the twin's does.
// Bound: bytes.  On every pixel it reads the id and t (8 B), the direct
// shadow's flags (4 B a sample) and K1's rgb (12 B), and writes the light
// (12 B) and the new history (12 B) or the depth (4 B); the slots' states
// and flags, the age and the history's id and colour it reads on hit pixels
// only: ~60 B a pixel at full quality in the fused loop (~0.04 ms at 1080p
// on 3.35 TB/s).  The arithmetic (two BRDF evaluations a live slot, ~280
// flops with 46 divisions and 8 square roots, IEEE) runs on hits only, a
// few percent of a 1080p frame's pixels; what holds the one-bounce forms
// from their bound is the latency of a hit warp's BRDF chain and the bytes a
// pass keeps in flight (2.2-3.2x the bound at 1080p on an H100; the trees,
// whose deeper levels' states and flags are read on live slots only,
// 4.8-6.3x at two bounces; PERF.md).  Registers (ptxas, sm_90a): K1's frame
// 60, composing 64, sliced 64, the trees 62 (K1's) and 64 (sliced) at every
// B; no spill.
// COUNT = true (a launch while a profiler records, utils/profiling.py
// work_counts) also adds the lanes whose flag the launch read to the
// device's occlusion_lanes_read counter: on each hit its direct-shadow lanes
// and every GI slot it evaluates live, one atomicAdd a warp (and a tree's
// slots one a chunk of hits); COUNT = false is the kernel without it.

#include <cstdint>
#include <cuda_runtime.h>

#include "shading.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 256;       // a thread a pixel, both forms
constexpr int kMaxQueries = 65535;  // K2's limit (gridDim.z)
// The tree's node store: a tile's hits, then a chunk of them with their
// trees' live slots; one hit's whole tree fits beside a tile of hits at 4
// bounces.
constexpr int kNodes = 1024;
static_assert(kNodes >= kThreads + 1 + gi_rows(kMaxBounces), "a hit's tree fits");

// The lanes read, summed over every counting launch on the device (the
// module's copy of it is per device, zero when it loads).
__device__ unsigned long long g_occlusion_lanes_read;

struct ShadeArgs {
  Cam cam;
  LightConsts k;
  int n, width, height;
  int n_soft, n_slots, gi_slot, total_states;
};

struct ShadeTile {
  TileNodes<kNodes> T;
  // A slot's own slots' sum, then its bounce; a hit's GI, then on the
  // sliced frame its light.
  float ax[kNodes], ay[kNodes], az[kNodes];
  int id[kThreads];
  float t[kThreads], occl[kThreads];
  int sums[kThreads / 32];
  int end[kMaxBounces + 1];  // the tree's levels' ends in the node store
};

__device__ __forceinline__ V3 acc_of(const ShadeTile& S, int i) {
  return {S.ax[i], S.ay[i], S.az[i]};
}
__device__ __forceinline__ void set_acc(ShadeTile& S, int i, V3 v) {
  S.ax[i] = v.x, S.ay[i] = v.y, S.az[i] = v.z;
}

// The bounce of live node i at level k of a B-bounce tree (its own slots'
// sum stored where k < B).  The light, its magnitude and the camera come
// from the launch's parameters, the nodes from shared memory as each BRDF
// needs them, so that little stays live across the two.
template <int B>
__device__ __forceinline__ void shade_node(const ShadeArgs& a, ShadeTile& S,
                                           const int* __restrict__ flags, int npix, int tile,
                                           int k, int i) {
  const LightConsts& K = a.k;
  const float* P = a.cam.p;
  const TileNodes<kNodes>& T = S.T;
  const int par = T.parent[i];
  const int row = gi_level_start(k) + T.s[i];
  const float quot =
      occlusion_quotient(flags[(size_t)(a.n_soft + row) * npix + tile + T.lp[i]] == 1);
  V3 refl;
  {
    const Node nd = T.node(K, i);
    const float lm = P[P_LMAG];
    const V3 sh = lighting_at(K, nd.point, nd.origin, nd.cx, nd.cy, T.point(par), V3{lm, lm, lm},
                              V3{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]});
    refl = {quot * sh.x + K.emis[0], quot * sh.y + K.emis[1], quot * sh.z + K.emis[2]};
  }
  if (k < B) {
    V3 sum{0.0f, 0.0f, 0.0f};
    for (int c = T.cs[i]; c < T.ce[i]; ++c) sum = sum + acc_of(S, c);
    refl = refl + sum;
  }
  const V3 viewer = k == 1 ? V3{P[P_O], P[P_O + 1], P[P_O + 2]} : T.point(T.parent[par]);
  const Node pn = T.node(K, par);
  set_acc(S, i, lighting_at(K, pn.point, pn.origin, pn.cx, pn.cy, viewer, refl, T.point(i)));
}

// One bounce (B = 1), a thread a pixel, the GI's live slots one a lane of
// the warp.
template <bool SLICED, bool COMPOSE, bool COUNT>
__device__ __forceinline__ void shade_pixel(const ShadeArgs& a, const int* __restrict__ idx,
                                            const float* __restrict__ t,
                                            const int* __restrict__ flags,
                                            const uint8_t* __restrict__ states,
                                            const int64_t* __restrict__ sample_slot,
                                            const float* __restrict__ rgb_in,
                                            const int* __restrict__ age,
                                            const float* __restrict__ hist_rgb,
                                            const int* __restrict__ hist_idx,
                                            float* __restrict__ out_rgb,
                                            float* __restrict__ out_depth,
                                            float* __restrict__ out_hist) {
  // A warp's bounces, by item (at most 4 a lane), and each lane's hit: its
  // point, cell, face and slot flags, which its items read there (not
  // live in registers across them).
  __shared__ float bounce[kThreads / 32][3][4 * 32];
  __shared__ float own_q[3][kThreads];
  __shared__ int own_c[4][kThreads];
  const int npix = a.width * a.height;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;  // the warp's first thread
  float(*res)[4 * 32] = bounce[threadIdx.x >> 5];
  const bool in = pix < npix;  // lanes past the frame take part in the warp's items
  const float* P = a.cam.p;
  const LightConsts& K = a.k;

  // The loads of the pixel's inputs, before any geometry: its id and t and
  // the direct shadow's flags (up to 4 at once), then on hits the slots'
  // states and flags and the age.  K1's rgb and the history wait until after
  // the GI: holding them across it cost more registers (and blocks) than
  // their latency.
  const int id = in ? idx[pix] : -1;
  const float tt = in ? t[pix] : 0.0f;
  int f[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) f[s] = in && s < a.n_soft ? flags[(size_t)s * npix + pix] : 0;
  const bool found = id >= 0;
  uint32_t alive = 0, occluded = 0;  // the slots' states == 1, flags == 1
  if (found) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < a.n_slots) {
        alive |= (uint32_t)(states[(size_t)i * npix + pix] == 1) << i;
        occluded |= (uint32_t)(flags[(size_t)(a.n_soft + i) * npix + pix] == 1) << i;
      }
    }
  }
  const int ag = SLICED && found && age != nullptr ? age[pix] : 0;

  const Hit h = hit_geometry(P, K, a.n, pix % a.width, pix / a.width, id, tt);
  // What the frame's tail needs of the ray, now, so that the ray is not live
  // across the GI: the light cube on the pixel's ray, the depth overlay's
  // half, the volume's exit.
  const bool cube = COMPOSE && light_cube_hit(P, h.o, h.d);
  const bool overlay = COMPOSE && P[P_OVERLAY] == 1.0f && h.ux < 0.5f;
  const float depth = SLICED && !found ? miss_depth(P, h.d) : tt;
  const V3 light{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]};
  const float lm = P[P_LMAG];
  const V3 lmag{lm, lm, lm};

  float occl = 1.0f;
  if (a.n_soft > 0) {
    float sum = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < a.n_soft) sum = sum + occlusion_quotient(f[s] == 1);
    }
    for (int s = 4; s < a.n_soft; ++s) {
      sum = sum + occlusion_quotient(in && flags[(size_t)s * npix + pix] == 1);
    }
    occl = sum / K.occ_div;
  }

  // The GI.  A slot adds its bounce where its entry exists and its
  // neighbour is alive (live, which needs a hit), and 0 elsewhere: the
  // twin's where(ok, bounce, 0), so the bounce is evaluated only there, one
  // live slot a lane, and summed from 0 in slot order (0 + x is x).
  V3 gi{0.0f, 0.0f, 0.0f};
  int live_slots = 0;  // counted with COUNT
  if (a.n_slots == 1 && found) {
    // The temporal mode's one slot, on its lane: a warp has no more live
    // slots than lanes.
    const int gs = sample_slot != nullptr ? (int)*sample_slot : a.gi_slot;
    const Slot sl = slot_geometry(K, h, face_index(cube_face_normal(h.q, h.origin)), gs);
    if (sl.ok && alive) {
      live_slots = 1;
      const float quot = occlusion_quotient(occluded);
      const V3 sh = lighting_at(K, sl.point, sl.origin, sl.nx, sl.ny, h.q, lmag, light);
      const V3 refl{quot * sh.x + K.emis[0], quot * sh.y + K.emis[1], quot * sh.z + K.emis[2]};
      gi = gi + lighting_at(K, h.q, h.origin, h.cx, h.cy, V3{P[P_O], P[P_O + 1], P[P_O + 2]},
                            refl, sl.point);
    }
    gi = {gi.x * 4.0f, gi.y * 4.0f, gi.z * 4.0f};  // the unbiased 1-of-4 estimator
  } else if (a.n_slots == 4) {
    // Four slots: the warp's live ones, one a lane.
    const int face = found ? face_index(cube_face_normal(h.q, h.origin)) : 0;
    uint32_t live = 0;
    if (found) {
      for (int i = 0; i < 4; ++i) {
        if ((alive >> i & 1u) && slot_geometry(K, h, face, i).ok) live |= 1u << i;
      }
    }
    own_q[0][threadIdx.x] = h.q.x, own_q[1][threadIdx.x] = h.q.y, own_q[2][threadIdx.x] = h.q.z;
    own_c[0][threadIdx.x] = h.cx, own_c[1][threadIdx.x] = h.cy, own_c[2][threadIdx.x] = h.cz;
    own_c[3][threadIdx.x] = face | (int)occluded << 8;
    __syncwarp();
    const int count = __popc(live);
    live_slots = count;
    int total;
    const int first = warp_scan(count, total);
    for (int k0 = 0; k0 < total; k0 += 32) {
      int o, slot;
      warp_item(k0 + lane, first, live, o, slot);
      if (k0 + lane < total) {
        // The owner's hit.
        o += warp0;
        const V3 q{own_q[0][o], own_q[1][o], own_q[2][o]};
        const int ox = own_c[0][o], oy = own_c[1][o], oz = own_c[2][o], of = own_c[3][o];
        const Node hn{q, cell_origin(K, ox, oy, oz), ox, oy, oz};
        const Slot sl = node_slot(K, hn, true, of & 0xff, slot);
        const float quot = occlusion_quotient(of >> (8 + slot) & 1);
        const V3 sh = lighting_at(K, sl.point, sl.origin, sl.nx, sl.ny, q, lmag, light);
        const V3 refl{quot * sh.x + K.emis[0], quot * sh.y + K.emis[1],
                      quot * sh.z + K.emis[2]};
        const V3 b = lighting_at(K, q, hn.origin, ox, oy, V3{P[P_O], P[P_O + 1], P[P_O + 2]},
                                 refl, sl.point);
        res[0][k0 + lane] = b.x, res[1][k0 + lane] = b.y, res[2][k0 + lane] = b.z;
      }
    }
    __syncwarp();
    for (int k = first; k < first + count; ++k) gi = gi + V3{res[0][k], res[1][k], res[2][k]};
  }
  if constexpr (COUNT) {
    // Every lane of the warp is here (lanes past the frame read nothing).
    const int read = __reduce_add_sync(0xffffffffu, (found ? a.n_soft : 0) + live_slots);
    if (read && lane == 0) atomicAdd(&g_occlusion_lanes_read, (unsigned long long)read);
  }
  if (!in) return;

  V3 c{0.0f, 0.0f, 0.0f};
  if constexpr (SLICED) {
    // Black on a miss; the direct light, faded and shadowed, plus the GI on
    // a hit.
    if (found) {
      const V3 dl = lighting_at(K, h.q, h.origin, h.cx, h.cy, V3{P[P_O], P[P_O + 1], P[P_O + 2]},
                                lmag, light);
      c = {clamp_min0(dl.x), clamp_min0(dl.y), clamp_min0(dl.z)};
      const bool faded = age != nullptr;
      if (faded) {
        const float fade = age_fade(a.total_states, ag);
        occl = a.n_soft > 0 ? occl * fade : fade;
      }
      if (a.n_soft > 0 || faded) {
        c = {c.x * occl, c.y * occl, c.z * occl};
      }
      if (a.n_slots > 0) c = c + gi;
    }
    out_depth[pix] = depth;
  } else {
    c = {rgb_in[3 * (size_t)pix], rgb_in[3 * (size_t)pix + 1], rgb_in[3 * (size_t)pix + 2]};
    if (a.n_soft > 0) c = {c.x * occl, c.y * occl, c.z * occl};
    if (a.n_slots > 0) {
      c = c + (found ? gi : V3{0.0f, 0.0f, 0.0f});
    }
  }
  if (found) c = c + V3{K.emis[0], K.emis[1], K.emis[2]};
  if constexpr (!COMPOSE) {
    out_rgb[3 * (size_t)pix] = c.x;
    out_rgb[3 * (size_t)pix + 1] = c.y;
    out_rgb[3 * (size_t)pix + 2] = c.z;
  } else {
    // _ext_frame: the EMA where the history's cell is this pixel's hit.
    if (found && id == hist_idx[pix]) {
      const float alpha = P[P_ALPHA];
      const float pr = hist_rgb[3 * (size_t)pix];
      const float pg = hist_rgb[3 * (size_t)pix + 1];
      const float pb = hist_rgb[3 * (size_t)pix + 2];
      c = {clamp01(pr + (c.x - pr) * alpha), clamp01(pg + (c.y - pg) * alpha),
           clamp01(pb + (c.z - pb) * alpha)};
    }
    if (c.x == 0.0f && c.y == 0.0f && c.z == 0.0f && cube) c = {1.0f, 1.0f, 1.0f};
    out_hist[3 * (size_t)pix] = c.x;
    out_hist[3 * (size_t)pix + 1] = c.y;
    out_hist[3 * (size_t)pix + 2] = c.z;
    if (overlay) c = {depth, 0.0f, 0.0f};
    out_rgb[3 * (size_t)pix] = torch_pow(c.x, K.inv_g);
    out_rgb[3 * (size_t)pix + 1] = torch_pow(c.y, K.inv_g);
    out_rgb[3 * (size_t)pix + 2] = torch_pow(c.z, K.inv_g);
  }
}

// B > 1 bounces: the block's pixels (a tile, a thread a pixel), their hits
// and their trees' live slots compacted, one item a thread.
template <bool SLICED, int B, bool COUNT>
__device__ __forceinline__ void shade_tree(const ShadeArgs& a, const int* __restrict__ idx,
                                           const float* __restrict__ t,
                                           const int* __restrict__ flags,
                                           const uint8_t* __restrict__ states,
                                           const float* __restrict__ rgb_in,
                                           const int* __restrict__ age,
                                           float* __restrict__ out_rgb,
                                           float* __restrict__ out_depth) {
  __shared__ ShadeTile S;
  TileNodes<kNodes>& T = S.T;
  const int npix = a.width * a.height;
  const int tile = blockIdx.x * kThreads;
  const int lp0 = threadIdx.x;  // the thread's pixel in the tile
  const int pix = tile + lp0;
  const float* P = a.cam.p;
  const LightConsts& K = a.k;

  // The pixel: its id and t, K1's rgb, the direct shadow's quotient, all
  // loaded before any geometry.
  const bool in = pix < npix;
  const int id = in ? idx[pix] : -1;
  const float tt = in ? t[pix] : 0.0f;
  V3 c{0.0f, 0.0f, 0.0f};
  if (!SLICED && in) {
    c = {rgb_in[3 * (size_t)pix], rgb_in[3 * (size_t)pix + 1], rgb_in[3 * (size_t)pix + 2]};
  }
  float occl = 1.0f;
  if (a.n_soft > 0 && in) {
    float sum = 0.0f;
    for (int s = 0; s < a.n_soft; ++s) {
      sum = sum + occlusion_quotient(flags[(size_t)s * npix + pix] == 1);
    }
    occl = sum / K.occ_div;
  }
  S.id[lp0] = id;
  S.t[lp0] = tt;
  S.occl[lp0] = occl;
  const bool found = id >= 0;
  if constexpr (COUNT) {
    // The hits' direct-shadow lanes, a warp's at once; the GI's below.
    const int hits = __popc(__ballot_sync(0xffffffffu, found));
    if (hits && a.n_soft > 0 && (threadIdx.x & 31) == 0) {
      atomicAdd(&g_occlusion_lanes_read, (unsigned long long)hits * a.n_soft);
    }
  }

  // The tile's hits, compacted in pixel order, and their geometry.
  int nh;
  const int hit = block_scan<kThreads>(found ? 1 : 0, S.sums, nh);
  if (found) T.lp[hit] = (uint16_t)lp0;
  __syncthreads();
  for (int h = threadIdx.x; h < nh; h += kThreads) {
    const int lp = T.lp[h], p = tile + lp;
    T.set_hit(h, hit_geometry(P, K, a.n, p % a.width, p / a.width, S.id[lp], S.t[lp]), lp);
  }
  __syncthreads();

  // The GI: chunks of hits, each with its tree's live slots, one a thread:
  // top down, then bottom up.  Level k's nodes are [S.end[k - 1], S.end[k])
  // (S.end[0] = nh: the chunk's hits are nodes h0 .. h0 + g - 1); the levels
  // roll, and their bounds live in shared memory, so that the registers do
  // not grow with B.
  int chunk = max(1, (kNodes - nh) / 4);
  for (int h0 = 0; h0 < nh;) {
    const int g = min(chunk, nh - h0);
    int lo = h0, hi = h0 + g, end = nh;
    bool fit = true;
#pragma unroll 1
    for (int k = 1; k <= B && fit; ++k) {
      if (threadIdx.x == 0) S.end[k - 1] = end;
      const int next = end;
      fit = expand_level<kThreads>(T, K, states, npix, tile, k, lo, hi, k < B, end, S.sums);
      lo = next;
      hi = end;
    }
    if (!fit) {
      chunk = max(1, g / 2);
      continue;
    }
    if (threadIdx.x == 0) S.end[B] = end;
    if constexpr (COUNT) {
      // The chunk's live slots, nodes nh .. end - 1: each reads its flag.
      if (threadIdx.x == 0 && end > nh) {
        atomicAdd(&g_occlusion_lanes_read, (unsigned long long)(end - nh));
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int k = B; k >= 1; --k) {
      for (int i = S.end[k - 1] + threadIdx.x; i < S.end[k]; i += kThreads) {
        shade_node<B>(a, S, flags, npix, tile, k, i);
      }
      __syncthreads();
    }
    for (int h = h0 + threadIdx.x; h < h0 + g; h += kThreads) {
      V3 gi{0.0f, 0.0f, 0.0f};
      for (int n = T.cs[h]; n < T.ce[h]; ++n) gi = gi + acc_of(S, n);
      set_acc(S, h, gi);
    }
    __syncthreads();
    h0 += g;
  }

  // The pixel's light.
  if (!in) return;
  if constexpr (SLICED) {
    // On a hit the direct light, faded and shadowed, plus the GI; black on
    // a miss, with the volume's exit as its depth.
    if (found) {
      const Node hn = T.node(K, hit);
      const float lm = P[P_LMAG];
      const V3 dl = lighting_at(K, hn.point, hn.origin, hn.cx, hn.cy,
                                V3{P[P_O], P[P_O + 1], P[P_O + 2]}, V3{lm, lm, lm},
                                V3{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]});
      c = {clamp_min0(dl.x), clamp_min0(dl.y), clamp_min0(dl.z)};
      const bool faded = age != nullptr;
      if (faded) {
        const float fade = age_fade(a.total_states, age[pix]);
        occl = a.n_soft > 0 ? occl * fade : fade;
      }
      if (a.n_soft > 0 || faded) c = {c.x * occl, c.y * occl, c.z * occl};
      c = c + acc_of(S, hit);
      out_depth[pix] = tt;
    } else {
      float ux;
      const Ray r = camera_ray(P, pix % a.width, pix / a.width, ux);
      out_depth[pix] = miss_depth(P, V3{r.dx, r.dy, r.dz});
    }
  } else {
    if (a.n_soft > 0) c = {c.x * occl, c.y * occl, c.z * occl};
    c = c + (found ? acc_of(S, hit) : V3{0.0f, 0.0f, 0.0f});
  }
  if (found) c = c + V3{K.emis[0], K.emis[1], K.emis[2]};
  out_rgb[3 * (size_t)pix] = c.x;
  out_rgb[3 * (size_t)pix + 1] = c.y;
  out_rgb[3 * (size_t)pix + 2] = c.z;
}

template <bool SLICED, bool COMPOSE, int B, bool COUNT = false>
__global__ void __launch_bounds__(kThreads)
    lighting_shade_kernel(const ShadeArgs a, const int* __restrict__ idx,
                          const float* __restrict__ t,
                          const int* __restrict__ flags,
                          const uint8_t* __restrict__ states,
                          const int64_t* __restrict__ sample_slot,
                          const float* __restrict__ rgb_in,
                          const int* __restrict__ age,
                          const float* __restrict__ hist_rgb,
                          const int* __restrict__ hist_idx,
                          float* __restrict__ out_rgb, float* __restrict__ out_depth,
                          float* __restrict__ out_hist) {
  if constexpr (B == 1) {
    shade_pixel<SLICED, COMPOSE, COUNT>(a, idx, t, flags, states, sample_slot, rgb_in, age,
                                        hist_rgb, hist_idx, out_rgb, out_depth, out_hist);
  } else {
    static_assert(!COMPOSE, "a multi-bounce frame does not compose");
    shade_tree<SLICED, B, COUNT>(a, idx, t, flags, states, rgb_in, age, out_rgb, out_depth);
  }
}

using ShadeKernel = decltype(&lighting_shade_kernel<false, false, 1>);

// [count][sliced][bounces - 1]; K1's frame composes with one bounce only.
static_assert(kMaxBounces == 4, "one instantiation per bounce count");
const ShadeKernel kShade[2][2][kMaxBounces] = {
    {{lighting_shade_kernel<false, false, 1>, lighting_shade_kernel<false, false, 2>,
      lighting_shade_kernel<false, false, 3>, lighting_shade_kernel<false, false, 4>},
     {lighting_shade_kernel<true, false, 1>, lighting_shade_kernel<true, false, 2>,
      lighting_shade_kernel<true, false, 3>, lighting_shade_kernel<true, false, 4>}},
    {{lighting_shade_kernel<false, false, 1, true>, lighting_shade_kernel<false, false, 2, true>,
      lighting_shade_kernel<false, false, 3, true>, lighting_shade_kernel<false, false, 4, true>},
     {lighting_shade_kernel<true, false, 1, true>, lighting_shade_kernel<true, false, 2, true>,
      lighting_shade_kernel<true, false, 3, true>, lighting_shade_kernel<true, false, 4, true>}},
};
const ShadeKernel kCompose[2] = {lighting_shade_kernel<false, true, 1>,
                                 lighting_shade_kernel<false, true, 1, true>};

}  // namespace

extern "C" {

// cam: host float[40]; consts: host float[24] (shading.cuh LightConsts);
// idx int32[H, W] and t float[H, W]: the primary hits (K1's depth, or K4's
// t).  flags: int32[n_soft + n_slots, H, W] (1 = occluded; null when both
// counts are 0); states: uint8[n_slots, H, W] (null without slots); the
// slot of a temporal frame (n_slots = 1) is *sample_slot when given, else
// gi_slot.  bounces in [1, kMaxBounces]; above 1, n_slots = gi_rows(bounces)
// (the GI tree's rows, shading.cuh) and no composition.  sliced = 0: rgb_in float[H, W, 3] is K1's frame; with compose,
// hist_rgb float[H, W, 3] and hist_idx int32[H, W] are the history, out_rgb
// the presentation and out_hist the new history.  sliced = 1: age (int32[H,
// W] or null) fades the direct light by total_states; out_depth float[H, W]
// is the frame's depth.  The light includes the emissive light on hits.
// count = 1 adds the lanes read to the device's occlusion_lanes_read
// (COUNT = true).  Returns the launch's cudaError_t.
int ca3d_lighting_shade(int device, const float* cam, const float* consts, int n, int width,
                        int height, int n_soft, int n_slots, int bounces, int gi_slot,
                        const void* sample_slot, int sliced, int compose, int total_states,
                        const void* idx, const void* t, const void* flags, const void* states,
                        const void* rgb_in, const void* age, const void* hist_rgb,
                        const void* hist_idx, void* out_rgb, void* out_depth, void* out_hist,
                        int count, void* stream) {
  const bool bad_mode =
      sliced ? (compose || out_depth == nullptr || total_states < 2)
             : (rgb_in == nullptr || age != nullptr ||
                (compose && (hist_rgb == nullptr || hist_idx == nullptr ||
                             out_hist == nullptr)));
  const bool bad_slots =
      bounces < 1 || bounces > kMaxBounces ||
      (bounces == 1 ? (n_slots != 0 && n_slots != 1 && n_slots != 4)
                    : (n_slots != gi_rows(bounces) || compose));
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      (long long)width * height > INT32_MAX || n_soft < 0 || bad_slots ||
      n_soft + n_slots > kMaxQueries ||
      (n_soft + n_slots > 0 && flags == nullptr) || (n_slots > 0 && states == nullptr) ||
      gi_slot < 0 || gi_slot > 3 || bad_mode) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  ShadeArgs a;
  for (int i = 0; i < P_LEN; ++i) a.cam.p[i] = cam[i];
  a.k = *reinterpret_cast<const LightConsts*>(consts);
  a.n = n;
  a.width = width;
  a.height = height;
  a.n_soft = n_soft;
  a.n_slots = n_slots;
  a.gi_slot = gi_slot;
  a.total_states = total_states;
  // The sliced frame never composes.
  const int c = count ? 1 : 0;
  const ShadeKernel kernel = compose ? kCompose[c] : kShade[c][sliced ? 1 : 0][bounces - 1];
  const int npix = width * height;
  kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(idx), static_cast<const float*>(t),
      static_cast<const int*>(flags), static_cast<const uint8_t*>(states),
      static_cast<const int64_t*>(sample_slot), static_cast<const float*>(rgb_in),
      static_cast<const int*>(age), static_cast<const float*>(hist_rgb),
      static_cast<const int*>(hist_idx), static_cast<float*>(out_rgb),
      static_cast<float*>(out_depth), static_cast<float*>(out_hist));
  return cudaGetLastError();
}

// *out = the device's occlusion_lanes_read, copied after the work queued
// before.
int ca3d_lighting_shade_lanes(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaMemcpyFromSymbol(out, g_occlusion_lanes_read, sizeof(*out));
}

}  // extern "C"
