// The shading of an extended-lighting frame: one launch takes the frame's
// occlusion flags (K2 or K5) and neighbour states (K3) to its light, and in
// the fused loop to its presentation and new history.
//
// Replaces: the XLA shading of cellularautomatons3d_tpu/render/
// render_slab.py lighting_passes (:1431; the occlusion quotient and the
// one-bounce double BRDF of brdf.py :32-109), raytrace_sliced's direct light
// and composition (:1714), renderer_fast.py's lighting on K1's frame
// (:84-206) and the fused loop's frame composition _ext_frame_blocked
// (:318), which JAX fuses under jit.  The port's torch twin,
// render_slab.py lighting_shade, runs a full-quality frame's as ~1,000 eager
// launches.
//
// One thread a pixel, each step the twin's, in its order (shading.cuh):
//   * the hit geometry again from the id, t and camera (hit_geometry);
//   * the soft occlusion quotient: the samples' quotients (0.0095 where
//     occluded, else 1) summed from 0 in order, then one IEEE division by
//     occ_div (soft_k, or 1 in the temporal mode);
//   * each GI slot (4, or the temporal one, then x4): its geometry again
//     (slot_geometry), reflected = quotient * shade(n_point, ...) + emissive,
//     bounce = shade(q, ..., reflected, n_point), summed from 0 in slot order
//     where the slot's entry exists and its neighbour is alive (evaluated
//     only there: elsewhere the twin adds 0, whatever the bounce);
//   * with B > 1 bounces, the GI tree of JAX's indirect_bounce recursion
//     (render_slab.py:1308), depth first (gi_sum): a slot's reflected light
//     also adds its own slots' sum (from 0, in order) before its bounce, its
//     neighbour's direct term seen from its parent's point; a slot is
//     evaluated where its parent is, its entry exists and its neighbour
//     lives (states of every level from K3), its quotient from its flag;
//   * K1's frame (SLICED = 0): K1's unshadowed, age-faded rgb times the
//     quotient, plus the GI where the pixel hit; with COMPOSE the id-checked
//     EMA against the f32 history, the light cube on black pixels, the new
//     history, the depth overlay and gamma (K1's composition);
//   * the sliced frame (SLICED = 1): the direct light clamp(shade(q, origin,
//     coords, o, lmag, light), 0) times the quotient and the age fade
//     (occl * fade, then shaded * occl), plus the GI, black on misses, and
//     the depth: t on hits, the volume's exit (hit_geometry's miss depth)
//     elsewhere;
//   * the emissive light on hits.
// Every min, max and clamp propagates NaN, so a 0/0 of the BRDF comes out
// NaN where the twin's does.
// Bound: bytes.  On every pixel it reads the id and t (8 B), the direct
// shadow's flags (4 B a sample) and K1's rgb (12 B), and writes the light
// (12 B) and the new history (12 B) or the depth (4 B); the slots' states
// and flags, the age and the history's id and colour it reads on hit pixels
// only: ~60 B a pixel at full quality in the fused loop (~0.04 ms at 1080p
// on 3.35 TB/s).  The arithmetic (up to 9 BRDF evaluations a hit pixel,
// ~1,300 flops with 30 divisions and 27 square roots) runs on hit pixels
// only, a few percent of a 1080p frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "shading.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 256;
constexpr int kMaxQueries = 65535;  // K2's limit (gridDim.z)

struct ShadeArgs {
  Cam cam;
  LightConsts k;
  int n, width, height;
  int n_soft, n_slots, gi_slot, total_states;
};

// The GI that the cell of `node` (level k of the tree, index s, seen from
// `viewer`) receives from its 4 slots, each slot's reflected light with its
// own D - 1 levels below: the twin's indirect_from, depth first.
template <int D>
__device__ V3 gi_sum(const ShadeArgs& a, const int* __restrict__ flags,
                     const uint8_t* __restrict__ states, int pix, int npix, const Node& node,
                     V3 viewer, int k, int s, V3 lmag, V3 light) {
  const LightConsts& K = a.k;
  const int face = face_index(cube_face_normal(node.point, node.origin));
  V3 total{0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const Slot c = node_slot(K, node, true, face, j);
    const int row = gi_level_start(k + 1) + 4 * s + j;
    if (!(c.ok && states[(size_t)row * npix + pix] == 1)) continue;
    const float quot = occlusion_quotient(flags[(size_t)(a.n_soft + row) * npix + pix] == 1);
    const V3 sh = lighting_at(K, c.point, c.origin, c.nx, c.ny, node.point, lmag, light);
    V3 refl{quot * sh.x + K.emis[0], quot * sh.y + K.emis[1], quot * sh.z + K.emis[2]};
    if constexpr (D > 1) {
      refl = refl + gi_sum<D - 1>(a, flags, states, pix, npix, slot_node(c), node.point, k + 1,
                                  4 * s + j, lmag, light);
    }
    total = total + lighting_at(K, node.point, node.origin, node.cx, node.cy, viewer, refl,
                                c.point);
  }
  return total;
}

template <bool SLICED, bool COMPOSE, int B>
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
  const int npix = a.width * a.height;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int px = pix % a.width, py = pix / a.width;
  const float* P = a.cam.p;
  const LightConsts& K = a.k;
  const int id = idx[pix];
  const float tt = t[pix];
  const Hit h = hit_geometry(P, K, a.n, px, py, id, tt);
  const V3 light{P[P_LIGHT], P[P_LIGHT + 1], P[P_LIGHT + 2]};
  const float lm = P[P_LMAG];
  const V3 lmag{lm, lm, lm};

  float occl = 1.0f;
  if (a.n_soft > 0) {
    float sum = 0.0f;
    for (int s = 0; s < a.n_soft; ++s) {
      sum = sum + occlusion_quotient(flags[(size_t)s * npix + pix] == 1);
    }
    occl = sum / K.occ_div;
  }

  // A slot adds its bounce where its entry exists and its neighbour is
  // alive (ok, which needs a hit), and 0 elsewhere: the twin's where(ok,
  // bounce, 0), so the bounce is evaluated only there.
  V3 gi{0.0f, 0.0f, 0.0f};
  if constexpr (B == 1) {
    if (a.n_slots > 0 && h.found) {
      const int face = face_index(cube_face_normal(h.q, h.origin));
      const int gs = sample_slot != nullptr ? (int)*sample_slot : a.gi_slot;
      for (int i = 0; i < a.n_slots; ++i) {
        const Slot sl = slot_geometry(K, h, face, a.n_slots == 4 ? i : gs);
        if (!(sl.ok && states[(size_t)i * npix + pix] == 1)) continue;
        const float quot =
            occlusion_quotient(flags[(size_t)(a.n_soft + i) * npix + pix] == 1);
        const V3 sh = lighting_at(K, sl.point, sl.origin, sl.nx, sl.ny, h.q, lmag, light);
        const V3 refl{quot * sh.x + K.emis[0], quot * sh.y + K.emis[1],
                      quot * sh.z + K.emis[2]};
        gi = gi + lighting_at(K, h.q, h.origin, h.cx, h.cy, h.o, refl, sl.point);
      }
      if (a.n_slots == 1) {  // the unbiased 1-of-4 estimator
        gi.x = gi.x * 4.0f;
        gi.y = gi.y * 4.0f;
        gi.z = gi.z * 4.0f;
      }
    }
  } else if (h.found) {
    gi = gi_sum<B>(a, flags, states, pix, npix, hit_node(h), h.o, 0, 0, lmag, light);
  }

  V3 c;
  float depth = tt;
  if constexpr (SLICED) {
    // Black on a miss; the direct light, faded and shadowed, plus the GI on
    // a hit.
    c = {0.0f, 0.0f, 0.0f};
    if (h.found) {
      const V3 dl = lighting_at(K, h.q, h.origin, h.cx, h.cy, h.o, lmag, light);
      c = {clamp_min0(dl.x), clamp_min0(dl.y), clamp_min0(dl.z)};
      const bool faded = age != nullptr;
      if (faded) {
        const float fade = age_fade(a.total_states, age[pix]);
        occl = a.n_soft > 0 ? occl * fade : fade;
      }
      if (a.n_soft > 0 || faded) {
        c = {c.x * occl, c.y * occl, c.z * occl};
      }
      if (a.n_slots > 0) c = c + gi;
    }
    depth = h.found ? tt : miss_depth(P, h.d);
    out_depth[pix] = depth;
  } else {
    c = {rgb_in[3 * (size_t)pix], rgb_in[3 * (size_t)pix + 1], rgb_in[3 * (size_t)pix + 2]};
    if (a.n_soft > 0) c = {c.x * occl, c.y * occl, c.z * occl};
    if (a.n_slots > 0) {
      c = c + (h.found ? gi : V3{0.0f, 0.0f, 0.0f});
    }
  }
  if (h.found) c = c + V3{K.emis[0], K.emis[1], K.emis[2]};
  if constexpr (!COMPOSE) {
    out_rgb[3 * (size_t)pix] = c.x;
    out_rgb[3 * (size_t)pix + 1] = c.y;
    out_rgb[3 * (size_t)pix + 2] = c.z;
  } else {
    // _ext_frame: the EMA where the history's cell is this pixel's hit.
    if (h.found && id == hist_idx[pix]) {
      const float alpha = P[P_ALPHA];
      const float pr = hist_rgb[3 * (size_t)pix];
      const float pg = hist_rgb[3 * (size_t)pix + 1];
      const float pb = hist_rgb[3 * (size_t)pix + 2];
      c = {clamp01(pr + (c.x - pr) * alpha), clamp01(pg + (c.y - pg) * alpha),
           clamp01(pb + (c.z - pb) * alpha)};
    }
    if (c.x == 0.0f && c.y == 0.0f && c.z == 0.0f && light_cube_hit(P, h.o, h.d)) {
      c = {1.0f, 1.0f, 1.0f};
    }
    out_hist[3 * (size_t)pix] = c.x;
    out_hist[3 * (size_t)pix + 1] = c.y;
    out_hist[3 * (size_t)pix + 2] = c.z;
    if (P[P_OVERLAY] == 1.0f && h.ux < 0.5f) c = {depth, 0.0f, 0.0f};
    out_rgb[3 * (size_t)pix] = torch_pow(c.x, K.inv_g);
    out_rgb[3 * (size_t)pix + 1] = torch_pow(c.y, K.inv_g);
    out_rgb[3 * (size_t)pix + 2] = torch_pow(c.z, K.inv_g);
  }
}

using ShadeKernel = decltype(&lighting_shade_kernel<false, false, 1>);

// [sliced][bounces - 1]; K1's frame composes with one bounce only.
static_assert(kMaxBounces == 4, "one instantiation per bounce count");
const ShadeKernel kShade[2][kMaxBounces] = {
    {lighting_shade_kernel<false, false, 1>, lighting_shade_kernel<false, false, 2>,
     lighting_shade_kernel<false, false, 3>, lighting_shade_kernel<false, false, 4>},
    {lighting_shade_kernel<true, false, 1>, lighting_shade_kernel<true, false, 2>,
     lighting_shade_kernel<true, false, 3>, lighting_shade_kernel<true, false, 4>},
};

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
// Returns the launch's cudaError_t.
int ca3d_lighting_shade(int device, const float* cam, const float* consts, int n, int width,
                        int height, int n_soft, int n_slots, int bounces, int gi_slot,
                        const void* sample_slot, int sliced, int compose, int total_states,
                        const void* idx, const void* t, const void* flags, const void* states,
                        const void* rgb_in, const void* age, const void* hist_rgb,
                        const void* hist_idx, void* out_rgb, void* out_depth, void* out_hist,
                        void* stream) {
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
  const ShadeKernel kernel =
      compose ? lighting_shade_kernel<false, true, 1> : kShade[sliced ? 1 : 0][bounces - 1];
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

}  // extern "C"
