// K1: one fast-pipeline frame of a <= 256^3 volume, one thread per pixel.
//
// Replaces: cellularautomatons3d_tpu/render/render_fast.py, _make_kernel
// (launched by raytrace_tiles) and the sweep / fetch closures of
// _make_traversal.  Per pixel: camera ray, volume slab entry/exit, the
// primary plane-midpoint DDA sweep, the hard-shadow sweep toward the light
// with start-cell exclusion, Cook-Torrance shading with position albedo;
// with COMPOSE also emissive light, the cell-id-checked temporal EMA, the
// light cube, the new history, the depth overlay and gamma.  With age
// planes (multi-state rules) the hit cell's age is fetched from them and
// the age fade multiplies the direct term only: occl * fade, then shaded *
// occl; the emissive term of COMPOSE is neither shadowed nor faded.
//
// The traversal (the reference's DDA semantics, float rounding rules and
// the exact coarse-mip column skip) and the camera ray are sweep.cuh,
// shared with K2 and K4.  Grids above 256^3 go through K4 and K2 instead.
// With a column mask (MASK != kMaskNone) the primary sweep's column test is
// the reference's colmask rule instead of the mip: column c descends iff
// its clipped segment is non-empty and bit c of the pixel's patch mask
// (K6) is set, the ray is steep (render_fast.py column_occ), or the window
// is too small for the masks (mask_forced, render_fast.py
// mask_gate_forced); the shadow sweep keeps the mip.  kMaskGiven reads the
// masks from a tensor (prepass.cu, or any caller's); kMaskInline
// (raytrace_tiles(use_prepass=True) on the card) computes them: after the
// mip is staged, warp 0 computes the block's two 8x8 patch masks from it
// (prepass.cuh patch_mask, 16 lanes a patch, the occupied box's columns)
// into shared memory, so the prepass frame is this one launch.  With
// NO_SWEEP neither sweep runs (the frame of an empty volume): the floor of
// the kernel's timing split, for tools/time_k1.py and chip_smoke.py only.
//
// OPT picks the descent of both sweeps (sweep.cuh) for the reference's
// opt-in traversal options, each the same frame as the default:
// kOptMip1 (CA3D_MIP1, render_fast.py use_mip1) gates each probe's fine
// fetch by the plane mip's bit of its own cell, read through the read-only
// path (the 32 KiB mip of a 256^3 grid staged in each of an SM's ten blocks
// would take 320 KiB of its 228 KiB); kOptSliceGate (CA3D_SLICEGATE,
// descend_gated) loads a column's plane words before it tests them.  Both
// run with and without a mask (kMaskNone, kMaskInline).  kOptNoSkip
// descends every column of the occupied box (no MASK): the coarse column
// skip's attribution run (the reference's _column_dilate=False, which there
// feeds an undilated mip and is not exact; this one is).  The reference's
// third option, the sticky any-ray-alive gate (CA3D_ALIVE_GATE), has no
// code here: a thread leaves its column loop at its hit, and a warp when
// its last live lane does.
//
// Design on the H100 (one thread per pixel, one 16x8-pixel tile per
// block): about 93 % of a main-path frame's rays miss, and the first design
// walked every 8-plane column of each ray's z-extent, each a span, four
// cell lookups and a mip test.  Each block now reduces the 4 KiB mip it
// stages to the box of occupied blocks (stage_coarse_box), and both sweeps
// visit only the columns and t-range inside it (BoxClip: exact, the probes
// do not move); where the box is the whole volume the unclipped sweeps run.
// Tried and dropped (PERF.md §6): blocks walking several tiles, a
// column's 8 probe loads issued together, a tile's shadow rays packed onto
// its first lanes.  Bound: the frame's bytes (the 2 MiB volume, the
// history read and the four images written, ~100 MB at 1080p); the sweeps'
// probe loads are L2 hits whose latency the resident warps hide.  With a
// given mask the kernel reads one more i32 per pixel (the patch mask,
// L1/L2-resident: 130 KB at 1080p) and does one bit test per column in
// place of the mip's cell-range test; with an inline mask one warp of each
// block first sets up the two patch rays and probes 3 blocks a column, and
// the block waits at one more barrier.  With age planes it reads age_bits
// <= 4 more words per hit pixel, once, after the sweep.

#include <cstdint>
#include <cuda_runtime.h>

#include "prepass.cuh"
#include "shading.cuh"
#include "sweep.cuh"

namespace {

using namespace ca3d;

// Camera/params vector layout: render_fast.py P_* constants (in sweep.cuh
// and shading.cuh).

constexpr int kBlockX = 16;  // two 8x8 prepass patches
constexpr int kBlockY = 8;
static_assert(kBlockX == 2 * kPatch && kBlockY == kPatch,
              "the inline prologue computes two patch masks a block");

// Where the primary sweep's column gate comes from.
constexpr int kMaskNone = 0;    // the staged mip
constexpr int kMaskGiven = 1;   // colmask, a tensor of patch masks
constexpr int kMaskInline = 2;  // computed in the block's prologue

// K1's descent options (OPT).
constexpr int kOptNone = 0;       // EachPlane, the mip's column skip
constexpr int kOptMip1 = 1;       // PlaneMip
constexpr int kOptSliceGate = 2;  // Prefetch
constexpr int kOptNoSkip = 3;     // AllColumns: every column of the box

// The column gate and the descent of an OPT.
template <int OPT>
__device__ __forceinline__ auto column_gate(const uint32_t* coarse_s) {
  if constexpr (OPT == kOptNoSkip) {
    return AllColumns{};
  } else {
    return SharedMip{coarse_s};
  }
}
template <int OPT>
__device__ __forceinline__ auto descent_of(const uint32_t* planes, int nb) {
  if constexpr (OPT == kOptMip1) {
    return PlaneMip{planes, nb};
  } else if constexpr (OPT == kOptSliceGate) {
    return Prefetch{};
  } else {
    return EachPlane{};
  }
}

constexpr float kPi = 3.14159265359f;

__device__ __forceinline__ float sgn(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
}

// Cook-Torrance direct light (wgsl:537-633) at surface point q of the cell
// centred at co, seen from v_at, lit by a point light at lp of radiance lm.
__device__ void shade(const float* P, float qx, float qy, float qz, float cox,
                      float coy, float coz, float alr, float alg, float alb,
                      float vwx, float vwy, float vwz, float& outr,
                      float& outg, float& outb) {
  const float fxo = qx - cox, fyo = qy - coy, fzo = qz - coz;
  const float ax = fabsf(fxo), ay = fabsf(fyo), az = fabsf(fzo);
  const float m = maxp(maxp(ax, ay), az);
  const bool is_x = ax == m;
  const bool is_y = (ay == m) && !is_x;
  const bool is_z = !is_x && !is_y;
  const float nxn = is_x ? sgn(fxo) : 0.0f;
  const float nyn = is_y ? sgn(fyo) : 0.0f;
  const float nzn = is_z ? sgn(fzo) : 0.0f;
  float ldx = P[P_LIGHT] - qx, ldy = P[P_LIGHT + 1] - qy,
        ldz = P[P_LIGHT + 2] - qz;
  normalize3(ldx, ldy, ldz);
  float vx = vwx - qx, vy = vwy - qy, vz = vwz - qz;
  normalize3(vx, vy, vz);
  float hwx = ldx + vx, hwy = ldy + vy, hwz = ldz + vz;
  normalize3(hwx, hwy, hwz);
  const float rough = P[P_ROUGH];
  const float a2 = rough * rough;
  const float noh = nxn * hwx + nyn * hwy + nzn * hwz;
  const float fterm = noh * noh * (a2 - 1.0f) + 1.0f;
  const float dterm = a2 / (kPi * fterm * fterm);
  const float kd = (rough + 1.0f) * (rough + 1.0f) / 8.0f;
  const float nov = maxp(0.0f, nxn * vx + nyn * vy + nzn * vz);
  const float nol_c = maxp(0.0f, nxn * ldx + nyn * ldy + nzn * ldz);
  const float gterm = (nov / (nov * (1.0f - kd) + kd)) *
                      (nol_c / (nol_c * (1.0f - kd) + kd));
  const float hv = hwx * vx + hwy * vy + hwz * vz;
  const float p1 = 1.0f - hv;
  const float p2 = p1 * p1;
  const float p5 = p1 * (p2 * p2);  // lax.integer_pow(x, 5) order
  const float fr = P[P_REFL] + (1.0f - P[P_REFL]) * p5;
  const float fg = P[P_REFL + 1] + (1.0f - P[P_REFL + 1]) * p5;
  const float fb = P[P_REFL + 2] + (1.0f - P[P_REFL + 2]) * p5;
  const float denom = 4.0f * (vx * nxn + vy * nyn + vz * nzn) *
                      (ldx * nxn + ldy * nyn + ldz * nzn);
  const float nol = ldx * nxn + ldy * nyn + ldz * nzn;  // unclamped (wgsl:623)
  const float spec = dterm * gterm / denom;
  const float lm = P[P_LMAG];
  outr = maxp(0.0f, (alr / kPi + spec * fr) * lm * nol);
  outg = maxp(0.0f, (alg / kPi + spec * fg) * lm * nol);
  outb = maxp(0.0f, (alb / kPi + spec * fb) * lm * nol);
}

// Ten resident blocks per SM: at most 48 registers, as the unclipped
// kernel takes on its own (the clipped sweep next to the unclipped one
// would take 85, and half the warps).
constexpr int kMinBlocks = 10;

template <bool COMPOSE, int MASK, bool NO_SWEEP, int OPT = kOptNone>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocks)
    render_kernel(const uint32_t* __restrict__ vol,
                  const uint32_t* __restrict__ coarse, int n, float inv_n,
                  int width, int height, const __grid_constant__ Cam cam,
                  int shadow, const int* __restrict__ colmask, int mask_w,
                  int mask_forced, const float* __restrict__ hist_rgb,
                  const int* __restrict__ hist_idx, float* __restrict__ out_rgb,
                  float* __restrict__ out_depth, int* __restrict__ out_idx,
                  float* __restrict__ out_hist,
                  const uint32_t* __restrict__ ages, int age_bits,
                  int total_states, const uint32_t* __restrict__ planes) {
  __shared__ uint32_t coarse_s[kMaxStagedWords];
  __shared__ OccBox box;
  stage_coarse_box<kBlockX * kBlockY / 32>(coarse, coarse_s, n, inv_n, &box);
  const auto mip = column_gate<OPT>(coarse_s);
  const auto descent = descent_of<OPT>(planes, n >> 3);
  // The inline prologue: warp 0 computes the masks of the block's two
  // patches, 16 lanes each, over the box's columns only (a forced-open gate
  // or an empty box never reads them).
  __shared__ uint32_t patch_s[2];
  if constexpr (MASK == kMaskInline) {
    if (!mask_forced && !box.empty) {
      const int tid = threadIdx.y * blockDim.x + threadIdx.x;
      if (tid < 32) {
        const int m = patch_mask<16>(cam.p, n, coarse_s, 2 * blockIdx.x + (tid >> 4),
                                     blockIdx.y, tid & 15, box.zc0, box.zc1);
        if ((tid & 15) == 0) patch_s[tid >> 4] = (uint32_t)m;
      }
      __syncthreads();
    }
  }
  // Both sweeps clipped to the occupied box, or, where the box is the whole
  // volume, the unclipped sweeps (the same probes without the clip's code).
  const bool clipped = !box.full;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const float* P = cam.p;

  float ux;
  const Ray ray = camera_ray(P, px, py, ux);

  float nx, fx, ny, fy, nz, fz;
  vol_slab(ray.ox, ray.dx, nx, fx);
  vol_slab(ray.oy, ray.dy, ny, fy);
  vol_slab(ray.oz, ray.dz, nz, fz);
  const float tn = maxp(maxp(nx, ny), nz);
  const float tf = minp(minp(fx, fy), fz);
  const bool active = (tn <= tf) && (tf >= 0.0f);
  const float t_start = maxp(tn, 0.0f);
  const float cell_half = inv_n * P[P_CELLMUL] * 0.5f;

  float t_hit = 0.0f;
  int hx = 0, hy = 0, hz = 0;
  bool found = false;
  if (active && !NO_SWEEP) {
    auto primary = [&](const auto& clip) {
      if constexpr (MASK != kMaskNone) {
        // The prepass gate: the mask of the pixel's 8x8 patch, a steep ray,
        // or a window too small for the masks (mask_forced).
        const float adx = fabsf(ray.dx), ady = fabsf(ray.dy), adz = fabsf(ray.dz);
        uint32_t bits;
        if constexpr (MASK == kMaskInline) {
          bits = mask_forced ? 0u : patch_s[threadIdx.x >> 3];
        } else {
          bits = (uint32_t)colmask[(py >> 3) * mask_w + (px >> 3)];
        }
        const ColumnMask gate{bits, mask_forced || adx > 2.0f * adz || ady > 2.0f * adz};
        return sweep<true>(vol, gate, n, inv_n, cell_half, ray, t_start, tf,
                           NoExclusion{}, t_hit, hx, hy, hz, clip, descent);
      } else {
        return sweep<true>(vol, mip, n, inv_n, cell_half, ray, t_start, tf,
                           NoExclusion{}, t_hit, hx, hy, hz, clip, descent);
      }
    };
    found = clipped ? primary(BoxClip{&box}) : primary(NoClip{});
  }
  const float depth = found ? t_hit : (active ? tf : 0.0f);
  const int idx = found ? hx + hy * n + hz * n * n : -1;

  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (found) {
    const float qx = ray.ox + t_hit * ray.dx;
    const float qy = ray.oy + t_hit * ray.dy;
    const float qz = ray.oz + t_hit * ray.dz;
    float occl = 1.0f;
    if (shadow) {
      // Hard shadow: sweep from the hit point toward the light over
      // t in [0, volume exit], excluding the start cell.
      Ray sr;
      sr.ox = qx;
      sr.oy = qy;
      sr.oz = qz;
      sr.dx = P[P_LIGHT] - qx;
      sr.dy = P[P_LIGHT + 1] - qy;
      sr.dz = P[P_LIGHT + 2] - qz;
      normalize3(sr.dx, sr.dy, sr.dz);
      float a0, sfx, sfy, sfz;
      vol_slab(qx, sr.dx, a0, sfx);
      vol_slab(qy, sr.dy, a0, sfy);
      vol_slab(qz, sr.dz, a0, sfz);
      const float sh_tf = minp(minp(sfx, sfy), sfz);
      float t2;
      int x2, y2, z2;
      auto blocked = [&](const auto& clip) {
        return sweep<false>(vol, mip, n, inv_n, cell_half, sr, 0.0f, sh_tf,
                            CellExclusion{hx, hy, hz}, t2, x2, y2, z2, clip,
                            descent);
      };
      if (clipped ? blocked(BoxClip{&box}) : blocked(NoClip{})) {
        occl = 0.0095f;
      }
    }
    const float cox = ((float)hx + 0.5f) * inv_n - 0.5f;
    const float coy = ((float)hy + 0.5f) * inv_n - 0.5f;
    const float coz = ((float)hz + 0.5f) * inv_n - 0.5f;
    const bool use_mat =
        P[P_MATC] != 0.0f || P[P_MATC + 1] != 0.0f || P[P_MATC + 2] != 0.0f;
    const float cxn = (float)hx * inv_n;
    const float cyn = (float)hy * inv_n;
    const float alr = use_mat ? P[P_MATC] : cxn;
    const float alg = use_mat ? P[P_MATC + 1] : cyn;
    const float alb = use_mat ? P[P_MATC + 2] : 1.0f - cxn;
    shade(P, qx, qy, qz, cox, coy, coz, alr, alg, alb, ray.ox, ray.oy, ray.oz,
          r, g, b);
    if (ages != nullptr) {
      occl = occl * age_fade(total_states,
                             fetch_age(ages, age_bits, n, hx, hy, hz));
    }
    r = r * occl;
    g = g * occl;
    b = b * occl;
  }

  const size_t pix = (size_t)py * width + px;
  out_depth[pix] = depth;
  out_idx[pix] = idx;
  if (!COMPOSE) {
    out_rgb[3 * pix + 0] = r;
    out_rgb[3 * pix + 1] = g;
    out_rgb[3 * pix + 2] = b;
    return;
  }

  // Frame composition (render_frame_fast semantics, static camera).
  if (found) {
    const float es = P[P_EMISS];
    r = r + P[P_EMIS] * es;
    g = g + P[P_EMIS + 1] * es;
    b = b + P[P_EMIS + 2] * es;
  }
  const bool same = found && idx == hist_idx[pix];
  const float alpha = P[P_ALPHA];
  float lr = r, lg = g, lb = b;
  if (same) {
    const float pr = hist_rgb[3 * pix + 0];
    const float pg = hist_rgb[3 * pix + 1];
    const float pb = hist_rgb[3 * pix + 2];
    lr = clamp01(pr + (r - pr) * alpha);
    lg = clamp01(pg + (g - pg) * alpha);
    lb = clamp01(pb + (b - pb) * alpha);
  }
  // Light-source cube (wgsl:866-874), drawn over black pixels only
  // (shading.cuh, shared with the shade kernel's composition).
  const bool black = lr == 0.0f && lg == 0.0f && lb == 0.0f;
  if (black && light_cube_hit(P, V3{ray.ox, ray.oy, ray.oz},
                              V3{ray.dx, ray.dy, ray.dz})) {
    lr = 1.0f;
    lg = 1.0f;
    lb = 1.0f;
  }
  // History is the scene with the light cube, before the overlay.
  out_hist[3 * pix + 0] = lr;
  out_hist[3 * pix + 1] = lg;
  out_hist[3 * pix + 2] = lb;
  const bool overlay = P[P_OVERLAY] == 1.0f && ux < 0.5f;
  const float inv_g = 1.0f / P[P_GAMMA];
  out_rgb[3 * pix + 0] = powf(overlay ? depth : lr, inv_g);
  out_rgb[3 * pix + 1] = powf(overlay ? 0.0f : lg, inv_g);
  out_rgb[3 * pix + 2] = powf(overlay ? 0.0f : lb, inv_g);
}

using RenderKernel = decltype(&render_kernel<false, kMaskNone, false>);

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n]; coarse: uint32[n/8, n/8] (ops/occupancy.py);
// cam: host float[40].  colmask: null, or the prepass's i32 column masks
// [ceil(H/8), mask_w = ceil(W/8)] (prepass.cu), which then gate the primary
// sweep's columns; prepass = 1 (colmask null) gates them by the masks the
// kernel computes itself; mask_forced = 1 opens either gate on every
// column (a window too small for the masks: render_fast.py
// mask_gate_forced).
// compose = 0: out_rgb is linear rgb [H, W, 3], hist_* and out_hist unused.
// compose = 1: hist_rgb f32 [H, W, 3] and hist_idx i32 [H, W] are the
// previous frame, out_rgb is the presentation and out_hist the new history
// colour.  ages: null (binary states), or the age bit-planes uint32[age_bits,
// n/32, n, n] of a rule with total_states > 2, of which vol is the
// visibility plane; the hit's age then fades the direct term.  no_sweep = 1
// skips both sweeps (the frame of an empty volume; for timing only).
// The descent options (at most one; with or without prepass, never with
// colmask or no_sweep): planes, the plane mip uint32[n, n/8]
// (ops/occupancy.py plane_occupancy), selects kOptMip1; slicegate = 1
// kOptSliceGate; column_skip = 0 kOptNoSkip (not with prepass either).
// Returns the launch's cudaError_t.
int ca3d_render_fast(int device, const void* vol, const void* coarse, int n,
                     int width, int height, const float* cam, int shadow,
                     const void* colmask, int prepass, int mask_forced,
                     int compose,
                     const void* hist_rgb, const void* hist_idx, void* out_rgb,
                     void* out_depth, void* out_idx, void* out_hist,
                     const void* ages, int age_bits, int total_states,
                     int no_sweep, const void* planes, int slicegate,
                     int column_skip, void* stream) {
  if (n < 32 || n > kMaxStagedGrid || n % 32 != 0 || width < 1 || height < 1) {
    return cudaErrorInvalidValue;
  }
  if (ages != nullptr && (age_bits < 1 || age_bits > 4 || total_states < 2)) {
    return cudaErrorInvalidValue;
  }
  if (prepass && (colmask != nullptr || no_sweep)) {
    return cudaErrorInvalidValue;
  }
  if (compose && (hist_rgb == nullptr || hist_idx == nullptr ||
                  out_hist == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int opt = planes != nullptr ? kOptMip1
                : slicegate        ? kOptSliceGate
                : !column_skip     ? kOptNoSkip
                                   : kOptNone;
  if (opt != kOptNone &&
      ((planes != nullptr) + (slicegate != 0) + (column_skip == 0) > 1 ||
       colmask != nullptr || no_sweep || (opt == kOptNoSkip && prepass))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Cam c;
  for (int i = 0; i < P_LEN; ++i) c.p[i] = cam[i];
  const float inv_n = (float)(1.0 / (double)n);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  static const RenderKernel kernels[8] = {
      render_kernel<false, kMaskNone, false>,
      render_kernel<true, kMaskNone, false>,
      render_kernel<false, kMaskGiven, false>,
      render_kernel<true, kMaskGiven, false>,
      render_kernel<false, kMaskInline, false>,
      render_kernel<true, kMaskInline, false>,
      render_kernel<false, kMaskNone, true>,
      render_kernel<true, kMaskNone, true>};
  // The options' instantiations: [opt - 1][prepass][compose].
  static const RenderKernel option_kernels[3][2][2] = {
      {{render_kernel<false, kMaskNone, false, kOptMip1>,
        render_kernel<true, kMaskNone, false, kOptMip1>},
       {render_kernel<false, kMaskInline, false, kOptMip1>,
        render_kernel<true, kMaskInline, false, kOptMip1>}},
      {{render_kernel<false, kMaskNone, false, kOptSliceGate>,
        render_kernel<true, kMaskNone, false, kOptSliceGate>},
       {render_kernel<false, kMaskInline, false, kOptSliceGate>,
        render_kernel<true, kMaskInline, false, kOptSliceGate>}},
      {{render_kernel<false, kMaskNone, false, kOptNoSkip>,
        render_kernel<true, kMaskNone, false, kOptNoSkip>},
       {nullptr, nullptr}}};
  const int mode = no_sweep ? 3
                 : prepass  ? kMaskInline
                            : (colmask != nullptr ? kMaskGiven : kMaskNone);
  const int slot = mode * 2 + (compose != 0);
  const RenderKernel kernel =
      opt == kOptNone ? kernels[slot]
                      : option_kernels[opt - 1][prepass != 0][compose != 0];
  kernel<<<grid, dim3(kBlockX, kBlockY), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vol), static_cast<const uint32_t*>(coarse),
      n, inv_n, width, height, c, shadow, static_cast<const int*>(colmask),
      (width + 7) / 8, mask_forced, static_cast<const float*>(hist_rgb),
      static_cast<const int*>(hist_idx), static_cast<float*>(out_rgb),
      static_cast<float*>(out_depth), static_cast<int*>(out_idx),
      static_cast<float*>(out_hist), static_cast<const uint32_t*>(ages),
      age_bits, total_states, static_cast<const uint32_t*>(planes));
  return cudaGetLastError();
}

}  // extern "C"
