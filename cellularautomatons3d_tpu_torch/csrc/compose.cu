// The composition of a fast-path frame: one launch takes the traced and
// shaded frame (rgb, depth, ids) and the f16 history to the presentation
// and the new history.
//
// Replaces: render_frame_fast after trace_shaded in
// cellularautomatons3d_tpu/render/renderer_fast.py:250-315 (the window
// rays, the static EMA or the moved branch :265-293 with render/renderer.py
// _get_reprojected_uv, the light cube, the f16 history, the depth overlay
// and gamma), which JAX fuses under jit.  Its plain twin is the port's
// render/renderer_fast.py compose_frame, which eager torch runs as ~50
// launches with a static camera and ~160 with a moved one; this is one.
//
// One thread a pixel, each step in the twin's order and rounding (built
// with --fmad=false, IEEE division and sqrt):
//   * the window ray of pixel_uvs / get_ray (row0 / full_height place a row
//     shard in its window), normalised by a division by its norm, and
//     rotated by the view one component at a time, (rx v0 + ry v1) + rz v2;
//   * static camera: the EMA clamp(prev + (rgb - prev) * alpha, 0, 1) where
//     the history's id is this pixel's hit;
//   * moved camera: the hit point view[:, 3] + d * depth projected through
//     the previous view-projection, each row summed left to right, divided
//     by w, y flipped; the bounds test, out-of-bounds and NaN uv zeroed
//     before the truncating conversion; the history's colour (f16) and id
//     gathered at the source pixel; the EMA where the source is in this
//     shard's rows, the pixel hit a cell and the ids agree;
//   * the light cube (half size 0.005 at the light) on black pixels;
//   * the new history colour, rounded to f16 (nearest even);
//   * the depth overlay on the left half of the window, then torch's
//     pow(out, 1 / gamma) (shading.cuh torch_pow: sqrt for gamma 2).
// Only a pixel that blends reads the history's colour, and only a hit (in
// bounds, when moved) its id.  With the debug outputs (the moved mode of
// reproject_history_cuda) it also writes the blended rgb before the light
// cube, the source pixel and the valid mask.
// Bound: bytes.  Each pixel reads its rgb, id and (moved, or under the
// overlay) depth and writes the presentation and the f16 history: 38-42 B;
// the history's id on hits and its colour on blending pixels: ~0.025 ms at
// 1080p on 3.35 TB/s.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "shading.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 256;

struct Compose {
  float view[12];   // view_mat[:3, :], row-major
  float ppv[16];    // prev_proj_view, row-major (moved camera)
  float r;          // float32(w) / float32(full_height)
  float rz;         // -(0.5 * COT_HALF_FOV), float32
  float alpha;      // temporal_alpha
  float light[3];   // light_pos
  float inv_g;      // float32(1) / gamma
  float overlay;    // show_depth_overlay
  int w, h, fh, row0;
};
constexpr int kComposeConsts = 36;

template <bool MOVED>
__global__ void __launch_bounds__(kThreads)
    compose_kernel(const Compose p, const __half* __restrict__ color,
                   const int* __restrict__ hit_idx, const float* __restrict__ rgb,
                   const float* __restrict__ depth, const int* __restrict__ idx,
                   float* __restrict__ pres, __half* __restrict__ new_color,
                   float* __restrict__ blend, int64_t* __restrict__ src,
                   uint8_t* __restrict__ valid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.w * p.h) return;
  const int x = i % p.w, y = i / p.w;
  // pixel_uvs: (i + 0.5) / w, 1 - (j + row0 + 0.5) / full_height.
  const float u = ((float)x + 0.5f) / (float)p.w;
  const float v = 1.0f - (((float)y + (float)p.row0) + 0.5f) / (float)p.fh;
  float rx = (u - 0.5f) * p.r;
  float ry = v - 0.5f;
  float rz = p.rz;
  const float norm = sqrtf(rx * rx + ry * ry + rz * rz);
  rx = rx / norm;
  ry = ry / norm;
  rz = rz / norm;
  V3 d;
  d.x = rx * p.view[0] + ry * p.view[1] + rz * p.view[2];
  d.y = rx * p.view[4] + ry * p.view[5] + rz * p.view[6];
  d.z = rx * p.view[8] + ry * p.view[9] + rz * p.view[10];
  const V3 o{p.view[3], p.view[7], p.view[11]};
  const int id = idx[i];
  const float a[3] = {rgb[3 * (size_t)i], rgb[3 * (size_t)i + 1], rgb[3 * (size_t)i + 2]};
  bool blends;
  int64_t flat = 0;
  bool in_bounds = false;
  float dep = 0.0f;
  if constexpr (MOVED) {
    dep = depth[i];
    const float hit[3] = {o.x + d.x * dep, o.y + d.y * dep, o.z + d.z * dep};
    float row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[k] = hit[0] * p.ppv[4 * k] + hit[1] * p.ppv[4 * k + 1] + hit[2] * p.ppv[4 * k + 2] +
               p.ppv[4 * k + 3];
    }
    const float cx = row[0] / row[3];
    const float cy = row[1] / row[3];
    float ux = cx * 0.5f + 0.5f;
    float uy = -cy * 0.5f + 0.5f;
    in_bounds = ux >= 0.0f && ux <= 1.0f && uy >= 0.0f && uy <= 1.0f;
    if (!in_bounds) ux = uy = 0.0f;
    const int px = min(max((int)(ux * (float)p.w), 0), p.w - 1);
    const int py_g = (int)(uy * (float)p.fh) - p.row0;
    in_bounds = in_bounds && py_g >= 0 && py_g < p.h;
    flat = (int64_t)min(max(py_g, 0), p.h - 1) * p.w + px;
    blends = in_bounds && id >= 0 && hit_idx[flat] == id;
  } else {
    flat = i;
    blends = id >= 0 && hit_idx[i] == id;
  }
  V3 c{a[0], a[1], a[2]};
  if (blends) {
    const float pr = __half2float(color[3 * flat]);
    const float pg = __half2float(color[3 * flat + 1]);
    const float pb = __half2float(color[3 * flat + 2]);
    c = {clamp01(pr + (a[0] - pr) * p.alpha), clamp01(pg + (a[1] - pg) * p.alpha),
         clamp01(pb + (a[2] - pb) * p.alpha)};
  }
  if (blend != nullptr) {
    blend[3 * (size_t)i] = c.x;
    blend[3 * (size_t)i + 1] = c.y;
    blend[3 * (size_t)i + 2] = c.z;
    if (src != nullptr) {
      src[i] = in_bounds ? flat : -1;
      valid_out[i] = blends;
    }
  }
  if (pres == nullptr) return;
  // The light cube on black pixels (wgsl:866-874).
  if (c.x == 0.0f && c.y == 0.0f && c.z == 0.0f) {
    float tn, tf;
    ray_cube_intersect(o, d, V3{p.light[0], p.light[1], p.light[2]}, (float)0.005, tn, tf);
    if (tn <= tf && tf >= 0.0f) c = {1.0f, 1.0f, 1.0f};
  }
  new_color[3 * (size_t)i] = __float2half_rn(c.x);
  new_color[3 * (size_t)i + 1] = __float2half_rn(c.y);
  new_color[3 * (size_t)i + 2] = __float2half_rn(c.z);
  // The depth overlay (wgsl:880-883), then gamma.
  if (p.overlay == 1.0f && u < 0.5f) {
    if constexpr (!MOVED) dep = depth[i];
    c = {dep, 0.0f, 0.0f};
  }
  pres[3 * (size_t)i] = torch_pow(c.x, p.inv_g);
  pres[3 * (size_t)i + 1] = torch_pow(c.y, p.inv_g);
  pres[3 * (size_t)i + 2] = torch_pow(c.z, p.inv_g);
}

}  // namespace

extern "C" {

// color: half[h, w, 3] and hit_idx int32[h, w]: the history; rgb float[h,
// w, 3], depth float[h, w] and idx int32[h, w]: trace_shaded's frame;
// consts: host float[36] = view_mat[:3, :] row-major, prev_proj_view
// row-major, r, rz, alpha, light_pos, 1 / gamma, show_depth_overlay.
// moved = 0: the static EMA; 1: the moved camera's reprojection.  Outputs:
// pres float[h, w, 3] and new_color half[h, w, 3], both given or both null;
// the debug outputs (moved only) blend float[h, w, 3], with src int64[h, w]
// and valid uint8[h, w] both null or both given.  Returns the launch's
// cudaError_t.
int ca3d_compose(int device, const void* color, const void* hit_idx, const void* rgb,
                 const void* depth, const void* idx, int w, int h, int full_height, int row0,
                 int moved, const float* consts, void* pres, void* new_color, void* blend,
                 void* src, void* valid, void* stream) {
  if (w <= 0 || h <= 0 || full_height < h || row0 < 0 || row0 + h > full_height ||
      (long long)w * h > INT32_MAX || (pres == nullptr) != (new_color == nullptr) ||
      (src == nullptr) != (valid == nullptr) || (src != nullptr && blend == nullptr) ||
      (blend != nullptr && !moved) || (pres == nullptr && blend == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static_assert(sizeof(Compose) == (kComposeConsts + 4) * sizeof(float),
                "Compose is the host's float vector and four ints");
  Compose p;
  float* f = reinterpret_cast<float*>(&p);
  for (int k = 0; k < kComposeConsts; ++k) f[k] = consts[k];
  p.w = w;
  p.h = h;
  p.fh = full_height;
  p.row0 = row0;
  const int total = w * h;
  const auto kernel = moved ? compose_kernel<true> : compose_kernel<false>;
  kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const __half*>(color), static_cast<const int*>(hit_idx),
      static_cast<const float*>(rgb), static_cast<const float*>(depth),
      static_cast<const int*>(idx), static_cast<float*>(pres),
      static_cast<__half*>(new_color), static_cast<float*>(blend),
      static_cast<int64_t*>(src), static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // extern "C"
