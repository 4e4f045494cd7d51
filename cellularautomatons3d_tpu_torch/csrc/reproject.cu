// The moving camera's temporal EMA: the history reprojected into a frame
// whose camera moved since the history's frame.
//
// Replaces: the moved branch of render_frame_fast in
// cellularautomatons3d_tpu/render/renderer_fast.py:265-293, with
// render/renderer.py _get_reprojected_uv (XLA in the reference).  Its plain
// twin is the port's render/renderer_fast.py reproject_history, which eager
// torch runs as ~110 launches; this is one.
//
// One thread a pixel, each step in the twin's order and rounding (built
// with --fmad=false, IEEE division and sqrt): the window ray of pixel_uvs /
// get_ray (row0 / full_height place a row shard in its window), normalised;
// the hit point view[:, 3] + (view[:, :3] . ray) * depth one component at a
// time; its projection through the previous view-projection, each row
// summed left to right, divided by w, y flipped; the bounds test, with
// out-of-bounds and NaN uv zeroed before the truncating conversion; the
// history's colour (f16) and id gathered at the source pixel; the blend
// clamp(prev + (rgb - prev) * alpha, 0, 1) where the source is in this
// shard's rows, the pixel hit a cell and the ids agree.  Only such a
// pixel reads the history's colour, and only an in-bounds hit its id.
// Bound: bytes, each pixel's rgb, depth, id and output once (32 B), the
// source id of the in-bounds hits (4 B) and the colour of the blended
// pixels (6 B): ~0.02-0.03 ms at 1080p on 3.35 TB/s.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Reproj {
  float view[12];  // view_mat[:3, :], row-major
  float ppv[16];   // prev_proj_view, row-major
  float r;         // float32(w) / float32(full_height)
  float rz;        // -(0.5 * COT_HALF_FOV), float32
  float alpha;     // temporal_alpha
  int w, h, fh, row0;
};

// torch.clamp(v, 0, 1) on the card: NaN passes, else min(max(v, 0), 1).
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
    reproject_kernel(const Reproj p, const __half* __restrict__ color,
                     const int* __restrict__ hit_idx, const float* __restrict__ rgb,
                     const float* __restrict__ depth, const int* __restrict__ idx,
                     float* __restrict__ out, int64_t* __restrict__ src,
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
  const float d = depth[i];
  float hit[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hit[k] = p.view[4 * k + 3] +
             (rx * p.view[4 * k] + ry * p.view[4 * k + 1] + rz * p.view[4 * k + 2]) * d;
  }
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
  bool in_bounds = ux >= 0.0f && ux <= 1.0f && uy >= 0.0f && uy <= 1.0f;
  if (!in_bounds) ux = uy = 0.0f;
  const int px = min(max((int)(ux * (float)p.w), 0), p.w - 1);
  const int py_g = (int)(uy * (float)p.fh) - p.row0;
  in_bounds = in_bounds && py_g >= 0 && py_g < p.h;
  const int64_t flat = (int64_t)min(max(py_g, 0), p.h - 1) * p.w + px;
  const int id = idx[i];
  const bool valid = in_bounds && id >= 0 && hit_idx[flat] == id;
  float prev[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
#pragma unroll
    for (int c = 0; c < 3; ++c) prev[c] = __half2float(color[3 * flat + c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = rgb[3 * (size_t)i + c];
    out[3 * (size_t)i + c] = valid ? clamp01(prev[c] + (a - prev[c]) * p.alpha) : a;
  }
  if (src != nullptr) {
    src[i] = in_bounds ? flat : -1;
    valid_out[i] = valid;
  }
}

}  // namespace

extern "C" {

// color: half[h, w, 3]; hit_idx, idx: int32[h, w]; rgb: float[h, w, 3];
// depth: float[h, w]; consts: host float[31] = view_mat[:3, :] row-major,
// prev_proj_view row-major, r, rz, alpha; out: float[h, w, 3]; src
// (int64[h, w]) and valid (uint8[h, w]) both null or both given.  Returns
// the launch's cudaError_t.
int ca3d_reproject(int device, const void* color, const void* hit_idx, const void* rgb,
                   const void* depth, const void* idx, int w, int h, int full_height,
                   int row0, const float* consts, void* out, void* src, void* valid,
                   void* stream) {
  if (w <= 0 || h <= 0 || full_height < h || row0 < 0 || row0 + h > full_height ||
      (src == nullptr) != (valid == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Reproj p;
  for (int k = 0; k < 12; ++k) p.view[k] = consts[k];
  for (int k = 0; k < 16; ++k) p.ppv[k] = consts[12 + k];
  p.r = consts[28];
  p.rz = consts[29];
  p.alpha = consts[30];
  p.w = w;
  p.h = h;
  p.fh = full_height;
  p.row0 = row0;
  const int total = w * h;
  reproject_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const __half*>(color), static_cast<const int*>(hit_idx),
      static_cast<const float*>(rgb), static_cast<const float*>(depth),
      static_cast<const int*>(idx), static_cast<float*>(out),
      static_cast<int64_t*>(src), static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // extern "C"
