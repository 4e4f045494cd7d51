// K6: the patch prepass, one conservative column mask per 8x8 pixel patch,
// one thread per patch.
//
// Replaces: cellularautomatons3d_tpu/render/render_fast.py, _make_prepass
// (launched by _prepass_mask), whose masks gate K1's primary sweep under
// raytrace_tiles(use_prepass=True).  Per patch: the ray of the patch
// centre pixel (px = (p mod pw)*8 + 4, no +0.5, the shard's row offset
// P_ROW0) over the volume box grown by m = 0.035; bit c of the mask is set
// when one of three probes (the ends and the midpoint of the ray's clipped
// segment in 8-plane column c) lands in an occupied block of coarse_pre,
// the coarse mip dilated by two blocks in x and one in y (ops/occupancy.py
// dilate_occupancy, twice), clipped into the grid as
// _fetch_coarse_bit_impl does.  Steep patches (|dxy| > 2|dz| - 0.03), far
// ones (t1 * 0.0075 n > 7) and degenerate ones get all ones (-1); a patch
// whose ray misses the grown box gets 0.
//
// Float rules: the reference's operation order; rsqrt is 1/sqrtf as in
// every port kernel, and the column planes' (c*8/n - 0.5) is evaluated in
// double and rounded once, as the reference's Python scalar arithmetic is.
// The build has --fmad=false and IEEE division/sqrt.
//
// Bound on the H100: 32,400 patches at 1080p, each 32 columns x 3 probes of
// a 4 KiB mip that every block stages in shared memory; a few microseconds
// of float work and 130 KB written.  The launch dominates.

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kPatch = 8;
constexpr int kThreads = 128;
constexpr double kMargin = 0.035;   // grown-box margin
constexpr double kPreDev = 0.0075;  // per-unit-t bound on bundle deviation

__global__ void __launch_bounds__(kThreads)
    prepass_kernel(const uint32_t* __restrict__ coarse_pre, int n, int pw,
                   int npatch, const __grid_constant__ Cam cam,
                   int* __restrict__ out) {
  __shared__ uint32_t coarse_s[kMaxStagedWords];
  const int nbk = n >> 3;
  for (int i = threadIdx.x; i < nbk * nbk; i += blockDim.x) {
    coarse_s[i] = coarse_pre[i];
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npatch) return;
  const float* P = cam.p;

  const int px = (p % pw) * kPatch + kPatch / 2;
  const int py = (p / pw) * kPatch + kPatch / 2;
  const float win_w = P[P_WIN], win_h = P[P_WIN + 1];
  const float ux = (float)px / win_w;
  const float uy = 1.0f - ((float)py + P[P_ROW0]) / win_h;
  float rx = (ux - 0.5f) * (win_w / win_h);
  float ry = uy - 0.5f;
  float rz = kRayZ;
  normalize3(rx, ry, rz);
  const float dx = P[0] * rx + P[1] * ry + P[2] * rz;
  const float dy = P[3] * rx + P[4] * ry + P[5] * rz;
  const float dz = P[6] * rx + P[7] * ry + P[8] * rz;
  const float ox = P[P_O], oy = P[P_O + 1], oz = P[P_O + 2];

  // The grown box [-(0.5 + m), 0.5 + m] along each axis.
  const float hm = (float)(0.5 + kMargin);
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float t1x = (-hm - ox) * ix, t2x = (hm - ox) * ix;
  const float t1y = (-hm - oy) * iy, t2y = (hm - oy) * iy;
  const float t1z = (-hm - oz) * iz, t2z = (hm - oz) * iz;
  const float tn = maxp(maxp(minp(t1x, t2x), minp(t1y, t2y)), minp(t1z, t2z));
  const float tf = minp(minp(maxp(t1x, t2x), maxp(t1y, t2y)), maxp(t1z, t2z));
  const bool active = (tn <= tf) && (tf >= 0.0f);
  const float t0 = maxp(tn, 0.0f);
  const float t1 = tf;
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const bool steep =
      (adx > 2.0f * adz - 0.03f) || (ady > 2.0f * adz - 0.03f);
  const bool is_far = t1 * (float)(kPreDev * n) > 7.0f;
  if (!active) {
    out[p] = 0;
    return;
  }
  if (steep || is_far) {
    out[p] = -1;
    return;
  }

  const double inv_n = 1.0 / n;
  const float fnb = (float)nbk;
  uint32_t mask = 0u;
  for (int c = 0; c < nbk; ++c) {
    const float za = (float)((double)(c * 8) * inv_n - 0.5);
    const float zb = (float)((double)(c * 8 + 8) * inv_n - 0.5);
    const float ta = (za - oz) * iz;
    const float tb = (zb - oz) * iz;
    const float lo = maxp(minp(ta, tb), t0);
    const float hi = minp(maxp(ta, tb), t1);
    if (!(lo < hi)) continue;
    const float probes[3] = {lo, 0.5f * (lo + hi), hi};
    bool occ = false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float tp = probes[j];
      const float bx = floorf((ox + tp * dx + 0.5f) * fnb);
      const float by = floorf((oy + tp * dy + 0.5f) * fnb);
      const int bxc = (int)fminf(fmaxf(bx, 0.0f), (float)(nbk - 1));
      const int byc = (int)fminf(fmaxf(by, 0.0f), (float)(nbk - 1));
      occ = occ || ((coarse_s[c * nbk + byc] >> (bxc & 31)) & 1u);
    }
    if (occ) mask |= 1u << c;
  }
  out[p] = (int)mask;
}

}  // namespace

extern "C" {

// coarse_pre: uint32[n/8, n/8], n <= 256 (the doubly dilated mip); cam:
// host float[40] (render_fast.py pack_cam); out: i32 [ceil(H/8),
// ceil(W/8)].  Returns the launch's cudaError_t.
int ca3d_prepass(int device, const void* coarse_pre, int n, int width,
                 int height, const float* cam, void* out, void* stream) {
  if (n < 32 || n > kMaxStagedGrid || n % 32 != 0 || width < 1 || height < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Cam c;
  for (int i = 0; i < P_LEN; ++i) c.p[i] = cam[i];
  const int pw = (width + kPatch - 1) / kPatch;
  const int ph = (height + kPatch - 1) / kPatch;
  const int npatch = pw * ph;
  prepass_kernel<<<(npatch + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(coarse_pre), n, pw, npatch, c,
      static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
