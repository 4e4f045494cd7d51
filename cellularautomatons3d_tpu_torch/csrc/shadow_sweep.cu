// K2: cell-exact occlusion of a batch of per-pixel shadow rays, one thread
// per (query, pixel).
//
// Replaces: cellularautomatons3d_tpu/render/render_slab.py,
// _make_shadow_kernel_sweep (launched by _shadow_occlusion_sweep, the
// default backend of shadow_occlusion_batch), for the whole volume of any
// grid up to 1024^3 in one launch (the reference runs one launch per
// z-slab / x-brick and ORs them).  Per (query, pixel): the ray from the
// start point toward the target, normalised with 1/sqrtf; its exit from
// the unit volume (the reference's occlusion prep, with divisions); then
// the sweep of sweep.cuh over t in [0, exit] with the shadow accept rule
// tN >= 0, skipping the excluded cell component by component.  Inactive
// lanes return 0.  The soft-shadow samples and the GI slots of a frame
// come in one launch, one grid z-slice per query; above 256^3 the frame's
// hard shadow comes this way too.
//
// Operands are structure-of-arrays: start/target f32 [nq, 3, H, W], excl
// i32 [nq, 3, H, W], active u8 [nq, H, W] -> i32 [nq, H, W] (~41 B per
// query-pixel).
//
// Bound on the H100: dependent loads of packed words on occupied columns
// (from L2 up to 256^3, where the 2 MiB volume is resident; from HBM for
// the probes that miss L2 at 1024^3, whose volume is 128 MiB), plus the
// coarse mip: staged in shared memory by every 128-thread block up to
// 256^3 (4 KiB), read through the read-only path from L2 above (32 KiB at
// 512^3, 256 KiB at 1024^3).  Rays of neighbouring pixels of one query are
// coherent in a 16x8 block.  The queries of one pixel sharing a traversal
// are K5 (shadow_multi.cu), the opt-in backend.  Left for later PRs: the
// reference's start-column gate.

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <bool STAGED>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    shadow_sweep_kernel(const uint32_t* __restrict__ vol,
                        const uint32_t* __restrict__ coarse, int n,
                        float inv_n, float cell_half, int width, int height,
                        const float* __restrict__ start,
                        const float* __restrict__ target,
                        const int* __restrict__ excl,
                        const uint8_t* __restrict__ active,
                        int* __restrict__ out) {
  __shared__ uint32_t coarse_s[STAGED ? kMaxStagedWords : 1];
  if constexpr (STAGED) stage_coarse(coarse, coarse_s, n);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const size_t npix = (size_t)width * height;
  const size_t pix = (size_t)py * width + px;
  const size_t q = blockIdx.z;
  const size_t i1 = q * npix + pix;      // [nq, H, W]
  const size_t i3 = 3 * q * npix + pix;  // [nq, 3, H, W], component 0
  int occluded = 0;
  if (active[i1]) {
    Ray r;
    r.ox = start[i3];
    r.oy = start[i3 + npix];
    r.oz = start[i3 + 2 * npix];
    r.dx = target[i3] - r.ox;
    r.dy = target[i3 + npix] - r.oy;
    r.dz = target[i3 + 2 * npix] - r.oz;
    normalize3(r.dx, r.dy, r.dz);
    // Volume exit: min over axes of max((-0.5 - s) / d, (0.5 - s) / d).
    const float ex = maxp((-0.5f - r.ox) / r.dx, (0.5f - r.ox) / r.dx);
    const float ey = maxp((-0.5f - r.oy) / r.dy, (0.5f - r.oy) / r.dy);
    const float ez = maxp((-0.5f - r.oz) / r.dz, (0.5f - r.oz) / r.dz);
    const float t1 = minp(minp(ex, ey), ez);
    float t_hit;
    int hx, hy, hz;
    const CellExclusion skip{excl[i3], excl[i3 + npix], excl[i3 + 2 * npix]};
    occluded = sweep<false>(vol, mip_of<STAGED>(coarse, coarse_s), n, inv_n,
                            cell_half, r, 0.0f, t1, skip, t_hit, hx, hy, hz)
                   ? 1
                   : 0;
  }
  out[i1] = occluded;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coarse: uint32[n/8, XG*n/8]
// (ops/occupancy.py, XG = ceil(n/256)); start, target: f32 [nq, 3, H, W];
// excl: i32 [nq, 3, H, W]; active: u8 [nq, H, W]; out: i32 [nq, H, W]
// (1 = occluded).  cell_half is the
// visible cube's half size, (1/n) * cell_size * 0.5 in f32.  Returns the
// launch's cudaError_t.
int ca3d_shadow_sweep(int device, const void* vol, const void* coarse, int n,
                      float cell_half, int width, int height, int nq,
                      const void* start, const void* target, const void* excl,
                      const void* active, void* out, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      nq < 1 || nq > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float inv_n = (float)(1.0 / (double)n);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, nq);
  auto kernel = n <= kMaxStagedGrid ? shadow_sweep_kernel<true>
                                    : shadow_sweep_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vol), static_cast<const uint32_t*>(coarse),
      n, inv_n, cell_half, width, height, static_cast<const float*>(start),
      static_cast<const float*>(target), static_cast<const int*>(excl),
      static_cast<const uint8_t*>(active), static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
