// K4: the primary hit of every pixel of a frame, over the whole volume of
// any grid up to 1024^3, one thread per pixel, one launch.
//
// Replaces: cellularautomatons3d_tpu/render/render_slab.py,
// _make_primary_kernel (launched by raytrace_sliced), which traces one
// z-slab / x-brick per launch and leaves the frame's first hit to a min-t
// composite over bricks.  Here one sweep crosses every plane, so the
// composite, its cross-brick best-t carry and the view-dependent brick
// order have nothing to do.  Per pixel: the camera ray
// (_pixel_rays_kernel), the volume entry and exit, and the primary sweep
// of sweep.cuh from t_start = max(entry, 0) to the exit.  Out: t f32 (the
// hit's visible-cube entry, 0 for a miss) and id i32 (x + y*n + z*n*n,
// -1 for a miss), [H, W]; with age planes (multi-state rules) also age i32,
// the hit cell's age fetched from them, 1 for a miss.  Shading, the age
// fade, shadows and GI stay in torch and K2/K3, as in the reference; its
// per-brick age layouts and the age merge across bricks are brick machinery
// and have no counterpart.
//
// Design on the H100 (one thread per pixel, 16x8 blocks): about 93 % of
// the rays of the sparse scenes miss, and each used to walk every 8-plane
// column of its z extent, up to n/8, with four cell lookups and a mip test
// per column; above 256^3 the mip (32 KiB at 512^3, 256 KiB at 1024^3) is
// read from L2 through the read-only path.  Now one launch of
// occupied_box.cu, enqueued by the entry point just before this kernel,
// reduces the mip to the box of occupied blocks.  This kernel is launched
// as its programmatic dependent: its blocks may start while the box kernel
// runs, set up their rays, and wait for it only to read the box (load_box).
// An empty box skips the sweep (every pixel misses), a whole-volume
// box runs the unclipped sweep (the clip alone there cost 3.5 %: camera
// rays start outside the volume, so it has nothing to cut; PERF.md §6),
// any other box the sweep clipped to it (BoxClip: only the columns and
// t-range inside the box, exact).  Up to
// 256^3 each block stages the 4 KiB mip in shared memory, unless the box
// is empty.  40 registers, no spill, with or without a cap.  Bound: per
// pixel the column tests and probes of the columns inside the box; the
// volume is L2-resident up to 512^3 (16 MiB) and not at 1024^3 (128 MiB),
// where the probes of occupied columns go to HBM.  Inside the box the
// column walk takes most of the time at 512^3, the probes at 1024^3
// (PERF.md §6).  The age fetch adds age_bits <= 4 word loads per hit pixel,
// after the sweep.  SKIP = false (column_skip = 0, the column skip's
// attribution run; no frame path sets it) descends every column of the box
// (AllColumns) and stages no mip: the hits are the same.

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <bool STAGED, bool SKIP = true>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    primary_sweep_kernel(const uint32_t* __restrict__ vol,
                         const uint32_t* __restrict__ coarse,
                         const OccBox* occ, int n, float inv_n,
                         int width, int height,
                         const __grid_constant__ Cam cam,
                         float* __restrict__ out_t, int* __restrict__ out_idx,
                         const uint32_t* __restrict__ ages, int age_bits,
                         int* __restrict__ out_age) {
  __shared__ uint32_t coarse_s[STAGED && SKIP ? kMaxStagedWords : 1];
  __shared__ OccBox box;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const float* P = cam.p;

  // The ray first, while the box kernel may still run.
  float ux;
  const Ray ray = camera_ray(P, px, py, ux);
  float nx, fx, ny, fy, nz, fz;
  vol_slab(ray.ox, ray.dx, nx, fx);
  vol_slab(ray.oy, ray.dy, ny, fy);
  vol_slab(ray.oz, ray.dz, nz, fz);
  const float tn = maxp(maxp(nx, ny), nz);
  const float tf = minp(minp(fx, fy), fz);
  load_box(occ, &box, threadIdx.y * blockDim.x + threadIdx.x);
  __syncthreads();
  if constexpr (STAGED && SKIP) {
    if (!box.empty) stage_coarse(coarse, coarse_s, n);
  }
  if (px >= width || py >= height) return;
  const bool active = (tn <= tf) && (tf >= 0.0f) && !box.empty;
  const float t_start = maxp(tn, 0.0f);
  const float cell_half = inv_n * P[P_CELLMUL] * 0.5f;

  float t_hit = 0.0f;
  int hx = 0, hy = 0, hz = 0;
  bool found = false;
  if (active) {
    auto primary = [&](const auto& clip) {
      return sweep<true>(vol, skip_gate<STAGED, SKIP>(coarse, coarse_s), n,
                         inv_n, cell_half, ray, t_start, tf, NoExclusion{},
                         t_hit, hx, hy, hz, clip);
    };
    found = box.full ? primary(NoClip{}) : primary(BoxClip{&box});
  }
  const size_t pix = (size_t)py * width + px;
  out_t[pix] = found ? t_hit : 0.0f;
  out_idx[pix] = found ? hx + hy * n + hz * n * n : -1;
  if (ages != nullptr) {
    out_age[pix] = found ? fetch_age(ages, age_bits, n, hx, hy, hz) : 1;
  }
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coarse: uint32[n/8, XG*n/8]
// (ops/occupancy.py, XG = ceil(n/256)), 16-byte aligned; cam: host
// float[40] (render_fast.py pack_cam); out_t: f32 [H, W]; out_idx: i32
// [H, W].  ages: null, or the age bit-planes uint32[age_bits, n/32, n, n]
// of which vol is the visibility plane, and out_age: i32 [H, W] then takes
// each hit's age.  box: int32[8], scratch for the launch's OccBox, which
// the box kernel enqueued here writes first; box_launches: a host int that
// counts that launch (one added once it is enqueued).  column_skip = 0
// descends every column of the box (SKIP = false).  Returns the first
// launch error (cudaError_t).
int ca3d_primary_sweep_ages(int device, const void* vol, const void* coarse,
                            int n, int width, int height, const float* cam,
                            void* out_t, void* out_idx, const void* ages,
                            int age_bits, void* out_age, int column_skip,
                            void* box, int* box_launches, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      box_launches == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (ages != nullptr && (age_bits < 1 || age_bits > 4 || out_age == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto occ = static_cast<OccBox*>(box);
  err = launch_occupied_box(static_cast<const uint32_t*>(coarse), n, occ, s);
  if (err != cudaSuccess) return err;
  *box_launches += 1;
  Cam c;
  for (int i = 0; i < P_LEN; ++i) c.p[i] = cam[i];
  const float inv_n = (float)(1.0 / (double)n);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  auto kernel = !column_skip            ? primary_sweep_kernel<false, false>
                : n <= kMaxStagedGrid ? primary_sweep_kernel<true>
                                      : primary_sweep_kernel<false>;
  return launch_after_box(
      kernel, grid, block, s, static_cast<const uint32_t*>(vol),
      static_cast<const uint32_t*>(coarse), occ, n, inv_n, width, height, c,
      static_cast<float*>(out_t), static_cast<int*>(out_idx),
      static_cast<const uint32_t*>(ages), age_bits, static_cast<int*>(out_age));
}

// The binary frame: ca3d_primary_sweep_ages without age planes.
int ca3d_primary_sweep(int device, const void* vol, const void* coarse, int n,
                       int width, int height, const float* cam, void* out_t,
                       void* out_idx, void* box, int* box_launches,
                       void* stream) {
  return ca3d_primary_sweep_ages(device, vol, coarse, n, width, height, cam,
                                 out_t, out_idx, nullptr, 0, nullptr, 1, box,
                                 box_launches, stream);
}

}  // extern "C"
