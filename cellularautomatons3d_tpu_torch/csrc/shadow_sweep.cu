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
// Design on the H100 (one thread per (query, pixel), 16x8 blocks, one
// grid z-slice per query): only hit pixels cast shadow and GI rays, so
// about 93 % of the lanes of the sparse scenes, and most whole blocks, are
// inactive.  A block first reads its lanes' active flags, and a block with
// none (or an empty volume) writes its zeros and leaves before it touches
// the mip.  One launch of occupied_box.cu, enqueued by the entry point just
// before this kernel, reduces the mip to the box of occupied blocks (this
// kernel may start while it runs, loads its flags, and waits for it only to
// read the box: a programmatic dependent launch); the active rays sweep
// clipped to it (BoxClip: only the columns and t-range inside the box,
// exact from any start, inside the box or not).  The clip also serves a
// whole-volume box: its walk starts at the ray's start column, where an
// unclipped one would step from the volume's face through the columns
// behind a start inside the volume (PERF.md §6).  Up to 256^3 an active
// block stages the 4 KiB mip in shared memory; above, the mip is read from
// L2 (32 KiB at 512^3, 256 KiB at 1024^3).  40 registers, no spill, with
// or without a cap.  One query per block keeps the sweeps of a query's
// coherent rays together and lets idle blocks free their slots at once;
// blocks that walk a tile's queries in turn were slower (PERF.md §6).
// Bound: the operands of the active lanes, every lane's flag and output
// (~5 B), and the column tests and probes inside the box; the probes are L2
// hits up to 512^3 and go to HBM when they miss L2 at 1024^3 (128 MiB).
// About half of a frame's 8 queries at 256^3 is the floor of its idle
// blocks, each a flag load and a store.  K5 (shadow_multi.cu), the opt-in
// backend, runs the same sweep on operands it reads where the lighting code
// leaves them.  Left for later PRs: the reference's start-column gate, and
// compacting the active lanes.  SKIP = false (column_skip = 0, the column
// skip's attribution run; no frame path sets it) descends every column of
// the box (AllColumns) and stages no mip: the flags are the same.

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <bool STAGED, bool SKIP = true>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    shadow_sweep_kernel(const uint32_t* __restrict__ vol,
                        const uint32_t* __restrict__ coarse,
                        const OccBox* occ, int n, float inv_n,
                        float cell_half, int width, int height,
                        const float* __restrict__ start,
                        const float* __restrict__ target,
                        const int* __restrict__ excl,
                        const uint8_t* __restrict__ active,
                        int* __restrict__ out) {
  __shared__ uint32_t coarse_s[STAGED && SKIP ? kMaxStagedWords : 1];
  __shared__ OccBox box;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = px < width && py < height;
  const size_t npix = (size_t)width * height;
  const size_t pix = (size_t)py * width + px;
  const size_t q = blockIdx.z;
  const size_t i1 = q * npix + pix;      // [nq, H, W]
  const size_t i3 = 3 * q * npix + pix;  // [nq, 3, H, W], component 0
  // The flag first, while the box kernel may still run.
  const bool lane_active = inside && active[i1] != 0;
  load_box(occ, &box, threadIdx.y * blockDim.x + threadIdx.x);
  // The barrier also publishes the box; both tests are block-uniform.
  if (!__syncthreads_or(lane_active) || box.empty) {
    if (inside) out[i1] = 0;
    return;
  }
  if constexpr (STAGED && SKIP) stage_coarse(coarse, coarse_s, n);
  if (!inside) return;
  int occluded = 0;
  if (lane_active) {
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
    occluded = sweep<false>(vol, skip_gate<STAGED, SKIP>(coarse, coarse_s), n,
                            inv_n, cell_half, r, 0.0f, t1, skip, t_hit, hx, hy,
                            hz, BoxClip{&box}) ? 1 : 0;
  }
  out[i1] = occluded;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coarse: uint32[n/8, XG*n/8]
// (ops/occupancy.py, XG = ceil(n/256)), 16-byte aligned; start, target:
// f32 [nq, 3, H, W]; excl: i32 [nq, 3, H, W]; active: u8 [nq, H, W]; out:
// i32 [nq, H, W] (1 = occluded).  cell_half is the visible cube's half
// size, (1/n) * cell_size * 0.5 in f32.  box: int32[8], scratch for the
// launch's OccBox, which the box kernel enqueued here writes first;
// box_launches: a host int that counts that launch (one added once it is
// enqueued).  column_skip = 0 descends every column of the box (SKIP =
// false).  Returns the first launch error (cudaError_t).
int ca3d_shadow_sweep(int device, const void* vol, const void* coarse, int n,
                      float cell_half, int width, int height, int nq,
                      const void* start, const void* target, const void* excl,
                      const void* active, void* out, int column_skip,
                      void* box, int* box_launches, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      nq < 1 || nq > 65535 || box_launches == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto occ = static_cast<OccBox*>(box);
  err = launch_occupied_box(static_cast<const uint32_t*>(coarse), n, occ, s);
  if (err != cudaSuccess) return err;
  *box_launches += 1;
  const float inv_n = (float)(1.0 / (double)n);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, nq);
  auto kernel = !column_skip            ? shadow_sweep_kernel<false, false>
                : n <= kMaxStagedGrid ? shadow_sweep_kernel<true>
                                      : shadow_sweep_kernel<false>;
  return launch_after_box(
      kernel, grid, block, s, static_cast<const uint32_t*>(vol),
      static_cast<const uint32_t*>(coarse), occ, n, inv_n, cell_half, width,
      height, static_cast<const float*>(start),
      static_cast<const float*>(target), static_cast<const int*>(excl),
      static_cast<const uint8_t*>(active), static_cast<int*>(out));
}

}  // extern "C"
