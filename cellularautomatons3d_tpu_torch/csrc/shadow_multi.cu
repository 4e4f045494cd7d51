// K5: cell-exact occlusion of up to 8 shadow-ray queries per pixel, taken
// where the lighting code leaves them, one thread per (query, pixel).
//
// Replaces: cellularautomatons3d_tpu/render/render_slab.py,
// _make_shadow_kernel (launched by shadow_occlusion_batch when
// CA3D_OCC_SWEEP=0), the multi-query occlusion sweep in which one
// traversal of a screen tile serves its <= CA3D_OCC_NQ queries.  Per
// (query, pixel), as K2 (shadow_sweep.cu) computes it: the ray from the
// start toward the target, normalised with 1/sqrtf, its exit from the
// unit volume with divisions, the shadow accept rule tN >= 0, and the
// excluded cell, skipped component by component, none when a coordinate is
// outside [0, n) (the reference's exid with its -1 sentinel: a plain
// packing would alias x == n to the cell (0, y + 1, z)).  So K5's flags
// equal K2's bit for bit on the same queries.
//
// Operands (queries.cuh): per query a start [H, W, 3] f32, a target
// [H, W, 3] or the light's [3], the excluded cell [H, W, 3] int32 or int64
// and the active mask [H, W], as the lighting passes make them, through a
// table of pointers and strides passed by value; torch stacks nothing
// before a launch (K2's operands are [nq, 3, H, W] stacks, ~37 B written
// and read again per query-pixel).  Out: i32 [nq, H, W].
//
// Design on the H100, as K2's: one thread per (query, pixel) in 1-D
// blocks of 128, one query per grid z-slice and a 16x8 pixel tile per
// block.  Only hit pixels cast shadow and GI rays (about 93 % of the lanes
// of the sparse scenes are inactive), so a block first reads its lanes'
// active flags, and a block with none (or an empty volume) writes its zeros
// and leaves before it touches the mip.  The entry point enqueues the box
// kernel (occupied_box.cu), then this one as its programmatic dependent;
// the active rays sweep clipped to the box (BoxClip, exact from any start).
// Up to 256^3 an active block stages the 4 KiB mip in shared memory; above,
// the mip is read from L2.  40 registers, no spill.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): the TPU
// kernel's shared traversal (one thread walking a pixel's queries in turn,
// the parent of this kernel) held up to 4 rays in 72 registers and kept
// each warp until its slowest query ended, 0.78 ms of device time for 8
// queries at 256^3 against 0.20 here.  Timed against this design and
// dropped: a pixel's queries in neighbouring lanes (2-5 % faster on active
// rays, which share L1 lines, 18 % slower with every lane inactive, equal
// in a frame); blocks that gather the active pixels of a 32x16 tile into a
// list and trace it in rounds (35 % less with every lane inactive, 22-41 %
// more on active rays: a block holds its slot through its rounds); a
// (16, 8) block with the same mapping (10 % more with every lane inactive,
// 42 registers).

#include <cstdint>
#include <cuda_runtime.h>

#include "queries.cuh"
#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <bool STAGED>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    shadow_multi_kernel(const uint32_t* __restrict__ vol,
                        const uint32_t* __restrict__ coarse,
                        const OccBox* occ, int n, float inv_n,
                        float cell_half, int width, int height,
                        const __grid_constant__ OcclusionQueries qs,
                        int* __restrict__ out) {
  __shared__ uint32_t coarse_s[STAGED ? kMaxStagedWords : 1];
  __shared__ OccBox box;
  const int tid = threadIdx.x;
  const int q = blockIdx.z;
  const int px = blockIdx.x * kBlockX + tid % kBlockX;
  const int py = blockIdx.y * kBlockY + tid / kBlockX;
  const bool inside = px < width && py < height;
  const long long npix = (long long)width * height;
  const long long pix = (long long)py * width + px;
  const OcclusionQuery& oq = qs.q[q];
  // The flag first, while the box kernel may still run.
  const bool lane_active = inside && oq.active[pix] != 0;
  load_box(occ, &box, tid);
  // The barrier also publishes the box; both tests are block-uniform.
  if (!__syncthreads_or(lane_active) || box.empty) {
    if (inside) out[q * npix + pix] = 0;
    return;
  }
  if constexpr (STAGED) stage_coarse(coarse, coarse_s, n);
  if (!inside) return;
  int occluded = 0;
  if (lane_active) {
    Ray r;
    r.ox = oq.start.at(pix, 0);
    r.oy = oq.start.at(pix, 1);
    r.oz = oq.start.at(pix, 2);
    r.dx = oq.target.at(pix, 0) - r.ox;
    r.dy = oq.target.at(pix, 1) - r.oy;
    r.dz = oq.target.at(pix, 2) - r.oz;
    normalize3(r.dx, r.dy, r.dz);
    // Volume exit: min over axes of max((-0.5 - s) / d, (0.5 - s) / d).
    const float ex = maxp((-0.5f - r.ox) / r.dx, (0.5f - r.ox) / r.dx);
    const float ey = maxp((-0.5f - r.oy) / r.dy, (0.5f - r.oy) / r.dy);
    const float ez = maxp((-0.5f - r.oz) / r.dz, (0.5f - r.oz) / r.dz);
    const float t1 = minp(minp(ex, ey), ez);
    // The excluded cell, or none (-1, which no probe matches) when a
    // coordinate is outside [0, n).
    const long long cx = oq.excl.at(pix, 0), cy = oq.excl.at(pix, 1),
                    cz = oq.excl.at(pix, 2);
    const bool in_range = cx >= 0 && cx < n && cy >= 0 && cy < n &&
                          cz >= 0 && cz < n;
    const CellExclusion skip = in_range
        ? CellExclusion{(int)cx, (int)cy, (int)cz}
        : CellExclusion{-1, -1, -1};
    float t_hit;
    int hx, hy, hz;
    occluded = sweep<false>(vol, mip_of<STAGED>(coarse, coarse_s), n, inv_n,
                            cell_half, r, 0.0f, t1, skip, t_hit, hx, hy, hz,
                            BoxClip{&box}) ? 1 : 0;
  }
  out[q * npix + pix] = occluded;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coarse: uint32[n/8, XG*n/8]
// (ops/occupancy.py, XG = ceil(n/256)), 16-byte aligned; queries: nq rows
// of kOcclusionRow int64 (queries.cuh), 1 <= nq <= 8, every operand on the
// device; out: i32 [nq, H, W] (1 = occluded).  cell_half is the visible
// cube's half size, (1/n) * cell_size * 0.5 in f32.  box: int32[8],
// scratch for the launch's OccBox, which the box kernel enqueued here
// writes first; box_launches: a host int that counts that launch (one
// added once it is enqueued).  Returns the first launch error
// (cudaError_t).
int ca3d_shadow_multi(int device, const void* vol, const void* coarse, int n,
                      float cell_half, int width, int height, int nq,
                      const long long* queries, void* out, void* box,
                      int* box_launches, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      nq < 1 || nq > kMaxQueries || queries == nullptr ||
      box_launches == nullptr) {
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
  const dim3 block(kBlockX * kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, nq);
  auto kernel = n <= kMaxStagedGrid ? shadow_multi_kernel<true>
                                    : shadow_multi_kernel<false>;
  return launch_after_box(
      kernel, grid, block, s, static_cast<const uint32_t*>(vol),
      static_cast<const uint32_t*>(coarse), occ, n, inv_n, cell_half, width,
      height, occlusion_queries(queries, nq), static_cast<int*>(out));
}

}  // extern "C"
