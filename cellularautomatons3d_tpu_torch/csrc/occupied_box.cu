// The occupied box of a given coarse occupancy mip, alone.
//
// Replaces: the global occupied z-range of the reference's occupancy
// rebuild (cellularautomatons3d_tpu/render/render_fast.py raytrace_tiles,
// XLA) and the per-brick z-ranges of its sliced path (render_slab.py
// prep_slabs), which gate whole columns and bricks.  Here the gate is the
// OccBox of sweep.cuh: the 8-plane columns [zc0, zc1] holding an occupied
// 8^3 block, and the x / y extent of those blocks' cells grown by one cell,
// open (+-inf) on a side that reaches a face of the volume, with `empty`
// and `full` flags (make_box); K1 reduces the same box per block
// (stage_coarse_box).  Its plain twin is ops/occupancy.py occupied_box.
// No frame path launches it: the occupancy rebuild writes the box beside
// the mip in its one launch (coarse_occupancy.cu), once a frame for every
// K2, K4 and K5 launch of the frame.  It reduces a mip a caller brings
// (render_slab.prep_volume(packed, coarse)) and is the box's yardstick.
//
// One block of 1024 threads: the mip is at most 256 KiB (1024^3: 128
// z-rows of XG = 4 groups of 128 words), L2-resident after the occupancy
// rebuild that wrote it, so one SM reads it in a few microseconds.  Each
// thread reads 16-byte vectors (four words of one z-row, x-group and four
// consecutive y-blocks, since n/8 is a multiple of 4), up to eight issued
// before any is folded; folds them into its x bits per group, y range and
// z range; warp reductions, then warp 0 over the 32 warps.  Bound: the
// mip's bytes at the one SM's L2 rate, and the launch: 2 us of device time
// at 256^3, 6 us at 1024^3 on the H100.  A cluster of 8 blocks reducing
// through distributed shared memory took 3.8 us at 1024^3 but 3.3 at 256^3,
// where K2 runs every lighting frame; dropped (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;          // vectors in flight per thread
constexpr int kMaxGroups = kMaxGrid / 256;
constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
    occupied_box_kernel(const uint4* __restrict__ coarse, int n, float inv_n,
                        OccBox* __restrict__ out) {
  __shared__ uint32_t part_x[kWarps][kMaxGroups];
  __shared__ int part_r[kWarps][4];
  const int nb = n >> 3;
  const int xg = (nb + 31) >> 5;
  const int row = xg * nb;          // words per z-row
  const int total = (nb * row) >> 2;  // 16-byte vectors
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  uint32_t xs[kMaxGroups] = {};
  int ymin = nb, ymax = -1, zmin = nb, zmax = -1;
  for (int base = tid; base < total; base += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = base + k * kThreads;
      v[k] = j < total ? __ldg(coarse + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const uint32_t any = v[k].x | v[k].y | v[k].z | v[k].w;
      if (any == 0u) continue;
      const int i = (base + k * kThreads) << 2;  // first word's index
      const int z = i / row;
      const int g = (i - z * row) / nb;
      const int y = i - z * row - g * nb;
#pragma unroll
      for (int gg = 0; gg < kMaxGroups; ++gg) xs[gg] |= gg == g ? any : 0u;
      ymin = min(ymin, y + (v[k].x ? 0 : v[k].y ? 1 : v[k].z ? 2 : 3));
      ymax = max(ymax, y + (v[k].w ? 3 : v[k].z ? 2 : v[k].y ? 1 : 0));
      zmin = min(zmin, z);
      zmax = max(zmax, z);
    }
  }
#pragma unroll
  for (int gg = 0; gg < kMaxGroups; ++gg) xs[gg] = __reduce_or_sync(kAll, xs[gg]);
  ymin = __reduce_min_sync(kAll, ymin);
  ymax = __reduce_max_sync(kAll, ymax);
  zmin = __reduce_min_sync(kAll, zmin);
  zmax = __reduce_max_sync(kAll, zmax);
  if (lane == 0) {
#pragma unroll
    for (int gg = 0; gg < kMaxGroups; ++gg) part_x[wp][gg] = xs[gg];
    part_r[wp][0] = ymin;
    part_r[wp][1] = ymax;
    part_r[wp][2] = zmin;
    part_r[wp][3] = zmax;
  }
  __syncthreads();
  if (wp != 0) return;
#pragma unroll
  for (int gg = 0; gg < kMaxGroups; ++gg) {
    xs[gg] = __reduce_or_sync(kAll, part_x[lane][gg]);
  }
  ymin = __reduce_min_sync(kAll, part_r[lane][0]);
  ymax = __reduce_max_sync(kAll, part_r[lane][1]);
  zmin = __reduce_min_sync(kAll, part_r[lane][2]);
  zmax = __reduce_max_sync(kAll, part_r[lane][3]);
  if (lane != 0) return;
  OccBox box = {};
  if (zmax < 0) {
    box.empty = 1;
  } else {
    int xb0 = -1, xb1 = -1;
#pragma unroll
    for (int gg = kMaxGroups - 1; gg >= 0; --gg) {
      if (xs[gg] != 0u) xb0 = 32 * gg + __ffs(xs[gg]) - 1;
    }
#pragma unroll
    for (int gg = 0; gg < kMaxGroups; ++gg) {
      if (xs[gg] != 0u) xb1 = 32 * gg + 31 - __clz(xs[gg]);
    }
    box = make_box(xb0, xb1, ymin, ymax, zmin, zmax, nb, inv_n);
  }
  *out = box;
}

}  // namespace

extern "C" {

// coarse: uint32[n/8, XG*n/8] (ops/occupancy.py, XG = ceil(n/256)), n <= 1024,
// 16-byte aligned; box: int32[8], the OccBox {empty, full, zc0, zc1, x0, x1,
// y0, y1} with the four extents as float32 bits.  Returns the launch's
// cudaError_t.
int ca3d_occupied_box(int device, const void* coarse, int n, void* box,
                      void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || box == nullptr ||
      (reinterpret_cast<uintptr_t>(coarse) & 15u) != 0u) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  occupied_box_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(coarse), n, (float)(1.0 / (double)n),
      static_cast<OccBox*>(box));
  return cudaGetLastError();
}

}  // extern "C"
