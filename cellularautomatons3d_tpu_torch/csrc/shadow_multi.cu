// K5: cell-exact occlusion of up to 8 shadow-ray queries per pixel, one
// thread per pixel walking all of them through one column loop.
//
// Replaces: cellularautomatons3d_tpu/render/render_slab.py,
// _make_shadow_kernel (launched by shadow_occlusion_batch when
// CA3D_OCC_SWEEP=0), the multi-query occlusion sweep in which one
// traversal of a screen tile serves its <= CA3D_OCC_NQ queries.  Per
// (query, pixel), as K2 (shadow_sweep.cu) computes it: the ray from the
// start toward the target, normalised with 1/sqrtf, its exit from the
// unit volume with divisions, the shadow accept rule tN >= 0, and the
// excluded cell, here by packed id with the -1 sentinel for an
// out-of-range cell (the reference's exid).  So K5's flags equal K2's bit
// for bit on the same queries.
//
// Per direction pass (+z for dz > 0, then -z for dz < 0), one loop over
// the 8-plane columns serves the pixel's open queries of that sign: each
// query keeps its own column range, mip test (sweep.cuh column_occupied),
// plane probes, found latch and exclusion; a column is descended for the
// queries whose test flags it, and the loop ends when every query has hit
// or passed its exit.  A query whose test does not flag the column cannot
// hit in it, so descending it for them too would change no flag.  The
// TPU kernel's brick carry (occ_prev), supercolumn gates and start-column
// fold do not come across: they are TPU skip structure.
//
// Operands: start/target f32 [nq, 3, H, W], exid i32 [nq, H, W], active
// u8 [nq, H, W] -> i32 [nq, H, W] (29 B in per query-pixel, K2's 37 B).
//
// Bound on the H100: as K2, dependent loads of packed words on occupied
// columns (L2-resident up to 512^3) and the coarse mip, staged in shared
// memory up to 256^3 and read from L2 above.  One thread per pixel loads
// the mip's column words once for all its queries, but holds nq rays in
// registers and runs nq times K2's column tests; its divergence is that of
// the slowest query of a pixel.

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kMaxQueries = 8;

template <int NQ, bool STAGED>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    shadow_multi_kernel(const uint32_t* __restrict__ vol,
                        const uint32_t* __restrict__ coarse, int n,
                        float inv_n, float cell_half, int width, int height,
                        const float* __restrict__ start,
                        const float* __restrict__ target,
                        const int* __restrict__ exid,
                        const uint8_t* __restrict__ active,
                        int* __restrict__ out) {
  __shared__ uint32_t coarse_s[STAGED ? kMaxStagedWords : 1];
  if constexpr (STAGED) stage_coarse(coarse, coarse_s, n);
  const auto mip = mip_of<STAGED>(coarse, coarse_s);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const size_t npix = (size_t)width * height;
  const size_t pix = (size_t)py * width + px;

  Ray r[NQ];
  float inv_dx[NQ], inv_dy[NQ], inv_dz[NQ], t1[NQ];
  bool is_open[NQ], occluded[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    occluded[q] = false;
    is_open[q] = active[q * npix + pix] != 0;
    if (!is_open[q]) continue;
    const size_t i3 = 3 * q * npix + pix;
    r[q].ox = start[i3];
    r[q].oy = start[i3 + npix];
    r[q].oz = start[i3 + 2 * npix];
    r[q].dx = target[i3] - r[q].ox;
    r[q].dy = target[i3 + npix] - r[q].oy;
    r[q].dz = target[i3 + 2 * npix] - r[q].oz;
    normalize3(r[q].dx, r[q].dy, r[q].dz);
    // Volume exit, as K2: min over axes of max((-0.5 - s) / d, (0.5 - s) / d).
    const float ex = maxp((-0.5f - r[q].ox) / r[q].dx, (0.5f - r[q].ox) / r[q].dx);
    const float ey = maxp((-0.5f - r[q].oy) / r[q].dy, (0.5f - r[q].oy) / r[q].dy);
    const float ez = maxp((-0.5f - r[q].oz) / r[q].dz, (0.5f - r[q].oz) / r[q].dz);
    t1[q] = minp(minp(ex, ey), ez);
    inv_dx[q] = 1.0f / r[q].dx;
    inv_dy[q] = 1.0f / r[q].dy;
    inv_dz[q] = 1.0f / r[q].dz;
  }

  const float fn = (float)n;
  const int nb = n >> 3;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const bool up = pass == 0;
    bool live[NQ];
    bool any_live = false;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      live[q] = is_open[q] && (up ? r[q].dz > 0.0f : r[q].dz < 0.0f);
      any_live = any_live || live[q];
    }
    for (int ci = 0; ci < nb && any_live; ++ci) {
      const int c = up ? ci : nb - 1 - ci;
      bool need[NQ];
      any_live = false;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        need[q] = false;
        if (!live[q]) continue;
        float cmin, lo, hi;
        column_span(r[q], inv_n, inv_dz[q], c, 0.0f, t1[q], cmin, lo, hi);
        if (cmin >= t1[q]) {  // this column and all later ones are past exit
          live[q] = false;
          continue;
        }
        any_live = true;
        need[q] = lo < hi && column_occupied(mip, r[q], fn, n, c, lo, hi);
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (!need[q]) continue;
        const IdExclusion excluded{exid[q * npix + pix], n};
        for (int f = 0; f < 8; ++f) {
          const int k = up ? c * 8 + f : c * 8 + 7 - f;
          float t_hit;
          int hx, hy;
          if (probe_plane<false>(vol, n, fn, inv_n, cell_half, r[q],
                                 inv_dx[q], inv_dy[q], inv_dz[q], k, 0.0f,
                                 t1[q], excluded, t_hit, hx, hy)) {
            occluded[q] = true;
            live[q] = false;
            break;
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) out[q * npix + pix] = occluded[q] ? 1 : 0;
}

template <int NQ>
void launch(dim3 grid, dim3 block, cudaStream_t s, bool staged,
            const uint32_t* vol, const uint32_t* coarse, int n, float inv_n,
            float cell_half, int width, int height, const float* start,
            const float* target, const int* exid, const uint8_t* active,
            int* out) {
  auto kernel = staged ? shadow_multi_kernel<NQ, true>
                       : shadow_multi_kernel<NQ, false>;
  kernel<<<grid, block, 0, s>>>(vol, coarse, n, inv_n, cell_half, width,
                                height, start, target, exid, active, out);
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coarse: uint32[n/8, XG*n/8]
// (ops/occupancy.py, XG = ceil(n/256)); start, target: f32 [nq, 3, H, W];
// exid: i32 [nq, H, W] (x + y*n + z*n*n, -1 = none); active: u8 [nq, H, W];
// out: i32 [nq, H, W] (1 = occluded); 1 <= nq <= 8.  cell_half is the
// visible cube's half size, (1/n) * cell_size * 0.5 in f32.  Returns the
// launch's cudaError_t.
int ca3d_shadow_multi(int device, const void* vol, const void* coarse, int n,
                      float cell_half, int width, int height, int nq,
                      const void* start, const void* target, const void* exid,
                      const void* active, void* out, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      nq < 1 || nq > kMaxQueries) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float inv_n = (float)(1.0 / (double)n);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = n <= kMaxStagedGrid;
  const auto* v = static_cast<const uint32_t*>(vol);
  const auto* co = static_cast<const uint32_t*>(coarse);
  const auto* st = static_cast<const float*>(start);
  const auto* tg = static_cast<const float*>(target);
  const auto* ex = static_cast<const int*>(exid);
  const auto* ac = static_cast<const uint8_t*>(active);
  auto* o = static_cast<int*>(out);
  switch (nq) {
#define CA3D_NQ_CASE(NQ)                                                     \
  case NQ:                                                                   \
    launch<NQ>(grid, block, s, staged, v, co, n, inv_n, cell_half, width,    \
               height, st, tg, ex, ac, o);                                   \
    break;
    CA3D_NQ_CASE(1)
    CA3D_NQ_CASE(2)
    CA3D_NQ_CASE(3)
    CA3D_NQ_CASE(4)
    CA3D_NQ_CASE(5)
    CA3D_NQ_CASE(6)
    CA3D_NQ_CASE(7)
    CA3D_NQ_CASE(8)
#undef CA3D_NQ_CASE
  }
  return cudaGetLastError();
}

}  // extern "C"
