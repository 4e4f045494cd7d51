// The plane-midpoint DDA sweep shared by K1 (render_fast.cu) and K2
// (shadow_sweep.cu), with its float helpers.
//
// Replaces: the sweep / fetch closures of
// cellularautomatons3d_tpu/render/render_fast.py _make_traversal, which
// both the TPU frame kernel and the TPU occlusion kernel
// (render_slab.py _make_shadow_kernel_sweep) run.
//
// Semantics are the reference kernel's, not a textbook voxel DDA (the
// written spec is tests/test_render_fast.py oracle_dda): a +z pass for
// dz > 0 and a -z pass for dz < 0 (dz == 0 never hits), one midpoint probe
// per z-plane, the visible-cube accept rules, first hit in plane order.
// Every float expression keeps the reference's operation order; the build
// uses --fmad=false (an FMA in ox + tm*dx can move a probe across a cell
// boundary) and IEEE division/sqrt, rsqrt is 1/sqrtf, and min/max
// propagate NaN like jnp.minimum/maximum (fminf/fmaxf would drop it).
//
// Skip structure: the caller stages the 8^3 coarse occupancy mip
// (ops/occupancy.py) in shared memory.  For each 8-plane column the sweep
// computes the exact cell range its probes can reach -- the probe geometry
// is monotone in t, so the cells at the column's clipped t-range ends
// bound every probe -- and skips the column when no coarse block in that
// range is occupied.  It never changes a hit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ca3d {

constexpr int kMaxGrid = 256;
constexpr int kMaxBlocks = (kMaxGrid / 8) * (kMaxGrid / 8);

// NaN-propagating min/max (jnp.minimum / jnp.maximum semantics).
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Entry/exit of the unit volume [-0.5, 0.5] along one axis.
__device__ __forceinline__ void vol_slab(float o, float d, float& tn,
                                         float& tf) {
  const float inv = 1.0f / d;
  const float t1 = (-0.5f - o) * inv;
  const float t2 = (0.5f - o) * inv;
  tn = minp(t1, t2);
  tf = maxp(t1, t2);
}

// clip(floor((p + 0.5) * n), 0, n - 1) for a coordinate p = o + t*d.
__device__ __forceinline__ int cell_of(float p, float fn, int n) {
  float c = floorf((p + 0.5f) * fn);
  c = minp(maxp(c, 0.0f), (float)(n - 1));
  return (int)c;
}

// Copy the coarse occupancy mip (uint32[n/8, n/8]) to shared memory; every
// thread of the block calls it, before any returns.
__device__ __forceinline__ void stage_coarse(const uint32_t* __restrict__ coarse,
                                             uint32_t* coarse_s, int n) {
  const int nb = n >> 3;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < nb * nb; i += blockDim.x * blockDim.y) {
    coarse_s[i] = coarse[i];
  }
  __syncthreads();
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// One sweep: first cell hit in plane order.  PRIMARY selects the accept
// rule (tN <= tF and tF >= t_start) over the shadow rule (tN <= tF and
// tN >= 0), and the shadow sweep skips the excluded cell, component by
// component (an out-of-range excluded coordinate never matches a probe).
template <bool PRIMARY>
__device__ bool sweep(const uint32_t* __restrict__ vol,
                      const uint32_t* __restrict__ coarse_s, int n,
                      float inv_n, float cell_half, const Ray& r,
                      float t_start, float t_end, int ex_x, int ex_y,
                      int ex_z, float& t_hit, int& hx, int& hy, int& hz) {
  if (!(r.dz > 0.0f) && !(r.dz < 0.0f)) return false;
  const bool up = r.dz > 0.0f;
  const float inv_dx = 1.0f / r.dx;
  const float inv_dy = 1.0f / r.dy;
  const float inv_dz = 1.0f / r.dz;
  const float fn = (float)n;
  const int nb = n >> 3;
  const size_t plane = (size_t)n * (size_t)n;
  for (int ci = 0; ci < nb; ++ci) {
    const int c = up ? ci : nb - 1 - ci;
    // The column's t-range uses the same expressions as its first and
    // last plane, so every plane's [lo, hi] lies inside [c_lo, c_hi].
    const float ga = (float)(c * 8);
    const float gb = (float)(c * 8 + 8);
    const float ta = (ga * inv_n - 0.5f - r.oz) * inv_dz;
    const float tb = (gb * inv_n - 0.5f - r.oz) * inv_dz;
    const float cmin = minp(ta, tb);
    if (cmin >= t_end) break;  // this column and all later ones are past exit
    const float c_lo = maxp(cmin, t_start);
    const float c_hi = minp(maxp(ta, tb), t_end);
    if (!(c_lo < c_hi)) continue;
    // Cells the column's probes can reach, then its coarse blocks.
    const int xa = cell_of(r.ox + c_lo * r.dx, fn, n);
    const int xb = cell_of(r.ox + c_hi * r.dx, fn, n);
    const int ya = cell_of(r.oy + c_lo * r.dy, fn, n);
    const int yb = cell_of(r.oy + c_hi * r.dy, fn, n);
    const int bx0 = min(xa, xb) >> 3, bx1 = max(xa, xb) >> 3;
    const int by0 = min(ya, yb) >> 3, by1 = max(ya, yb) >> 3;
    const uint32_t xmask = ((bx1 == 31) ? 0xFFFFFFFFu : ((1u << (bx1 + 1)) - 1u)) &
                           ~((1u << bx0) - 1u);
    bool occupied = false;
    for (int by = by0; by <= by1 && !occupied; ++by) {
      occupied = (coarse_s[c * nb + by] & xmask) != 0u;
    }
    if (!occupied) continue;
    for (int f = 0; f < 8; ++f) {
      const int k = up ? c * 8 + f : c * 8 + 7 - f;
      const float gz = (float)k;
      const float pa = (gz * inv_n - 0.5f - r.oz) * inv_dz;
      const float pb = ((gz + 1.0f) * inv_n - 0.5f - r.oz) * inv_dz;
      const float lo = maxp(minp(pa, pb), t_start);
      const float hi = minp(maxp(pa, pb), t_end);
      if (!(lo < hi)) continue;
      const float tm = 0.5f * (lo + hi);
      const int cx = cell_of(r.ox + tm * r.dx, fn, n);
      const int cy = cell_of(r.oy + tm * r.dy, fn, n);
      const uint32_t word =
          __ldg(vol + (size_t)(cx >> 5) * plane + (size_t)k * n + cy);
      if (!((word >> (cx & 31)) & 1u)) continue;
      if (!PRIMARY && cx == ex_x && cy == ex_y && k == ex_z) continue;
      // Visible-cube intersection (wgsl:712-729).
      const float ccx = ((float)cx + 0.5f) * inv_n - 0.5f;
      const float ccy = ((float)cy + 0.5f) * inv_n - 0.5f;
      const float ccz = (gz + 0.5f) * inv_n - 0.5f;
      const float t1x = (ccx - cell_half - r.ox) * inv_dx;
      const float t2x = (ccx + cell_half - r.ox) * inv_dx;
      const float t1y = (ccy - cell_half - r.oy) * inv_dy;
      const float t2y = (ccy + cell_half - r.oy) * inv_dy;
      const float t1z = (ccz - cell_half - r.oz) * inv_dz;
      const float t2z = (ccz + cell_half - r.oz) * inv_dz;
      const float tn = maxp(maxp(minp(t1x, t2x), minp(t1y, t2y)), minp(t1z, t2z));
      const float tf = minp(minp(maxp(t1x, t2x), maxp(t1y, t2y)), maxp(t1z, t2z));
      const bool ok = PRIMARY ? (tn <= tf && tf >= t_start)
                              : (tn <= tf && tn >= 0.0f);
      if (ok) {
        t_hit = tn;
        hx = cx;
        hy = cy;
        hz = k;
        return true;
      }
    }
  }
  return false;
}

}  // namespace ca3d
