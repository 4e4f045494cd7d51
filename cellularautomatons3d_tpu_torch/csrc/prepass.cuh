// The patch prepass (K6) as the work of a group of lanes: the column mask
// of one 8x8 pixel patch, read from the undilated coarse mip.  Two launch
// forms run it: K1 (render_fast.cu) computes its block's two patch masks in
// its prologue from the mip it has staged, and prepass.cu runs it alone to
// give the masks as a tensor.
//
// Replaces: cellularautomatons3d_tpu/render/render_fast.py, _make_prepass
// (launched by _prepass_mask on the mip dilated by dilate_occupancy
// twice).  Per patch: the ray of the patch centre pixel (px = patch x * 8
// + 4, no +0.5, the shard's row offset P_ROW0) over the volume box grown
// by m = 0.035; bit c of the mask is set when one of three probes (the
// ends and the midpoint of the ray's clipped segment in 8-plane column c)
// lands in an occupied block of the doubly dilated mip, clipped into the
// grid as _fetch_coarse_bit_impl does.  Steep patches (|dxy| > 2|dz| -
// 0.03), far ones (t1 * 0.0075 n > 7) and degenerate ones get all ones
// (-1); a patch whose ray misses the grown box gets 0.
//
// Float rules: the reference's operation order; rsqrt is 1/sqrtf as in
// every port kernel, and the column planes' (c*8/n - 0.5) is evaluated in
// double and rounded once, as the reference's Python scalar arithmetic is.
// The build has --fmad=false and IEEE division/sqrt, so every lane of a
// group computes the same ray bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace ca3d {

constexpr int kPatch = 8;             // patch edge in pixels
constexpr double kPreMargin = 0.035;  // grown-box margin
constexpr double kPreDev = 0.0075;    // per-unit-t bound on bundle deviation

// Bit (c, by, bx) of the mip dilated +-1 block in x and y, then +-1 more in
// x (ops/occupancy.py dilate_occupancy twice, n <= 256), read from the
// undilated mip [n/8, n/8]: the OR of rows by - 1, by, by + 1 of z-row c
// (y wraps, as jnp.roll does) tested on the x window [bx - 2, bx + 2] of
// the 32-bit word (x shifts drop bits at the word's ends).
__device__ __forceinline__ bool dilated_bit(const uint32_t* mip, int nbk, int c,
                                            int by, int bx) {
  const uint32_t* row = mip + c * nbk;
  const uint32_t w = row[by == 0 ? nbk - 1 : by - 1] | row[by] |
                     row[by == nbk - 1 ? 0 : by + 1];
  const uint32_t x = w | (w << 1) | (w >> 1) | (w << 2) | (w >> 2);
  return (x >> bx) & 1u;
}

// The column mask of patch (pxp, pyp) of an n^3 grid (n <= 256), computed
// by a group of G lanes (G a power of two; 32 / G patches a warp): every
// lane of the group sets up the patch's ray (the same floats in each), the
// lane with index sub in the group probes columns c0 + sub, c0 + sub + G,
// ... up to c1, and an OR across the group's lanes gathers the bits.
// Columns outside [c0, c1] must hold no occupied block (their bits are 0:
// the dilation does not reach across z).  Every lane of the warp calls it,
// and each gets its group's mask.
//
// Why groups of lanes: a warp issues the ray set-up (eight IEEE divisions
// and a square root) once for all its lanes, so a warp per patch (G = 32)
// spends a whole warp's issue slots on one patch's set-up, and a thread per
// patch walks 32 columns in a row.  prepass.cu takes G = 4 (8 patches a
// warp, 8 columns a lane), K1 G = 16 (its two patches in one warp); the
// times of G = 2 to 32 are in PERF.md §6.
template <int G>
__device__ __forceinline__ int patch_mask(const float* P, int n,
                                          const uint32_t* mip, int pxp,
                                          int pyp, int sub, int c0, int c1) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two");
  const int px = pxp * kPatch + kPatch / 2;
  const int py = pyp * kPatch + kPatch / 2;
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
  const float hm = (float)(0.5 + kPreMargin);
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

  const int nbk = n >> 3;
  uint32_t bits = 0u;
  if (active && !steep && !is_far) {
    const double inv_n = 1.0 / n;
    const float fnb = (float)nbk;
    for (int c = c0 + sub; c <= c1; c += G) {
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
        occ = occ || dilated_bit(mip, nbk, c, byc, bxc);
      }
      if (occ) bits |= 1u << c;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, off);
  }
  if (!active) return 0;
  if (steep || is_far) return -1;
  return (int)bits;
}

}  // namespace ca3d
