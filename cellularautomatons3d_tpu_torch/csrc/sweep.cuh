// The plane-midpoint DDA sweep shared by K1 (render_fast.cu), K2
// (shadow_sweep.cu), K4 (primary_sweep.cu) and K5 (shadow_multi.cu), its
// column and plane steps, its float helpers, the camera ray, and the age
// fetch of a primary hit (K1, K4).
//
// Replaces: the sweep / fetch closures of
// cellularautomatons3d_tpu/render/render_fast.py _make_traversal, which
// the TPU frame kernel, the TPU occlusion kernel
// (render_slab.py _make_shadow_kernel_sweep) and the TPU brick primary
// kernel (render_slab.py _make_primary_kernel) all run.
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
// Skip structure: the 8^3 coarse occupancy mip (ops/occupancy.py), one bit
// per block, [Zc, XG*Yc] words, group-major: bit xb & 31 of
// coarse[zc, (xb >> 5)*Yc + yc].  For each 8-plane column the sweep
// computes the exact cell range its probes can reach -- the probe geometry
// is monotone in t, so the cells at the column's clipped t-range ends
// bound every probe -- and skips the column when no coarse block in that
// range is occupied, across as many x-groups as the range spans.  It never
// changes a hit.  Up to 256^3 (XG = 1) the mip is 4 KiB and each block
// stages it in shared memory (SharedMip: one group, one mask per y-block
// word); above, it is up to 256 KiB (at 1024^3),
// more than a block's shared memory, and the sweep reads it from global
// memory through the read-only path (GlobalMip): it is L2-resident.  K1
// with a prepass mask gates its primary sweep's columns by the mask
// instead (ColumnMask).  Every sweep clips to the box of occupied blocks
// (OccBox, BoxClip): only the columns, and the t-range of the box's x / y
// extent, where a probe could land in an occupied cell.  K1 and K4 sweep
// unclipped (NoClip) when the box is the whole volume, K2 and K5 clip there
// too, so their walk starts at the ray's start.  K1 reduces the box in each
// block from its staged mip (stage_coarse_box); K2, K4 and K5 read it from
// the 8-word buffer that the occupancy rebuild's one launch writes beside
// the mip (coarse_occupancy.cu), once a frame for all of the frame's sweeps.
// The packed volume itself is read from global memory at every size: 2 MiB
// at 256^3 sits in the 50 MB L2, 128 MiB at 1024^3 does not, so there the
// probes of occupied columns go to HBM.
//
// How a descended column probes its 8 planes (the Descent of sweep()):
// EachPlane, one plane after the other, each a load then a test (every
// kernel's default); K1's opt-in options (render_fast.py CA3D_MIP1 and
// CA3D_SLICEGATE in the reference, both exact) are PlaneMip, which fetches a
// plane's fine word only where the probe's 1x8x8 block is occupied in the
// plane mip (ops/occupancy.py plane_occupancy, [n, n/8] words at n <= 256,
// read through the read-only path: 32 KiB at 256^3, ten blocks an SM
// could not each stage it), and Prefetch, which loads the column's
// in-segment plane words before testing any (render_fast.py descend_gated:
// gather the needed words, then consume them).  AllColumns is a column gate
// that reports every column occupied: K1 without the coarse column skip,
// to measure what it saves.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ca3d {

constexpr int kMaxGrid = 1024;        // the reference UI's ceiling
constexpr int kMaxStagedGrid = 256;   // largest grid whose mip is staged
constexpr int kMaxStagedWords = (kMaxStagedGrid / 8) * (kMaxStagedGrid / 8);

// Camera/params vector layout (render_fast.py P_* constants) used by the
// kernels that cast camera rays.
constexpr int P_O = 9;
constexpr int P_WIN = 12;
constexpr int P_CELLMUL = 18;
constexpr int P_ROW0 = 32;
constexpr int P_LEN = 40;

struct Cam {
  float p[P_LEN];
};

// -0.5 * COT_HALF_FOV (1/tan(37.5 deg) = 1.3032254), rounded to f32 once.
constexpr float kRayZ = (float)(-0.5 * 1.3032254);

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

// clip(floor((p + 0.5) * n), 0, n - 1) for a coordinate p = o + t*d, as
// an integer floor and clamp: the float-to-int conversion saturates and
// takes NaN to 0, so every input gives the cell of the float floor, float
// clamp (NaN kept) and conversion that it replaces.
__device__ __forceinline__ int cell_of(float p, float fn, int n) {
  return min(max(__float2int_rd((p + 0.5f) * fn), 0), n - 1);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The camera ray of pixel (px, py) (render_fast.py pixel_rays,
// render_slab.py _pixel_rays_kernel); ux is the pixel's window u.
__device__ __forceinline__ Ray camera_ray(const float* P, int px, int py,
                                          float& ux) {
  const float win_w = P[P_WIN], win_h = P[P_WIN + 1];
  ux = ((float)px + 0.5f) / win_w;
  const float uy = 1.0f - ((float)py + P[P_ROW0] + 0.5f) / win_h;
  float rx = (ux - 0.5f) * (win_w / win_h);
  float ry = uy - 0.5f;
  float rz = kRayZ;
  normalize3(rx, ry, rz);
  Ray ray;
  ray.dx = P[0] * rx + P[1] * ry + P[2] * rz;
  ray.dy = P[3] * rx + P[4] * ry + P[5] * rz;
  ray.dz = P[6] * rx + P[7] * ry + P[8] * rz;
  ray.ox = P[P_O];
  ray.oy = P[P_O + 1];
  ray.oz = P[P_O + 2];
  return ray;
}

// Whether any 8^3 block in x-blocks [bx0, bx1] x y-blocks [by0, by1] of
// coarse z-row c is occupied, for the two places the mip can live.

// The mip staged in shared memory (n <= 256: one x-group, [n/8, n/8]).
struct SharedMip {
  const uint32_t* words;
  __device__ __forceinline__ bool occupied(int c, int nb, int bx0, int bx1,
                                           int by0, int by1) const {
    const uint32_t xmask = ((bx1 == 31) ? 0xFFFFFFFFu : ((1u << (bx1 + 1)) - 1u)) &
                           ~((1u << bx0) - 1u);
    bool any = false;
    for (int by = by0; by <= by1 && !any; ++by) {
      any = (words[c * nb + by] & xmask) != 0u;
    }
    return any;
  }
};

// The mip in global memory, read through the read-only path (any n:
// XG = ceil(n/256) groups of nb words per z-row; the x range may span
// several groups).
struct GlobalMip {
  const uint32_t* __restrict__ words;
  __device__ __forceinline__ bool occupied(int c, int nb, int bx0, int bx1,
                                           int by0, int by1) const {
    const int row = c * ((nb + 31) >> 5) * nb;
    for (int g = bx0 >> 5; g <= (bx1 >> 5); ++g) {
      const int lo = max(bx0 - 32 * g, 0);
      const int hi = min(bx1 - 32 * g, 31);
      const uint32_t xmask = ((hi == 31) ? 0xFFFFFFFFu : ((1u << (hi + 1)) - 1u)) &
                             ~((1u << lo) - 1u);
      for (int by = by0; by <= by1; ++by) {
        if ((__ldg(words + row + g * nb + by) & xmask) != 0u) return true;
      }
    }
    return false;
  }
};

// Copy the coarse occupancy mip (uint32[n/8, n/8], n <= 256) to shared
// memory; every thread of the block calls it, before any returns.
__device__ __forceinline__ void stage_coarse(const uint32_t* __restrict__ coarse,
                                             uint32_t* coarse_s, int n) {
  const int nb = n >> 3;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < nb * nb; i += blockDim.x * blockDim.y) {
    coarse_s[i] = coarse[i];
  }
  __syncthreads();
}

// The box of the occupied 8^3 blocks of a staged mip: the 8-plane columns
// [zc0, zc1], and the x / y extent of its cells in volume coordinates,
// grown by one cell, open (+-inf) on a side where it reaches the volume's
// face (a probe beyond the face is clamped onto the face's cells).  empty:
// no block is occupied; full: the box is the whole volume.
struct OccBox {
  int empty, full, zc0, zc1;
  float x0, x1, y0, y1;
};
static_assert(sizeof(OccBox) == 32, "OccBox is the 8-word box buffer");

// The box of a non-empty mip from its occupied block range: x-blocks
// [xb0, xb1], y-blocks [yb0, yb1] and 8-plane columns [zmin, zmax] of an
// n^3 grid (nb = n/8 blocks a side, inv_n = 1/n in f32).  K1's per-block
// reduction (stage_coarse_box), the mip kernel's box (coarse_occupancy.cu)
// and the box kernel (occupied_box.cu) all build their box here, so they
// agree.
__device__ __forceinline__ OccBox make_box(int xb0, int xb1, int yb0, int yb1,
                                           int zmin, int zmax, int nb,
                                           float inv_n) {
  const float inf = __int_as_float(0x7f800000);
  OccBox box;
  box.empty = 0;
  box.full = xb0 == 0 && xb1 == nb - 1 && yb0 == 0 && yb1 == nb - 1 &&
             zmin == 0 && zmax == nb - 1;
  box.zc0 = zmin;
  box.zc1 = zmax;
  box.x0 = xb0 == 0 ? -inf : (float)(xb0 * 8 - 1) * inv_n - 0.5f;
  box.x1 = xb1 == nb - 1 ? inf : (float)(xb1 * 8 + 9) * inv_n - 0.5f;
  box.y0 = yb0 == 0 ? -inf : (float)(yb0 * 8 - 1) * inv_n - 0.5f;
  box.y1 = yb1 == nb - 1 ? inf : (float)(yb1 * 8 + 9) * inv_n - 0.5f;
  return box;
}

// Copy the launch's box into shared memory (threads 0-7, one word each).
// griddepcontrol.wait is a no-op after an ordinary launch (every launch of
// the sweeps is one), and would wait for the kernel before to finish under
// a programmatic dependent launch.  The caller's next barrier publishes the
// box.
__device__ __forceinline__ void load_box(const OccBox* src, OccBox* dst,
                                         int tid) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (tid < 8) {
    reinterpret_cast<int*>(dst)[tid] = reinterpret_cast<const int*>(src)[tid];
  }
}

// stage_coarse for a block of WARPS warps, and the box of the staged mip:
// warp wp stages z-rows wp, wp + WARPS, ... (lane = y), its loads issued
// before any is used, and folds each row into its x bits, y bits and z
// range with one ballot; one thread then combines the warps.  Every thread
// of the block calls it, before any returns.
template <int WARPS>
__device__ __forceinline__ void stage_coarse_box(
    const uint32_t* __restrict__ coarse, uint32_t* coarse_s, int n,
    float inv_n, OccBox* box) {
  constexpr int kRows = (kMaxStagedGrid / 8 + WARPS - 1) / WARPS;
  constexpr unsigned kAll = 0xFFFFFFFFu;
  __shared__ int part[WARPS][4];
  const int nb = n >> 3;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int wp = tid >> 5, lane = tid & 31;
  uint32_t w[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int z = wp + k * WARPS;
    w[k] = z < nb && lane < nb ? coarse[z * nb + lane] : 0u;
  }
  uint32_t xs = 0u, ys = 0u;
  int zmin = nb, zmax = -1;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int z = wp + k * WARPS;
    if (z < nb && lane < nb) coarse_s[z * nb + lane] = w[k];
    const uint32_t row_ys = __ballot_sync(kAll, w[k] != 0u);
    xs |= w[k];
    ys |= row_ys;
    if (row_ys != 0u) {
      zmin = min(zmin, z);
      zmax = max(zmax, z);
    }
  }
  xs = __reduce_or_sync(kAll, xs);
  if (lane == 0) {
    part[wp][0] = (int)xs;
    part[wp][1] = (int)ys;
    part[wp][2] = zmin;
    part[wp][3] = zmax;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < WARPS; ++i) {
      xs |= (uint32_t)part[i][0];
      ys |= (uint32_t)part[i][1];
      zmin = min(zmin, part[i][2]);
      zmax = max(zmax, part[i][3]);
    }
    const int xb0 = __ffs(xs) - 1, xb1 = 31 - __clz(xs);
    const int yb0 = __ffs(ys) - 1, yb1 = 31 - __clz(ys);
    OccBox b = make_box(xb0, xb1, yb0, yb1, zmin, zmax, nb, inv_n);
    b.empty = xs == 0u;
    *box = b;
  }
  __syncthreads();
}

// The mip a kernel reads: the staged copy coarse_s when it is instantiated
// for n <= 256 (STAGED), else the global coarse.
template <bool STAGED>
__device__ __forceinline__ auto mip_of(const uint32_t* coarse,
                                       const uint32_t* coarse_s) {
  if constexpr (STAGED) {
    return SharedMip{coarse_s};
  } else {
    return GlobalMip{coarse};
  }
}

// The column gate that descends every column (K1, K2 and K4 with
// column_skip=False): what the coarse mip's skip saves is the difference to
// SharedMip / GlobalMip.
struct AllColumns {
  __device__ __forceinline__ bool occupied(int, int, int, int, int,
                                           int) const {
    return true;
  }
};

// The column gate of K2 and K4: the mip of mip_of<STAGED> (SKIP, the
// default), or every column of the box (the column skip's attribution run).
template <bool STAGED, bool SKIP>
__device__ __forceinline__ auto skip_gate(const uint32_t* coarse,
                                          const uint32_t* coarse_s) {
  if constexpr (SKIP) {
    return mip_of<STAGED>(coarse, coarse_s);
  } else {
    return AllColumns{};
  }
}

// The column gate of K1 with a prepass mask (render_fast.py column_occ with
// colmask): column c descends iff bit c of the pixel's patch mask is set
// or the ray is steep (|dx| > 2|dz| or |dy| > 2|dz|); the block range is
// not looked at.
struct ColumnMask {
  uint32_t bits;
  bool steep;
  __device__ __forceinline__ bool occupied(int c, int, int, int, int,
                                           int) const {
    return steep || ((bits >> c) & 1u);
  }
};

// Which probed cell a sweep skips.  The primary sweep skips none; the
// shadow sweeps skip their start cell component by component (an
// out-of-range coordinate never matches a probe; K5 passes -1 for a cell
// with one, the reference's exid sentinel).
struct NoExclusion {
  __device__ __forceinline__ bool operator()(int, int, int) const {
    return false;
  }
};
struct CellExclusion {
  int x, y, z;
  __device__ __forceinline__ bool operator()(int cx, int cy, int k) const {
    return cx == x && cy == y && k == z;
  }
};

// Which 8-plane columns a sweep visits and over which t-range a probe can
// find an occupied cell.  NoClip: every column, [t_start, t_end].
struct NoClip {
  static constexpr bool kActive = false;
  __device__ __forceinline__ bool range(const Ray&, float, float, int, float,
                                        float, float&, float&, int&,
                                        int&) const {
    return true;
  }
};

// BoxClip: the columns and t-range inside the occupied box (OccBox, in
// shared memory).  A probe at t lands in an occupied cell only if its x and
// y lie in the box's (grown) extent, so t lies in the slab interval
// [T0, T1] of the x and y extents, and its plane in columns [zc0, zc1].
// The interval bounds the columns visited (one column of slack each way)
// and the column loop's own span tests; it never moves a probe, which
// stays the midpoint of the plane's segment in [t_start, t_end].  False:
// no probe of this ray can hit.  The caller sets t0, t1, c_first, c_last
// to the whole range first.
struct BoxClip {
  static constexpr bool kActive = true;
  const OccBox* box;
  __device__ __forceinline__ bool range(const Ray& r, float inv_dx,
                                        float inv_dy, int n, float t_start,
                                        float t_end, float& t0, float& t1,
                                        int& c_first, int& c_last) const {
    if (box->empty) return false;
    t0 = t_start;
    t1 = t_end;
    slab(box->x0, box->x1, r.ox, inv_dx, t0, t1);
    slab(box->y0, box->y1, r.oy, inv_dy, t0, t1);
    if (!(t0 <= t1)) return false;
    const float cpb = (float)n * 0.125f;  // columns per unit of z
    const int ca = column_at(r.oz + t0 * r.dz, cpb, n >> 3);
    const int cb = column_at(r.oz + t1 * r.dz, cpb, n >> 3);
    c_first = max(box->zc0, min(ca, cb) - 1);
    c_last = min(box->zc1, max(ca, cb) + 1);
    return c_first <= c_last;
  }
  // Intersect [t0, t1] with the t-range where o + t*d lies in [lo, hi]; a
  // NaN bound (o on a face of a ray with d == 0) leaves it as it is.
  __device__ __forceinline__ static void slab(float lo, float hi, float o,
                                              float inv, float& t0,
                                              float& t1) {
    const float ta = (lo - o) * inv;
    const float tb = (hi - o) * inv;
    if (ta != ta || tb != tb) return;
    t0 = fmaxf(t0, fminf(ta, tb));
    t1 = fminf(t1, fmaxf(ta, tb));
  }
  __device__ __forceinline__ static int column_at(float z, float cpb, int nb) {
    const float c = floorf((z + 0.5f) * cpb);
    return (int)fminf(fmaxf(c, -1.0f), (float)nb);
  }
};

// The t-range of 8-plane column c: cmin, where it starts along the ray
// (the pass's break test), and [lo, hi], clipped to [t_start, t_end].  The
// same expressions as the column's first and last plane, so every plane's
// range lies inside [lo, hi].
__device__ __forceinline__ void column_span(const Ray& r, float inv_n,
                                            float inv_dz, int c,
                                            float t_start, float t_end,
                                            float& cmin, float& lo,
                                            float& hi) {
  const float ga = (float)(c * 8);
  const float gb = (float)(c * 8 + 8);
  const float ta = (ga * inv_n - 0.5f - r.oz) * inv_dz;
  const float tb = (gb * inv_n - 0.5f - r.oz) * inv_dz;
  cmin = minp(ta, tb);
  lo = maxp(cmin, t_start);
  hi = minp(maxp(ta, tb), t_end);
}

// Whether the column's probes over [lo, hi] can reach an occupied block:
// the cells at the range's ends bound every probe (the probe geometry is
// monotone in t), then the mip's blocks over that cell range.
template <class Mip>
__device__ __forceinline__ bool column_occupied(const Mip& mip, const Ray& r,
                                                float fn, int n, int c,
                                                float lo, float hi) {
  const int xa = cell_of(r.ox + lo * r.dx, fn, n);
  const int xb = cell_of(r.ox + hi * r.dx, fn, n);
  const int ya = cell_of(r.oy + lo * r.dy, fn, n);
  const int yb = cell_of(r.oy + hi * r.dy, fn, n);
  return mip.occupied(c, n >> 3, min(xa, xb) >> 3, max(xa, xb) >> 3,
                      min(ya, yb) >> 3, max(ya, yb) >> 3);
}

// The descents of a column (see the top of this file).  EachPlane and
// PlaneMip probe plane by plane, fetching the fine word where open() is true.
struct EachPlane {
  static constexpr bool kPrefetch = false;
  __device__ __forceinline__ bool open(int, int, int) const { return true; }
};
// PlaneMip: the plane mip of an n <= 256 grid, [n, n/8] words (one x-group),
// tested at the probe's own clamped cell, so the undilated mip is exact.
struct PlaneMip {
  static constexpr bool kPrefetch = false;
  const uint32_t* __restrict__ planes;
  int nb;  // n / 8: words a plane
  __device__ __forceinline__ bool open(int k, int cx, int cy) const {
    return (__ldg(planes + k * nb + (cy >> 3)) >> (cx >> 3)) & 1u;
  }
};
struct Prefetch {
  static constexpr bool kPrefetch = true;
  __device__ __forceinline__ bool open(int, int, int) const { return true; }
};

// The midpoint probe of z-plane k: whether it hits, and the hit's t and
// (x, y) cell.  PRIMARY selects the accept rule (tN <= tF and tF >=
// t_start) over the shadow rule (tN <= tF and tN >= 0); the fine word is
// fetched only where the descent's open() is true.
template <bool PRIMARY, class Excl, class Descent = EachPlane>
__device__ __forceinline__ bool probe_plane(
    const uint32_t* __restrict__ vol, int n, float fn, float inv_n,
    float cell_half, const Ray& r, float inv_dx, float inv_dy, float inv_dz,
    int k, float t_start, float t_end, const Excl& excluded, float& t_hit,
    int& hx, int& hy, const Descent& descent = Descent{}) {
  const float gz = (float)k;
  const float pa = (gz * inv_n - 0.5f - r.oz) * inv_dz;
  const float pb = ((gz + 1.0f) * inv_n - 0.5f - r.oz) * inv_dz;
  const float lo = maxp(minp(pa, pb), t_start);
  const float hi = minp(maxp(pa, pb), t_end);
  if (!(lo < hi)) return false;
  const float tm = 0.5f * (lo + hi);
  const int cx = cell_of(r.ox + tm * r.dx, fn, n);
  const int cy = cell_of(r.oy + tm * r.dy, fn, n);
  if (!descent.open(k, cx, cy)) return false;
  const uint32_t word = __ldg(vol + (size_t)(cx >> 5) * ((size_t)n * n) +
                              (size_t)k * n + cy);
  if (!((word >> (cx & 31)) & 1u)) return false;
  if (excluded(cx, cy, k)) return false;
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
  if (!ok) return false;
  t_hit = tn;
  hx = cx;
  hy = cy;
  return true;
}

// The Prefetch descent of 8-plane column c: the words of its planes whose
// segment is not empty are all requested before any is tested (up to 8
// independent loads in flight in place of 8 load-then-test steps; each
// plane's cell by probe_plane's expressions, written out again so that
// probe_plane, every kernel's default, compiles as before), their bits
// folded into one mask (bit f: the f-th plane in pass order), then the set
// bits walked in that order through probe_plane, whose second read of the
// word is an L1 hit.  The column's result is the plane-by-plane loop's.
template <bool PRIMARY, class Excl>
__device__ __forceinline__ bool descend_prefetched(
    const uint32_t* __restrict__ vol, int n, float fn, float inv_n,
    float cell_half, const Ray& r, float inv_dx, float inv_dy, float inv_dz,
    int c, bool up, float t_start, float t_end, const Excl& excluded,
    float& t_hit, int& hx, int& hy, int& hz) {
  uint32_t word[8];
  uint64_t shift = 0u;  // cx & 31 of plane f in byte f
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int k = up ? c * 8 + f : c * 8 + 7 - f;
    const float gz = (float)k;
    const float pa = (gz * inv_n - 0.5f - r.oz) * inv_dz;
    const float pb = ((gz + 1.0f) * inv_n - 0.5f - r.oz) * inv_dz;
    const float lo = maxp(minp(pa, pb), t_start);
    const float hi = minp(maxp(pa, pb), t_end);
    word[f] = 0u;
    if (lo < hi) {
      const float tm = 0.5f * (lo + hi);
      const int cx = cell_of(r.ox + tm * r.dx, fn, n);
      const int cy = cell_of(r.oy + tm * r.dy, fn, n);
      word[f] = __ldg(vol + (size_t)(cx >> 5) * ((size_t)n * n) + (size_t)k * n + cy);
      shift |= (uint64_t)(cx & 31) << (8 * f);
    }
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    bits |= ((word[f] >> (uint32_t)((shift >> (8 * f)) & 31u)) & 1u) << f;
  }
  while (bits != 0u) {
    const int f = __ffs(bits) - 1;
    bits &= bits - 1u;
    const int k = up ? c * 8 + f : c * 8 + 7 - f;
    if (probe_plane<PRIMARY>(vol, n, fn, inv_n, cell_half, r, inv_dx, inv_dy,
                             inv_dz, k, t_start, t_end, excluded, t_hit, hx,
                             hy)) {
      hz = k;
      return true;
    }
  }
  return false;
}

// One sweep: first cell hit in plane order, with the column gate of Mip,
// the exclusion of Excl, the column / t-range of Clip and the column
// descent of Descent.
template <bool PRIMARY, class Mip, class Excl, class Clip = NoClip,
          class Descent = EachPlane>
__device__ bool sweep(const uint32_t* __restrict__ vol, Mip mip, int n,
                      float inv_n, float cell_half, const Ray& r,
                      float t_start, float t_end, Excl excluded,
                      float& t_hit, int& hx, int& hy, int& hz,
                      const Clip& clip = Clip{},
                      const Descent& descent = Descent{}) {
  if (!(r.dz > 0.0f) && !(r.dz < 0.0f)) return false;
  const bool up = r.dz > 0.0f;
  const float inv_dx = 1.0f / r.dx;
  const float inv_dy = 1.0f / r.dy;
  const float inv_dz = 1.0f / r.dz;
  const float fn = (float)n;
  const int nb = n >> 3;
  float t0 = t_start, t1 = t_end;
  int c_first = 0, c_last = nb - 1;
  if (!clip.range(r, inv_dx, inv_dy, n, t_start, t_end, t0, t1, c_first,
                  c_last)) {
    return false;
  }
  for (int ci = c_first; ci <= c_last; ++ci) {
    const int c = up ? ci : c_last + c_first - ci;
    float cmin, c_lo, c_hi;
    column_span(r, inv_n, inv_dz, c, t_start, t_end, cmin, c_lo, c_hi);
    if (cmin >= t_end) break;  // this column and all later ones are past exit
    if (!(c_lo < c_hi)) continue;
    if constexpr (Clip::kActive) {
      if (c_lo > t1) break;  // later columns start later still
      if (c_hi < t0) continue;
    }
    if (!column_occupied(mip, r, fn, n, c, c_lo, c_hi)) continue;
    if constexpr (Descent::kPrefetch) {
      if (descend_prefetched<PRIMARY>(vol, n, fn, inv_n, cell_half, r, inv_dx,
                                      inv_dy, inv_dz, c, up, t_start, t_end,
                                      excluded, t_hit, hx, hy, hz)) {
        return true;
      }
    } else {
      for (int f = 0; f < 8; ++f) {
        const int k = up ? c * 8 + f : c * 8 + 7 - f;
        if (probe_plane<PRIMARY>(vol, n, fn, inv_n, cell_half, r, inv_dx,
                                 inv_dy, inv_dz, k, t_start, t_end, excluded,
                                 t_hit, hx, hy, descent)) {
          hz = k;
          return true;
        }
      }
    }
  }
  return false;
}

// The age of the primary hit (hx, hy, hz) of a multi-state rule, from the
// age bit-planes uint32[age_bits, n/32, n, n]: bit hx & 31 of word
// [b, hx >> 5, hz, hy] of each plane b (render_fast.py _make_traversal's
// in-sweep fetch, made once, at the accepted hit).  The sweep itself runs on
// the visibility plane, so a dying cell is hit like a live one.
__device__ __forceinline__ int fetch_age(const uint32_t* __restrict__ ages,
                                         int age_bits, int n, int hx, int hy,
                                         int hz) {
  const size_t plane = (size_t)(n >> 5) * n * n;
  const size_t word = (size_t)(hx >> 5) * ((size_t)n * n) + (size_t)hz * n + hy;
  int age = 0;
  for (int b = 0; b < age_bits; ++b) {
    age |= (int)((__ldg(ages + (size_t)b * plane + word) >> (hx & 31)) & 1u) << b;
  }
  return age;
}

// The age fade of the direct term (render_fast.py:1272-1282): dying cells
// dim linearly with age, clip((S - age) / (S - 1), 0, 1); one IEEE division.
__device__ __forceinline__ float age_fade(int total_states, int age) {
  const float f = (float)(total_states - age) / (float)(total_states - 1);
  return minp(maxp(f, 0.0f), 1.0f);
}

}  // namespace ca3d
