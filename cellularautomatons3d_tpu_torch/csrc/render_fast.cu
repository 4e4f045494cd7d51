// K1: one fast-pipeline frame of a <= 256^3 volume, one thread per pixel.
//
// Replaces: cellularautomatons3d_tpu/render/render_fast.py, _make_kernel
// (launched by raytrace_tiles) and the sweep / fetch closures of
// _make_traversal.  Per pixel: camera ray, volume slab entry/exit, the
// primary plane-midpoint DDA sweep, the hard-shadow sweep toward the light
// with start-cell exclusion, Cook-Torrance shading with position albedo;
// with COMPOSE also emissive light, the cell-id-checked temporal EMA, the
// light cube, the new history, the depth overlay and gamma.
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
// Skip structure: the 8^3 coarse occupancy mip (ops/occupancy.py) sits in
// shared memory.  For each 8-plane column the sweep computes the exact
// cell range its probes can reach -- the probe geometry is monotone in t,
// so the cells at the column's clipped t-range ends bound every probe --
// and skips the column when no coarse block in that range is occupied.
// It never changes a hit.
//
// Bound on the H100: per pixel up to 2 x 32 column tests and 8 dependent
// L2 loads of packed words (the 2 MiB volume is L2-resident) per occupied
// column; rays are coherent within a 16x8 block.  The loads are latency
// bound; the float work is small.  Left for later PRs: the TPU kernel's
// supercolumn mip and z-range gates, shared-memory staging of the volume
// brick a block touches, packing the shadow rays of a warp, and the age
// planes of multi-state rules.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Camera/params vector layout: render_fast.py P_* constants.
constexpr int P_O = 9;
constexpr int P_WIN = 12;
constexpr int P_LIGHT = 14;
constexpr int P_LMAG = 17;
constexpr int P_CELLMUL = 18;
constexpr int P_ROUGH = 19;
constexpr int P_REFL = 20;
constexpr int P_MATC = 23;
constexpr int P_EMIS = 27;
constexpr int P_EMISS = 30;
constexpr int P_ROW0 = 32;
constexpr int P_ALPHA = 33;
constexpr int P_GAMMA = 34;
constexpr int P_OVERLAY = 35;
constexpr int P_LEN = 40;

constexpr int kMaxGrid = 256;
constexpr int kMaxBlocks = (kMaxGrid / 8) * (kMaxGrid / 8);
constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

// -0.5 * COT_HALF_FOV (1/tan(37.5 deg) = 1.3032254), rounded to f32 once.
constexpr float kRayZ = (float)(-0.5 * 1.3032254);
constexpr float kPi = 3.14159265359f;

struct Cam {
  float p[P_LEN];
};

// NaN-propagating min/max (jnp.minimum / jnp.maximum semantics).
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float sgn(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
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

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// One sweep: first cell hit in plane order.  PRIMARY selects the accept
// rule (tN <= tF and tF >= t_start) over the shadow rule (tN <= tF and
// tN >= 0), and the shadow sweep skips the excluded start cell.
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

// Cook-Torrance direct light (wgsl:537-633) at surface point q of the cell
// centred at co, seen from v_at, lit by a point light at lp of radiance lm.
__device__ void shade(const float* P, float qx, float qy, float qz, float cox,
                      float coy, float coz, float alr, float alg, float alb,
                      float vwx, float vwy, float vwz, float& outr,
                      float& outg, float& outb) {
  const float fxo = qx - cox, fyo = qy - coy, fzo = qz - coz;
  const float ax = fabsf(fxo), ay = fabsf(fyo), az = fabsf(fzo);
  const float m = maxp(maxp(ax, ay), az);
  const bool is_x = ax == m;
  const bool is_y = (ay == m) && !is_x;
  const bool is_z = !is_x && !is_y;
  const float nxn = is_x ? sgn(fxo) : 0.0f;
  const float nyn = is_y ? sgn(fyo) : 0.0f;
  const float nzn = is_z ? sgn(fzo) : 0.0f;
  float ldx = P[P_LIGHT] - qx, ldy = P[P_LIGHT + 1] - qy,
        ldz = P[P_LIGHT + 2] - qz;
  normalize3(ldx, ldy, ldz);
  float vx = vwx - qx, vy = vwy - qy, vz = vwz - qz;
  normalize3(vx, vy, vz);
  float hwx = ldx + vx, hwy = ldy + vy, hwz = ldz + vz;
  normalize3(hwx, hwy, hwz);
  const float rough = P[P_ROUGH];
  const float a2 = rough * rough;
  const float noh = nxn * hwx + nyn * hwy + nzn * hwz;
  const float fterm = noh * noh * (a2 - 1.0f) + 1.0f;
  const float dterm = a2 / (kPi * fterm * fterm);
  const float kd = (rough + 1.0f) * (rough + 1.0f) / 8.0f;
  const float nov = maxp(0.0f, nxn * vx + nyn * vy + nzn * vz);
  const float nol_c = maxp(0.0f, nxn * ldx + nyn * ldy + nzn * ldz);
  const float gterm = (nov / (nov * (1.0f - kd) + kd)) *
                      (nol_c / (nol_c * (1.0f - kd) + kd));
  const float hv = hwx * vx + hwy * vy + hwz * vz;
  const float p1 = 1.0f - hv;
  const float p2 = p1 * p1;
  const float p5 = p1 * (p2 * p2);  // lax.integer_pow(x, 5) order
  const float fr = P[P_REFL] + (1.0f - P[P_REFL]) * p5;
  const float fg = P[P_REFL + 1] + (1.0f - P[P_REFL + 1]) * p5;
  const float fb = P[P_REFL + 2] + (1.0f - P[P_REFL + 2]) * p5;
  const float denom = 4.0f * (vx * nxn + vy * nyn + vz * nzn) *
                      (ldx * nxn + ldy * nyn + ldz * nzn);
  const float nol = ldx * nxn + ldy * nyn + ldz * nzn;  // unclamped (wgsl:623)
  const float spec = dterm * gterm / denom;
  const float lm = P[P_LMAG];
  outr = maxp(0.0f, (alr / kPi + spec * fr) * lm * nol);
  outg = maxp(0.0f, (alg / kPi + spec * fg) * lm * nol);
  outb = maxp(0.0f, (alb / kPi + spec * fb) * lm * nol);
}

__device__ __forceinline__ float clip01(float x) {
  return minp(maxp(x, 0.0f), 1.0f);
}

template <bool COMPOSE>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    render_kernel(const uint32_t* __restrict__ vol,
                  const uint32_t* __restrict__ coarse, int n, float inv_n,
                  int width, int height, const __grid_constant__ Cam cam,
                  int shadow,
                  const float* __restrict__ hist_rgb,
                  const int* __restrict__ hist_idx, float* __restrict__ out_rgb,
                  float* __restrict__ out_depth, int* __restrict__ out_idx,
                  float* __restrict__ out_hist) {
  __shared__ uint32_t coarse_s[kMaxBlocks];
  const int nb = n >> 3;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < nb * nb; i += blockDim.x * blockDim.y) {
    coarse_s[i] = coarse[i];
  }
  __syncthreads();
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const float* P = cam.p;

  // Camera ray (render_fast.py pixel_rays).
  const float win_w = P[P_WIN], win_h = P[P_WIN + 1];
  const float ux = ((float)px + 0.5f) / win_w;
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

  float nx, fx, ny, fy, nz, fz;
  vol_slab(ray.ox, ray.dx, nx, fx);
  vol_slab(ray.oy, ray.dy, ny, fy);
  vol_slab(ray.oz, ray.dz, nz, fz);
  const float tn = maxp(maxp(nx, ny), nz);
  const float tf = minp(minp(fx, fy), fz);
  const bool active = (tn <= tf) && (tf >= 0.0f);
  const float t_start = maxp(tn, 0.0f);
  const float cell_half = inv_n * P[P_CELLMUL] * 0.5f;

  float t_hit = 0.0f;
  int hx = 0, hy = 0, hz = 0;
  const bool found =
      active && sweep<true>(vol, coarse_s, n, inv_n, cell_half, ray, t_start,
                            tf, -1, -1, -1, t_hit, hx, hy, hz);
  const float depth = found ? t_hit : (active ? tf : 0.0f);
  const int idx = found ? hx + hy * n + hz * n * n : -1;

  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (found) {
    const float qx = ray.ox + t_hit * ray.dx;
    const float qy = ray.oy + t_hit * ray.dy;
    const float qz = ray.oz + t_hit * ray.dz;
    float occl = 1.0f;
    if (shadow) {
      // Hard shadow: sweep from the hit point toward the light over
      // t in [0, volume exit], excluding the start cell.
      Ray sr;
      sr.ox = qx;
      sr.oy = qy;
      sr.oz = qz;
      sr.dx = P[P_LIGHT] - qx;
      sr.dy = P[P_LIGHT + 1] - qy;
      sr.dz = P[P_LIGHT + 2] - qz;
      normalize3(sr.dx, sr.dy, sr.dz);
      float a0, sfx, sfy, sfz;
      vol_slab(qx, sr.dx, a0, sfx);
      vol_slab(qy, sr.dy, a0, sfy);
      vol_slab(qz, sr.dz, a0, sfz);
      const float sh_tf = minp(minp(sfx, sfy), sfz);
      float t2;
      int x2, y2, z2;
      if (sweep<false>(vol, coarse_s, n, inv_n, cell_half, sr, 0.0f, sh_tf,
                       hx, hy, hz, t2, x2, y2, z2)) {
        occl = 0.0095f;
      }
    }
    const float cox = ((float)hx + 0.5f) * inv_n - 0.5f;
    const float coy = ((float)hy + 0.5f) * inv_n - 0.5f;
    const float coz = ((float)hz + 0.5f) * inv_n - 0.5f;
    const bool use_mat =
        P[P_MATC] != 0.0f || P[P_MATC + 1] != 0.0f || P[P_MATC + 2] != 0.0f;
    const float cxn = (float)hx * inv_n;
    const float cyn = (float)hy * inv_n;
    const float alr = use_mat ? P[P_MATC] : cxn;
    const float alg = use_mat ? P[P_MATC + 1] : cyn;
    const float alb = use_mat ? P[P_MATC + 2] : 1.0f - cxn;
    shade(P, qx, qy, qz, cox, coy, coz, alr, alg, alb, ray.ox, ray.oy, ray.oz,
          r, g, b);
    r = r * occl;
    g = g * occl;
    b = b * occl;
  }

  const size_t pix = (size_t)py * width + px;
  out_depth[pix] = depth;
  out_idx[pix] = idx;
  if (!COMPOSE) {
    out_rgb[3 * pix + 0] = r;
    out_rgb[3 * pix + 1] = g;
    out_rgb[3 * pix + 2] = b;
    return;
  }

  // Frame composition (render_frame_fast semantics, static camera).
  if (found) {
    const float es = P[P_EMISS];
    r = r + P[P_EMIS] * es;
    g = g + P[P_EMIS + 1] * es;
    b = b + P[P_EMIS + 2] * es;
  }
  const bool same = found && idx == hist_idx[pix];
  const float alpha = P[P_ALPHA];
  float lr = r, lg = g, lb = b;
  if (same) {
    const float pr = hist_rgb[3 * pix + 0];
    const float pg = hist_rgb[3 * pix + 1];
    const float pb = hist_rgb[3 * pix + 2];
    lr = clip01(pr + (r - pr) * alpha);
    lg = clip01(pg + (g - pg) * alpha);
    lb = clip01(pb + (b - pb) * alpha);
  }
  // Light-source cube (wgsl:866-874), drawn over black pixels only.
  const float lrad = 0.005f;
  const float ivx = 1.0f / ray.dx, ivy = 1.0f / ray.dy, ivz = 1.0f / ray.dz;
  const float l1x = (P[P_LIGHT] - lrad - ray.ox) * ivx;
  const float l2x = (P[P_LIGHT] + lrad - ray.ox) * ivx;
  const float l1y = (P[P_LIGHT + 1] - lrad - ray.oy) * ivy;
  const float l2y = (P[P_LIGHT + 1] + lrad - ray.oy) * ivy;
  const float l1z = (P[P_LIGHT + 2] - lrad - ray.oz) * ivz;
  const float l2z = (P[P_LIGHT + 2] + lrad - ray.oz) * ivz;
  const float ltn = maxp(maxp(minp(l1x, l2x), minp(l1y, l2y)), minp(l1z, l2z));
  const float ltf = minp(minp(maxp(l1x, l2x), maxp(l1y, l2y)), maxp(l1z, l2z));
  const bool black = lr == 0.0f && lg == 0.0f && lb == 0.0f;
  if (ltn <= ltf && ltf >= 0.0f && black) {
    lr = 1.0f;
    lg = 1.0f;
    lb = 1.0f;
  }
  // History is the scene with the light cube, before the overlay.
  out_hist[3 * pix + 0] = lr;
  out_hist[3 * pix + 1] = lg;
  out_hist[3 * pix + 2] = lb;
  const bool overlay = P[P_OVERLAY] == 1.0f && ux < 0.5f;
  const float inv_g = 1.0f / P[P_GAMMA];
  out_rgb[3 * pix + 0] = powf(overlay ? depth : lr, inv_g);
  out_rgb[3 * pix + 1] = powf(overlay ? 0.0f : lg, inv_g);
  out_rgb[3 * pix + 2] = powf(overlay ? 0.0f : lb, inv_g);
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n]; coarse: uint32[n/8, n/8] (ops/occupancy.py);
// cam: host float[40].  compose = 0: out_rgb is linear rgb [H, W, 3],
// hist_* and out_hist unused.  compose = 1: hist_rgb f32 [H, W, 3] and
// hist_idx i32 [H, W] are the previous frame, out_rgb is the presentation
// and out_hist the new history colour.  Returns the launch's cudaError_t.
int ca3d_render_fast(int device, const void* vol, const void* coarse, int n,
                     int width, int height, const float* cam, int shadow,
                     int compose, const void* hist_rgb, const void* hist_idx,
                     void* out_rgb, void* out_depth, void* out_idx,
                     void* out_hist, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1) {
    return cudaErrorInvalidValue;
  }
  if (compose && (hist_rgb == nullptr || hist_idx == nullptr ||
                  out_hist == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Cam c;
  for (int i = 0; i < P_LEN; ++i) c.p[i] = cam[i];
  const float inv_n = (float)(1.0 / (double)n);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* v = static_cast<const uint32_t*>(vol);
  const uint32_t* co = static_cast<const uint32_t*>(coarse);
  if (compose) {
    render_kernel<true><<<grid, block, 0, s>>>(
        v, co, n, inv_n, width, height, c, shadow,
        static_cast<const float*>(hist_rgb), static_cast<const int*>(hist_idx),
        static_cast<float*>(out_rgb), static_cast<float*>(out_depth),
        static_cast<int*>(out_idx), static_cast<float*>(out_hist));
  } else {
    render_kernel<false><<<grid, block, 0, s>>>(
        v, co, n, inv_n, width, height, c, shadow, nullptr, nullptr,
        static_cast<float*>(out_rgb), static_cast<float*>(out_depth),
        static_cast<int*>(out_idx), nullptr);
  }
  return cudaGetLastError();
}

}  // extern "C"
