// K2: cell-exact occlusion of a batch of per-pixel shadow rays, one thread
// per (query, pixel) of a tile that has work.
//
// Replaces: cellularautomatons3d_tpu/render/render_slab.py,
// _make_shadow_kernel_sweep (launched by _shadow_occlusion_sweep, the
// default backend of shadow_occlusion_batch), for the whole volume of any
// grid up to 1024^3 in one launch (the reference runs one launch per
// z-slab / x-brick and ORs them).  Per (query, pixel): the ray from the
// start point toward the target, normalised with 1/sqrtf; its exit from
// the unit volume (the reference's occlusion prep, with divisions); then
// the sweep of sweep.cuh over t in [0, exit] with the shadow accept rule
// tN >= 0, skipping the excluded cell component by component.  Untraced
// lanes return 0.  The soft-shadow samples and the GI slots of a frame
// come in one launch; above 256^3 the frame's hard shadow comes this way
// too.
//
// Operands are structure-of-arrays: start/target f32 [nq, 3, H, W], excl
// i32 [nq, 3, H, W], active u8 [nq, H, W] -> i32 [nq, H, W] (~41 B per
// query-pixel); optionally the GI states u8 [n_slots, H, W] (query q >=
// n_soft reads row q - n_soft) and q_gate, the first query row they gate.
//
// Which lanes are traced: an active lane, and from row q_gate on (the last
// GI level of a multi-bounce frame, whose states K3 wrote before this
// launch) only where its state is 1: the test the shade kernel makes
// before it reads a slot's flag (lighting_shade.cu), so a dead neighbour's
// slot, whose flag nothing reads, costs no sweep.  A gated lane writes 0
// like an inactive one.  Without states every active lane is traced.
//
// Design on the H100 (16x8 tiles, one thread per ray of a tile with work,
// one query per block): only hit pixels cast shadow and GI rays, so about
// 88 % of the lanes of a two-bounce frame, and most tiles, are untraced.
// Two kernels, chosen by the host:
//   * shadow_sweep_kernel, a block a tile, one grid z-slice per query: the
//     block reads its lanes' active flags, and a block with none (or an
//     empty volume) writes its zeros and leaves before it touches the mip.
//     It takes no gate.  It runs the launches with too few tiles to fill
//     kWaves waves of strip blocks (the sliced frames' one or two queries,
//     gi_temporal) and the column skip's attribution runs;
//   * shadow_sweep_kernel_strip, kStrip = 8 tiles a block (the full-quality
//     and every gated batch): the block's tiles are blockIdx.x + j *
//     gridDim.x, strided over the frame so that clustered hits spread
//     across blocks.  64 threads each read one tile row's 16 flags in one
//     16-byte load (and, past q_gate, its 16 states where any is active)
//     into shared memory as 0 / 1 bytes; one barrier gives the tiles with
//     work; the other tiles' zeros go out as 16-byte stores; a block with
//     work stages the mip once for its tiles and sweeps them in turn, a
//     thread a ray as in the tile form, its warps without a barrier
//     between tiles.  An idle tile costs an eighth of a block's flag round
//     trip and two 16-byte stores a thread, not a block of its own
//     (PERF.md §6).  __launch_bounds__(128, 12): 40 registers, 12 blocks an
//     SM (8 B of spill where the mip is read from L2, above 256^3).
// Each sweeps a traced ray with sweep<false> clipped to the box of occupied
// blocks (BoxClip: only the columns and t-range inside the box, exact from
// any start, inside the box or not).  The box comes with the operands: the
// occupancy rebuild's one launch (coarse_occupancy.cu) wrote it beside the
// mip, once a frame for every sweep of the frame.  The clip also serves a
// whole-volume box: its walk starts at the ray's start column, where an
// unclipped one would step from the volume's face through the columns
// behind a start inside the volume (PERF.md §6).  Up to 256^3 the mip is
// staged in shared memory (4 KiB); above, it is read from L2 (32 KiB at
// 512^3, 256 KiB at 1024^3).  One query per block keeps the sweeps of a
// query's coherent rays together; blocks that walk a tile's queries in
// turn were slower (PERF.md §6).  Bound: the operands of the traced lanes,
// every lane's flag and output (~5 B), and the column tests and probes
// inside the box; the probes are L2 hits up to 512^3 and go to HBM when
// they miss L2 at 1024^3 (128 MiB).  K5 (shadow_multi.cu), the opt-in
// backend, runs the same sweep on operands it reads where the lighting
// code leaves them, a block a tile.  Left for later work: the reference's
// start-column gate, and compacting a tile's traced lanes (a compacted K5
// lost on its active rays).  SKIP = false (column_skip = 0, the column
// skip's attribution run; no frame path sets it; the tile kernel only)
// descends every column of the box (AllColumns) and stages no mip: the
// flags are the same.  COUNT = true (a launch while a profiler records,
// utils/profiling.py work_counts) also adds the launch's traced lanes to
// the device's occlusion_lanes counter, by one atomicAdd a block with any
// (the tile kernel's count from the barrier it takes anyway,
// __syncthreads_count in place of __syncthreads_or; the strip kernel's
// from its rows' bytes); COUNT = false is the kernel without it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 8;   // tiles a block takes in the strip form
constexpr int kWaves = 8;   // waves of resident blocks a strip launch keeps
constexpr int kMinBlocks = 12;  // strip blocks an SM holds: 40 registers a thread
constexpr int kMaxDevices = 64;

// The lanes traced, summed over every counting launch on the device (the
// module's copy of it is per device, zero when it loads).
__device__ unsigned long long g_occlusion_lanes;

template <bool STAGED, bool SKIP = true, bool COUNT = false>
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
  const bool lane_active = inside && active[i1] != 0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  load_box(occ, &box, tid);
  // The barrier also publishes the box; both tests are block-uniform.
  const int any = COUNT ? __syncthreads_count(lane_active) : __syncthreads_or(lane_active);
  if (COUNT && any && tid == 0) atomicAdd(&g_occlusion_lanes, (unsigned long long)any);
  if (!any || box.empty) {
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

// One tile row's 16 bytes from `row`, of which `valid` (0..16) lie in the
// frame (0 past them): one 16-byte load where the row is whole and aligned.
__device__ __forceinline__ uint4 load_row(const uint8_t* __restrict__ row, int valid,
                                          bool vec) {
  if (vec && valid == kBlockX) return __ldg(reinterpret_cast<const uint4*>(row));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < kBlockX; ++b) {
    if (b < valid) w[b >> 2] |= (uint32_t)row[b] << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Per byte: 1 where `on` is nonzero and, with a gate, `state` is 1; else 0.
__device__ __forceinline__ uint32_t traced_bytes(uint32_t on, uint32_t state, bool gated) {
  const uint32_t t = __vcmpne4(on, 0u) & 0x01010101u;
  return gated ? t & __vcmpeq4(state, 0x01010101u) : t;
}

// The block's tile j of the strip form: strided over the frame, so a
// block's tiles, and the clustered hits, spread (tiles in a row of the frame
// were slower on the two-bounce batch, PERF.md §6).
__device__ __forceinline__ int strip_tile(int j) {
  return (int)blockIdx.x + j * (int)gridDim.x;
}

// The strip form: kStrip tiles a block, gated from row q_gate on where
// `states` is given.  vec: 16-byte rows (width % 16 == 0 and the flag
// tensors 16-byte aligned).
template <bool STAGED, bool COUNT = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shadow_sweep_kernel_strip(const uint32_t* __restrict__ vol,
                              const uint32_t* __restrict__ coarse, const OccBox* occ,
                              int n, float inv_n, float cell_half, int width, int height,
                              int tiles_x, int n_tiles, int vec,
                              const float* __restrict__ start,
                              const float* __restrict__ target,
                              const int* __restrict__ excl,
                              const uint8_t* __restrict__ active,
                              const uint8_t* __restrict__ states, int q_gate, int n_soft,
                              int* __restrict__ out) {
  __shared__ uint32_t coarse_s[STAGED ? kMaxStagedWords : 1];
  __shared__ OccBox box;
  __shared__ uint4 rows_s[kStrip * kBlockY];  // traced bytes, [row][tile]
  __shared__ uint32_t warp_s[kWarps];
  __shared__ int count_s[COUNT ? kWarps : 1];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const size_t npix = (size_t)width * height;
  const size_t q = blockIdx.z;
  const uint8_t* act = active + q * npix;
  const uint8_t* gate =
      states != nullptr && (int)q >= q_gate ? states + (q - n_soft) * npix : nullptr;
  int* const flags = out + q * npix;
  // Thread c < 64 reads row c / kStrip of tile c % kStrip: its 16 flags at
  // once (before the box), then the gate's states where any is active,
  // into rows_s as 0 / 1 bytes.
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  {
    const int tile = strip_tile(tid % kStrip);
    const int x0 = (tile % tiles_x) * kBlockX;
    const int y = (tile / tiles_x) * kBlockY + tid / kStrip;
    const bool row_in = tid < kStrip * kBlockY && tile < n_tiles && y < height;
    const int valid = min(kBlockX, width - x0);
    const size_t at = (size_t)y * width + x0;
    if (row_in) v = load_row(act + at, valid, vec);
    load_box(occ, &box, tid);
    if (tid < kStrip * kBlockY) {
      const bool gated = gate != nullptr;
      uint4 s = make_uint4(0u, 0u, 0u, 0u);
      if (gated && (v.x | v.y | v.z | v.w)) s = load_row(gate + at, valid, vec);
      v = make_uint4(traced_bytes(v.x, s.x, gated), traced_bytes(v.y, s.y, gated),
                     traced_bytes(v.z, s.z, gated), traced_bytes(v.w, s.w, gated));
      rows_s[tid] = v;
    }
  }
  // Tile j has a traced lane where a row of it has: bit j of the warps'
  // ballots folded by tile (lane % kStrip).
  const uint32_t b = __ballot_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u);
  if ((tid & 31) == 0) warp_s[tid >> 5] = (b | b >> 8 | b >> 16 | b >> 24) & 0xffu;
  if constexpr (COUNT) {
    const int lanes = (int)__reduce_add_sync(
        0xffffffffu, (unsigned)(__popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w)));
    if ((tid & 31) == 0) count_s[tid >> 5] = lanes;
  }
  __syncthreads();  // also publishes the box
  uint32_t work = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) work |= warp_s[w];
  if (COUNT && tid == 0) {
    int lanes = 0;
    for (int w = 0; w < kWarps; ++w) lanes += count_s[w];
    if (lanes) atomicAdd(&g_occlusion_lanes, (unsigned long long)lanes);
  }
  if (box.empty) work = 0;
  // Every tile without work: its zeros, four flags a store (thread k of
  // 256 writes row k / 32's flags 4 (k % 4) .. of tile (k / 4) % 8).
#pragma unroll
  for (int k = tid; k < kStrip * kBlockY * 4; k += kThreads) {
    const int j = (k >> 2) % kStrip;
    if (work >> j & 1u) continue;
    const int tile = strip_tile(j);
    const int x = (tile % tiles_x) * kBlockX + 4 * (k & 3);
    const int y = (tile / tiles_x) * kBlockY + k / (4 * kStrip);
    if (tile >= n_tiles || y >= height) continue;
    int* f = flags + (size_t)y * width + x;
    if (vec) {
      *reinterpret_cast<int4*>(f) = make_int4(0, 0, 0, 0);
    } else {
      for (int e = 0; e < 4 && x + e < width; ++e) f[e] = 0;
    }
  }
  if (!work) return;
  if constexpr (STAGED) stage_coarse(coarse, coarse_s, n);
  // Every tile with work, a thread a ray as in the tile form; a warp with
  // no traced lane in it stores its zeros.
#pragma unroll 1
  for (int j = 0; j < kStrip; ++j) {
    if (!(work >> j & 1u)) continue;
    const int tile = strip_tile(j);
    const int px = (tile % tiles_x) * kBlockX + threadIdx.x;
    const int py = (tile / tiles_x) * kBlockY + threadIdx.y;
    if (px >= width || py >= height) continue;
    const uint4 row = rows_s[threadIdx.y * kStrip + j];
    const uint32_t word = threadIdx.x < 8 ? (threadIdx.x < 4 ? row.x : row.y)
                                          : (threadIdx.x < 12 ? row.z : row.w);
    const int p = py * width + px;
    int occluded = 0;
    if (word >> (8 * (threadIdx.x & 3)) & 1u) {
      const size_t i3 = 3 * q * npix + p;  // [nq, 3, H, W], component 0
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
      occluded = sweep<false>(vol, skip_gate<STAGED, true>(coarse, coarse_s), n, inv_n,
                              cell_half, r, 0.0f, t1, skip, t_hit, hx, hy, hz, BoxClip{&box})
                     ? 1
                     : 0;
    }
    flags[p] = occluded;
  }
}

using StripKernel = decltype(&shadow_sweep_kernel_strip<true>);

// Whether an ungated launch of `tiles` tiles takes the strip form: where
// its blocks of kStrip tiles still make kWaves waves of the blocks `kernel`
// keeps resident on the device's SMs (read once a device and kernel).
bool strip_form(int device, StripKernel kernel, int kernel_id, long long tiles) {
  static int resident[kMaxDevices][4];
  int* slot = device < kMaxDevices ? &resident[device][kernel_id] : nullptr;
  int r = slot != nullptr ? *slot : 0;
  if (r == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess) {
      return false;
    }
    r = sms * per_sm > 0 ? sms * per_sm : 1;
    if (slot != nullptr) *slot = r;
  }
  return (tiles + kStrip - 1) / kStrip >= (long long)kWaves * r;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coarse: uint32[n/8, XG*n/8]
// (ops/occupancy.py, XG = ceil(n/256)), 16-byte aligned; start, target:
// f32 [nq, 3, H, W]; excl: i32 [nq, 3, H, W]; active: u8 [nq, H, W]; out:
// i32 [nq, H, W] (1 = occluded).  states: u8 [nq - n_soft, H, W], the GI
// states that gate rows q_gate .. nq - 1 (n_soft <= q_gate <= nq), or null
// (no gate).  cell_half is the visible cube's half size, (1/n) * cell_size
// * 0.5 in f32.  box: int32[8], the OccBox of coarse (ops/occupancy.py
// occupied_box).  column_skip = 0 descends every column of the box (SKIP =
// false, the tile kernel).  tiles, a hook for tests and attribution: 1 for
// the tile kernel, kStrip for the strip kernel, 0 (every frame path) to
// choose: the strip kernel for a gate, the tile kernel for column_skip =
// 0, else by the launch's tile count.  A gate takes the strip kernel and
// the column skip.  count = 1 adds the traced lanes to the device's
// occlusion_lanes (COUNT = true).  Returns the launch's cudaError_t.
int ca3d_shadow_sweep(int device, const void* vol, const void* coarse, int n,
                      float cell_half, int width, int height, int nq,
                      const void* start, const void* target, const void* excl,
                      const void* active, const void* states, int q_gate,
                      int n_soft, void* out, int column_skip, const void* box,
                      int tiles, int count, void* stream) {
  const bool gated = states != nullptr;
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || width < 1 || height < 1 ||
      (long long)width * height > INT_MAX || nq < 1 || nq > 65535 ||
      box == nullptr || (tiles != 0 && tiles != 1 && tiles != kStrip) ||
      (gated && !(0 <= n_soft && n_soft <= q_gate && q_gate <= nq)) ||
      (gated && (tiles == 1 || !column_skip)) || (tiles == kStrip && !column_skip)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float inv_n = (float)(1.0 / (double)n);
  const int tiles_x = (width + kBlockX - 1) / kBlockX;
  const int tiles_y = (height + kBlockY - 1) / kBlockY;
  const int n_tiles = tiles_x * tiles_y;
  const int c = count ? 1 : 0;
  const int staged = n <= kMaxStagedGrid ? 0 : 1;
  // [count][staged or not]
  static const StripKernel strips[2][2] = {
      {shadow_sweep_kernel_strip<true>, shadow_sweep_kernel_strip<false>},
      {shadow_sweep_kernel_strip<true, true>, shadow_sweep_kernel_strip<false, true>}};
  bool strip = gated || tiles == kStrip;
  if (tiles == 0 && !strip && column_skip) {
    strip = strip_form(device, strips[c][staged], 2 * c + staged, (long long)n_tiles * nq);
  }
  if (strip) {
    const int vec = width % kBlockX == 0 && reinterpret_cast<uintptr_t>(active) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(states) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
    strips[c][staged]<<<dim3((n_tiles + kStrip - 1) / kStrip, 1, nq), dim3(kBlockX, kBlockY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(vol), static_cast<const uint32_t*>(coarse),
        static_cast<const OccBox*>(box), n, inv_n, cell_half, width, height, tiles_x, n_tiles,
        vec, static_cast<const float*>(start), static_cast<const float*>(target),
        static_cast<const int*>(excl), static_cast<const uint8_t*>(active),
        static_cast<const uint8_t*>(states), q_gate, n_soft, static_cast<int*>(out));
    return cudaGetLastError();
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(tiles_x, tiles_y, nq);
  // [count][column_skip ? staged or not : every column]
  using Kernel = decltype(&shadow_sweep_kernel<true>);
  static const Kernel kernels[2][3] = {
      {shadow_sweep_kernel<true>, shadow_sweep_kernel<false>, shadow_sweep_kernel<false, false>},
      {shadow_sweep_kernel<true, true, true>, shadow_sweep_kernel<false, true, true>,
       shadow_sweep_kernel<false, false, true>}};
  const Kernel kernel = kernels[c][!column_skip ? 2 : staged];
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vol), static_cast<const uint32_t*>(coarse),
      static_cast<const OccBox*>(box), n, inv_n, cell_half, width, height,
      static_cast<const float*>(start), static_cast<const float*>(target),
      static_cast<const int*>(excl), static_cast<const uint8_t*>(active),
      static_cast<int*>(out));
  return cudaGetLastError();
}

// *out = the device's occlusion_lanes, copied after the work queued before.
int ca3d_shadow_sweep_lanes(int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaMemcpyFromSymbol(out, g_occlusion_lanes, sizeof(*out));
}

}  // extern "C"
