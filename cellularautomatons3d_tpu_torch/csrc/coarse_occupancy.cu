// The occupancy a frame rebuilds before its sweeps, in one launch: the 8^3
// block mip of a packed volume (K1's staged mip; K6's mip), with BOX the box
// of its occupied blocks (the clip of K2, K4 and K5), and with PLANE the
// plane-level mip of K1's opt-in mip1 descent.
//
// Replaces: cellularautomatons3d_tpu/ops/occupancy.py coarse_occupancy and
// plane_occupancy (XLA in the reference: bitwise_or.reduce over each 8x8
// (z, y) block, or over each 8-word y-block of a plane, then the x-nibble
// compression of _compress_x_groups), and the occupied z-range the
// reference derives from the 8^3 mip in the same rebuild
// (render/render_fast.py raytrace_tiles, XLA).  Plain twins: the port's
// ops/occupancy.py coarse_occupancy, plane_occupancy and occupied_box, bit
// for bit.
//
// Outputs, XG = ceil(n/256) x-groups laid out group-major: the 8^3 mip
// [n/8, XG*n/8], bit xb & 31 of word (zc, (xb >> 5)*Yc + yb) set iff the 8^3
// block (zc, xb, yb) holds a live cell; the plane mip [n, XG*n/8], the same
// for the 1x8x8 block (z, xb, yb).  Byte b of packed x-word 8g + wi is
// x-block 4*(8g + wi) + b, bit 4*wi + b of its group's word.  A plane word
// ORs the 8 y-words of its block row in each of the group's x-words (256
// bytes); an 8^3 word is the OR of the 8 plane words of its z-row, so one
// pass over the volume gives both.
//
// Bound: the volume's bytes, read once, for both outputs: 2 / 16 / 128 MiB
// at 256^3 / 512^3 / 1024^3, 0.00063 / 0.0050 / 0.0401 ms at 3.35 TB/s (the
// plane mip adds n^2*XG/2 bytes of stores: 32 KiB / 128 KiB / 2 MiB).  Up to
// 512^3 the CA step has just written the volume into the 50 MB L2, so a time
// there can fall under that bound; the floor is a launch, 1.0 us of device
// time.  The plane mip had its own launch, a thread a plane word (32 blocks
// at 256^3, 6.0x the bound), which read the volume a second time on every
// mip1 frame; it is now the PLANE form of this launch.
//
// Two mappings, picked by n at launch:
// * n <= 256 (one x-group): a block of 256 threads a 4-word strip (one z-row,
//   4 neighbouring y-blocks), each thread 2 loads of 16 bytes: 256 blocks at
//   256^3 (64 K threads), so every SM holds several warps, where a thread a
//   plane word gave 32 blocks on a quarter of the SMs (7.3x the bound).  Warp
//   w holds plane 8 zc + w; lane = 8 * j + 2 * y-block + half, and the
//   thread's two loads are x-words j and j + 4, so a warp's load is 4 rows
//   (x-word, plane) of 128 contiguous bytes.  Three XOR shuffles (the halves,
//   lane bits 3-4) leave each warp with its plane's finished words of the 4
//   y-blocks, which PLANE stores; the 8 warps (planes) fold through shared
//   memory into the 8^3 words.
// * n > 256: a thread a plane word (block_mip.cuh block_row_word, 16 loads
//   of 16 bytes in flight), which PLANE stores; the 8 z-threads of a block
//   word neighbouring lanes folded by three XOR shuffles; 256 / 2048 blocks
//   at 512^3 / 1024^3, already 1.37x / 1.21x the bound there.  Strips at
//   every n (PERF.md §6) took the mip alone 17 % / 5 % under this mapping at
//   512^3 / 1024^3, but with the box tied at 512^3 and lost 11 % at 1024^3
//   (16 K blocks folding and taking tickets), and above 256^3 only the box
//   variant runs on a frame path (the sliced frames).
//
// The box (BOX): each block reduces the words it wrote to a partial (the x
// bits of each group, y-block and z-row ranges), warp reductions then one
// warp, and one lane a field folds it into one of 32 accumulator slots with
// atomicOr / atomicMax (a block's slot is its index mod 32, which spreads
// the atomics of a 2048-block grid).  Each block then takes a ticket; the
// block that takes the last one folds the slots, clearing them, builds the
// OccBox with sweep.cuh's make_box (the helper of K1's stage_coarse_box and
// of occupied_box.cu, so all three agree) and resets the ticket.  The
// accumulator is scratch of one (device, stream): zeroed once at first use
// (ops/occupancy.py) and left zero by every launch, so launches on one
// stream never share it while it is in use.  Every field is kept in "max"
// form with identity 0 (y-block + 1, nb - y-block, ...), so zero is the
// empty partial.  An empty mip gives all-zero words but `empty`.  The fold
// costs ~2 us of device time over the mip alone (PERF.md §6: the fence, the
// ticket and the last block's read of the slots follow the loads in turn; a
// release fence in place of __threadfence changed nothing), so a frame that
// runs only K1 launches the mip without it (BOX = false).  PLANE composes
// with BOX: the box folds the 8^3 words as without it.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_mip.cuh"
#include "sweep.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFineMaxGrid = 256;  // largest n of the strip mapping
constexpr int kSlots = 32;         // accumulator slots, one per lane
constexpr int kFields = 8;         // 4 x-group bit sets, 4 "max" extents
constexpr unsigned kAll = 0xFFFFFFFFu;

// The box of the block's words, folded into the launch's box.  bits: the
// word this thread contributes (0 for none), of x-group g, y-block yb and
// z-row zc.  Every thread of the block calls it, once, after its stores.
// scratch: kSlots * kFields accumulator words, then the ticket.
__device__ __forceinline__ void fold_box(uint32_t bits, int g, int yb, int zc,
                                         int nb, float inv_n,
                                         uint32_t* __restrict__ scratch,
                                         OccBox* __restrict__ box) {
  __shared__ uint32_t part[kWarps][kFields];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const bool any = bits != 0u;
  uint32_t v[kFields];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __reduce_or_sync(kAll, g == j ? bits : 0u);
  v[4] = __reduce_max_sync(kAll, any ? (unsigned)(yb + 1) : 0u);
  v[5] = __reduce_max_sync(kAll, any ? (unsigned)(nb - yb) : 0u);
  v[6] = __reduce_max_sync(kAll, any ? (unsigned)(zc + 1) : 0u);
  v[7] = __reduce_max_sync(kAll, any ? (unsigned)(nb - zc) : 0u);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kFields; ++j) part[wp][j] = v[j];
  }
  __syncthreads();
  if (wp != 0) return;
  if (lane < kFields) {
    uint32_t a = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a = lane < 4 ? (a | part[w][lane]) : max(a, part[w][lane]);
    }
    if (a != 0u) {
      uint32_t* slot = scratch + (blockIdx.x % kSlots) * kFields + lane;
      if (lane < 4) {
        atomicOr(slot, a);
      } else {
        atomicMax(slot, a);
      }
    }
  }
  // Each lane's atomics are visible before lane 0 takes the block's ticket.
  __threadfence();
  __syncwarp();
  unsigned ticket = 0u;
  if (lane == 0) ticket = atomicAdd(scratch + kSlots * kFields, 1u);
  if (__shfl_sync(kAll, ticket, 0) != gridDim.x - 1) return;
  // The last block: lane l takes slot l, clearing it for the next launch.
  __threadfence();
  uint32_t s[kFields];
#pragma unroll
  for (int j = 0; j < kFields; ++j) {
    s[j] = atomicExch(scratch + lane * kFields + j, 0u);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = __reduce_or_sync(kAll, s[j]);
#pragma unroll
  for (int j = 4; j < kFields; ++j) s[j] = __reduce_max_sync(kAll, s[j]);
  if (lane != 0) return;
  scratch[kSlots * kFields] = 0u;
  OccBox b = {};
  if (s[6] == 0u) {
    b.empty = 1;
  } else {
    int xb0 = -1, xb1 = -1;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      if (s[j] != 0u) xb0 = 32 * j + __ffs(s[j]) - 1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (s[j] != 0u) xb1 = 32 * j + 31 - __clz(s[j]);
    }
    b = make_box(xb0, xb1, nb - (int)s[5], (int)s[4] - 1, nb - (int)s[7],
                 (int)s[6] - 1, nb, inv_n);
  }
  *box = b;
}

// The word of this thread's strip (n <= 256) and its place: block b is the
// strip of z-row b / (nb/4), y-blocks 4 (b % (nb/4)) .. + 3; warp w takes
// plane 8 zc + w, and lane l loads x-words (l >> 3) and (l >> 3) + 4 (those
// past the volume read as empty), half l & 1 of y-block (l >> 1) & 3;
// threads 0-3 end with the strip's 4 words and store them, the others with
// 0.  PLANE: lanes 0, 2, 4, 6 of each warp store its plane's 4 words.
template <bool PLANE>
__device__ __forceinline__ uint32_t strip_word(const uint4* __restrict__ vol, int n,
                                               uint32_t* __restrict__ out,
                                               uint32_t* __restrict__ plane, int& yb,
                                               int& zc) {
  __shared__ uint32_t part[kWarps][4];
  const int nb = n >> 3, words = n >> 5;
  const int strips = nb >> 2;
  const int y0 = (blockIdx.x % strips) * 4;
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  zc = blockIdx.x / strips;
  yb = y0 + ((lane >> 1) & 3);
  const int z = zc * 8 + wp;
  uint4 v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int wi = (lane >> 3) + 4 * k;
    const size_t at = ((((size_t)wi * n + z) * n + (size_t)yb * 8) >> 2) + (lane & 1);
    v[k] = wi < words ? __ldg(vol + at) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int wi = (lane >> 3) + 4 * k;  // < 8: no shift past the word
    bits |= byte_bits(v[k].x | v[k].y | v[k].z | v[k].w) << (4 * wi);
  }
  // OR over the 2 halves (lane bit 0) and the 4 x-word pairs (bits 3-4):
  // the plane word of each y-block.
  bits |= __shfl_xor_sync(kAll, bits, 1);
  bits |= __shfl_xor_sync(kAll, bits, 8);
  bits |= __shfl_xor_sync(kAll, bits, 16);
  if ((lane & 0x19) == 0) {
    part[wp][lane >> 1] = bits;
    if constexpr (PLANE) plane[(size_t)z * nb + yb] = bits;
  }
  __syncthreads();
  uint32_t word = 0u;
  yb = y0 + t;
  if (t < 4) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) word |= part[w][t];
    out[zc * nb + yb] = word;
  }
  return word;
}

// The word of this thread's plane (n > 256) and its place: thread i is plane
// 8 zc + (i & 7) of output word i >> 3 = (zc * xg + g) * nb + yb; PLANE
// stores the plane word before the fold.  The thread count is a multiple of
// 32 (n and so nb are multiples of 4), so a warp is wholly in or out and the
// shuffles see all 32 lanes.
template <bool PLANE>
__device__ __forceinline__ uint32_t plane_word(const uint4* __restrict__ vol, int n,
                                               uint32_t* __restrict__ out,
                                               uint32_t* __restrict__ plane, int& g,
                                               int& yb, int& zc) {
  const int nb = n >> 3;
  const int xg = ((n >> 5) + 7) >> 3;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int word = i >> 3;
  yb = word % nb;
  g = (word / nb) % xg;
  zc = word / (nb * xg);
  if (i >= n * xg * nb) return 0u;
  const int z = zc * 8 + (i & 7);
  uint32_t bits = block_row_word(vol, n, z, g, yb);
  if constexpr (PLANE) plane[((size_t)z * xg + g) * nb + yb] = bits;
  // OR over the block's 8 planes: lanes 8k .. 8k + 7.
  bits |= __shfl_xor_sync(kAll, bits, 1);
  bits |= __shfl_xor_sync(kAll, bits, 2);
  bits |= __shfl_xor_sync(kAll, bits, 4);
  if ((i & 7) == 0) out[word] = bits;
  return bits;
}

template <bool STRIP, bool BOX, bool PLANE>
__global__ void __launch_bounds__(kThreads)
    coarse_occupancy_kernel(const uint4* __restrict__ vol, int n,
                            uint32_t* __restrict__ out, uint32_t* __restrict__ plane,
                            float inv_n, uint32_t* __restrict__ scratch,
                            OccBox* __restrict__ box) {
  int g = 0, yb, zc;
  uint32_t bits;
  if constexpr (STRIP) {
    bits = strip_word<PLANE>(vol, n, out, plane, yb, zc);
  } else {
    bits = plane_word<PLANE>(vol, n, out, plane, g, yb, zc);
  }
  if constexpr (BOX) fold_box(bits, g, yb, zc, n >> 3, inv_n, scratch, box);
}

using Kernel = void (*)(const uint4*, int, uint32_t*, uint32_t*, float, uint32_t*, OccBox*);

template <bool STRIP>
Kernel pick(bool box, bool plane) {
  if (box) {
    return plane ? coarse_occupancy_kernel<STRIP, true, true>
                 : coarse_occupancy_kernel<STRIP, true, false>;
  }
  return plane ? coarse_occupancy_kernel<STRIP, false, true>
               : coarse_occupancy_kernel<STRIP, false, false>;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], 16-byte aligned, n a multiple of 32 up to 1024;
// out: uint32[n/8, XG*n/8] (ops/occupancy.py coarse_occupancy).  plane: null
// for no plane mip, else uint32[n, XG*n/8] (ops/occupancy.py
// plane_occupancy).  box: null for no box, else int32[8], the OccBox
// {empty, full, zc0, zc1, x0, x1, y0, y1} of the mip (ops/occupancy.py
// occupied_box), and scratch: uint32[kSlots * kFields + 1] of this stream,
// all zero before the launch and after it.  Returns the launch's
// cudaError_t.
int ca3d_coarse_occupancy(int device, const void* vol, int n, void* out, void* plane,
                          void* scratch, void* box, void* stream) {
  if (n < 32 || n > kMaxGrid || n % 32 != 0 || out == nullptr ||
      (reinterpret_cast<uintptr_t>(vol) & 15u) != 0u ||
      (box != nullptr && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nb = n >> 3;
  const bool strip = n <= kFineMaxGrid;
  const int blocks = strip ? nb * (nb >> 2)
                           : (n * (((n >> 5) + 7) >> 3) * nb + kThreads - 1) / kThreads;
  const Kernel kernel = strip ? pick<true>(box != nullptr, plane != nullptr)
                              : pick<false>(box != nullptr, plane != nullptr);
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(vol), n, static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(plane), (float)(1.0 / (double)n),
      static_cast<uint32_t*>(scratch), static_cast<OccBox*>(box));
  return cudaGetLastError();
}

// The scratch words ca3d_coarse_occupancy's box needs per stream.
int ca3d_coarse_occupancy_scratch_words() { return kSlots * kFields + 1; }

}  // extern "C"
