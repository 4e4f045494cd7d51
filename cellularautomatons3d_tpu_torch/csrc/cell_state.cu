// K3: per-pixel cell-state lookups for a batch of target coordinates, one
// thread per run of 8 pixels of one query.
//
// Replaces: cellularautomatons3d_tpu/render/render_slab.py,
// _make_cellstate_kernel (launched by cell_state_batch), for the whole
// volume of any grid up to 1024^3 in one launch (the reference runs one
// launch per z-slab / x-brick and ORs them).  Each output is the
// reference's clamp-then-wrap lookup state(max(c, 0) mod n)
// (pathtraced_fragment_clustered.wgsl:268-304, intersect.py
// get_cell_state): bit x & 31 of packed word [x / 32, z, y].  Inactive
// lanes return 0.  The GI neighbour slots of one frame level come in one
// launch.
//
// Operands (queries.cuh): per query the coordinates [H, W, 3] int32 or
// int64 and the active mask [H, W], as the lighting passes make them,
// through a table of pointers and strides passed by value (torch stacks
// and casts nothing before a launch) -> u8 [nq, H, W].
//
// Design on the H100: a small, bytes-bound kernel.  A thread serves 8
// consecutive pixels of one query (blockIdx.y): their flags come in one
// 8-byte load and their states go out in one 8-byte store; only active
// pixels read their coordinates (3 loads) and gather one packed word.  The
// GI slots ask for cells in [-1, n] (a hit cell plus a unit offset), so the
// wrap is a compare and a subtract, with % kept for a larger coordinate so
// that every coordinate stays exact.  The volume is L2-resident up to
// 512^3 (16 MiB); at 1024^3 (128 MiB) a lookup may go to HBM, one 32-byte
// sector each.  The TPU kernel's z-group bitmask gate and finer strips
// exist to avoid its plane sweep; a gather needs neither.

#include <cstdint>
#include <cuda_runtime.h>

#include "queries.cuh"

namespace {

using namespace ca3d;

constexpr int kThreads = 256;
constexpr int kPixels = 8;  // pixels per thread

// max(c, 0) mod n.
__device__ __forceinline__ int wrap(long long c, int n) {
  if (c < 0) return 0;
  if (c < n) return (int)c;
  if (c < 2 * (long long)n) return (int)(c - n);
  return (int)(c % n);
}

__device__ __forceinline__ uint32_t state_at(const uint32_t* __restrict__ vol,
                                             int n, const PixelCells& cells,
                                             long long p) {
  const int x = wrap(cells.at(p, 0), n);
  const int y = wrap(cells.at(p, 1), n);
  const int z = wrap(cells.at(p, 2), n);
  const uint32_t word =
      __ldg(vol + ((size_t)(x >> 5) * n + z) * (size_t)n + y);
  return (word >> (x & 31)) & 1u;
}

// vec: every active mask and the output rows are 8-byte aligned, so a run
// of 8 pixels inside the frame takes one load and one store.
__global__ void __launch_bounds__(kThreads)
    cell_state_kernel(const uint32_t* __restrict__ vol, int n, long long npix,
                      int vec, const __grid_constant__ CellQueries qs,
                      uint8_t* __restrict__ out) {
  const CellQuery& cq = qs.q[blockIdx.y];
  const long long p0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPixels;
  if (p0 >= npix) return;
  uint8_t* o = out + blockIdx.y * npix;
  if (vec && p0 + kPixels <= npix) {
    const uint2 f = *reinterpret_cast<const uint2*>(cq.active + p0);
    uint2 s = make_uint2(0u, 0u);
    if (f.x | f.y) {
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        const uint32_t w = k < 4 ? f.x : f.y;
        if ((w >> (8 * (k & 3))) & 0xFFu) {
          const uint32_t b = state_at(vol, n, cq.coords, p0 + k) << (8 * (k & 3));
          if (k < 4) s.x |= b; else s.y |= b;
        }
      }
    }
    *reinterpret_cast<uint2*>(o + p0) = s;
    return;
  }
  for (long long p = p0; p < p0 + kPixels && p < npix; ++p) {
    o[p] = cq.active[p] ? (uint8_t)state_at(vol, n, cq.coords, p) : 0;
  }
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; queries: nq rows of kCellRow int64
// (queries.cuh), 1 <= nq <= 8, every operand on the device; out: u8
// [nq, H, W] (0/1).  Returns the launch's cudaError_t.
int ca3d_cell_state(int device, const void* vol, int n, int width, int height,
                    int nq, const long long* queries, void* out,
                    void* stream) {
  if (n < 32 || n > 1024 || n % 32 != 0 || width < 1 || height < 1 ||
      nq < 1 || nq > kMaxQueries || queries == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long npix = (long long)width * height;
  const CellQueries qs = cell_queries(queries, nq);
  int vec = npix % kPixels == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  for (int i = 0; i < nq; ++i) {
    vec = vec && reinterpret_cast<uintptr_t>(qs.q[i].active) % 8 == 0;
  }
  const long long runs = (npix + kPixels - 1) / kPixels;
  const dim3 grid((unsigned)((runs + kThreads - 1) / kThreads), nq);
  cell_state_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vol), n, npix, vec, qs,
      static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
