// The plane-level block mip of a packed volume, for K1's mip1 descent.
//
// Replaces: cellularautomatons3d_tpu/ops/occupancy.py plane_occupancy (XLA
// in the reference: bitwise_or.reduce over each 8-word y-block, then the
// x-nibble compression of _compress_x_groups).  Its plain twin is the
// port's ops/occupancy.py plane_occupancy, bit for bit.
//
// Output [n, XG*n/8] words (XG = ceil(n/256) x-groups, group-major): bit
// xb & 31 of word (z, (xb >> 5)*Yc + yb) is set iff the 1x8x8 block (z, xb,
// yb) holds a live cell.  One thread an output word (csrc/block_mip.cuh
// block_row_word): it reads the 8 y-words of its block row in each of the
// group's (up to 8) packed x-words, two 16-byte loads each, all 16 issued
// before any is used, ORs each set of 8 and sets bit 4*wi + b where byte b
// of the OR is non-zero (byte b of word wi is x-block 4*(8g + wi) + b).
// Neighbouring threads take neighbouring y-blocks, so a warp's loads of one
// x-word are 1 KiB contiguous.  Bound: the volume's bytes, read once (2 MiB
// at 256^3: 0.0006 ms at 3.35 TB/s); the plain twin is a dozen torch
// launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_mip.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    plane_occupancy_kernel(const uint4* __restrict__ vol, int n,
                           uint32_t* __restrict__ out) {
  const int yc = n >> 3;
  const int xg = ((n >> 5) + 7) >> 3;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * xg * yc) return;
  const int yb = i % yc;
  const int g = (i / yc) % xg;
  const int z = i / (yc * xg);
  out[i] = ca3d::block_row_word(vol, n, z, g, yb);
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], 16-byte aligned, n a multiple of 32 up to 1024;
// out: uint32[n, XG*n/8] (ops/occupancy.py plane_occupancy).  Returns the
// launch's cudaError_t.
int ca3d_plane_occupancy(int device, const void* vol, int n, void* out,
                         void* stream) {
  if (n < 32 || n > 1024 || n % 32 != 0 ||
      (reinterpret_cast<uintptr_t>(vol) & 15u) != 0u) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int total = n * (((n >> 5) + 7) >> 3) * (n >> 3);
  plane_occupancy_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(vol), n, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
