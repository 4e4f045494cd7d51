// The 8^3 block mip of a packed volume: the occupancy every frame path
// rebuilds before its sweeps (K1's staged mip, the box, K2 / K4 / K5 / K6).
//
// Replaces: cellularautomatons3d_tpu/ops/occupancy.py coarse_occupancy (XLA
// in the reference: bitwise_or.reduce over each 8x8 (z, y) block, then the
// x-nibble compression of _compress_x_groups).  Its plain twin is the
// port's ops/occupancy.py coarse_occupancy, bit for bit; eager torch runs
// that twin as a dozen launches, which the fused loop paid every frame.
//
// Output [n/8, XG*n/8] words (XG = ceil(n/256) x-groups, group-major): bit
// xb & 31 of word (zc, (xb >> 5)*Yc + yb) is set iff the 8^3 block (zc, xb,
// yb) holds a live cell.  One thread a plane word, as csrc/plane_occupancy.cu:
// csrc/block_mip.cuh block_row_word reads the 8 y-words of its block row at
// one z in each of the group's (up to 8) packed x-words, 16 loads of 16
// bytes in flight, and sets bit 4*wi + b where byte b of their OR is
// non-zero.  The 8 z-threads of a block word are neighbouring lanes
// (lane = 8 * (yb & 3) + (z & 7)) and fold their words with three XOR
// shuffles; the first of them stores.  A warp thus covers 4 y-blocks x 8
// planes: its loads of one x-word are 8 rows of 128 contiguous bytes.  A
// partial last x-group (n = 288-480) reads no word past the volume and
// keeps its high bits zero.  Bound: the volume's bytes, read once (2 / 16
// / 128 MiB at 256^3 / 512^3 / 1024^3: 0.0006 / 0.0050 / 0.0401 ms at
// 3.35 TB/s); up to 512^3 the CA step has just written the volume into
// the 50 MB L2, so a time there can fall under that bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_mip.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    coarse_occupancy_kernel(const uint4* __restrict__ vol, int n,
                            uint32_t* __restrict__ out) {
  const int yc = n >> 3;
  const int xg = ((n >> 5) + 7) >> 3;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // The thread count is a multiple of 32 (n and so yc are multiples of 4),
  // so a warp is wholly in or out and the shuffles below see all 32 lanes.
  if (i >= n * xg * yc) return;
  const int word = i >> 3;  // the output word: (zc * xg + g) * yc + yb
  const int yb = word % yc;
  const int g = (word / yc) % xg;
  const int z = (word / (yc * xg)) * 8 + (i & 7);
  uint32_t bits = ca3d::block_row_word(vol, n, z, g, yb);
  // OR over the block's 8 planes: lanes 8k .. 8k + 7.
  bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
  bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 2);
  bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 4);
  if ((i & 7) == 0) out[word] = bits;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], 16-byte aligned, n a multiple of 32 up to 1024;
// out: uint32[n/8, XG*n/8] (ops/occupancy.py coarse_occupancy).  Returns
// the launch's cudaError_t.
int ca3d_coarse_occupancy(int device, const void* vol, int n, void* out,
                          void* stream) {
  if (n < 32 || n > 1024 || n % 32 != 0 ||
      (reinterpret_cast<uintptr_t>(vol) & 15u) != 0u) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int total = n * (((n >> 5) + 7) >> 3) * (n >> 3);
  coarse_occupancy_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(vol), n, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
