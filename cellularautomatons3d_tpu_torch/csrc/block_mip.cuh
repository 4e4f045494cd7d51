// The block row of a packed volume's mips: a plane-mip word, which
// coarse_occupancy.cu's mapping above 256^3 computes a thread and ORs 8 of
// along z into an 8^3-mip word.
//
// The volume is uint32[n/32, n, n] (x-word, z, y), 16-byte aligned, n a
// multiple of 32 up to 1024.  A word of x-group g (XG = ceil(n/256) groups)
// holds, at bit 4*wi + b, whether byte b of x-word 8g + wi is non-zero in any
// of the block row's 8 y-words: x-block 4*(8g + wi) + b.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ca3d {

__device__ __forceinline__ uint32_t byte_bits(uint32_t v) {
  return (uint32_t)((v & 0xFFu) != 0u) | ((uint32_t)((v & 0xFF00u) != 0u) << 1) |
         ((uint32_t)((v & 0xFF0000u) != 0u) << 2) |
         ((uint32_t)((v & 0xFF000000u) != 0u) << 3);
}

// The word of plane z, x-group g, y-block yb: the 8 y-words of the block row
// in each of the group's (up to 8) x-words, two 16-byte loads each, all 16
// issued before any is used; an x-word past the volume (a partial last
// group, n = 288-480) reads as empty.
__device__ __forceinline__ uint32_t block_row_word(const uint4* __restrict__ vol, int n, int z,
                                                   int g, int yb) {
  const int words = n >> 5;
  uint4 v[16];
#pragma unroll
  for (int wi = 0; wi < 8; ++wi) {
    const int w = g * 8 + wi;
    const size_t at = (((size_t)w * n + z) * n + (size_t)yb * 8) >> 2;
    v[2 * wi] = w < words ? __ldg(vol + at) : make_uint4(0u, 0u, 0u, 0u);
    v[2 * wi + 1] = w < words ? __ldg(vol + at + 1) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int wi = 0; wi < 8; ++wi) {
    const uint4 a = v[2 * wi], b = v[2 * wi + 1];
    bits |= byte_bits(a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w) << (4 * wi);
  }
  return bits;
}

}  // namespace ca3d
