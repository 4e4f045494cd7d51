// One generation of a binary totalistic 3D CA on the bit-packed state.
//
// Replaces: cellularautomatons3d_tpu/ops/ca_step.py, fires_plane (with
// shift_packed, _x_shift_plane, _axis_shift_plane) over
// ops/bitplane.py popcount_planes / rule_hit -- an XLA program in the JAX
// package, which eager torch would run as ~100 launches per step.
//
// Layout: packed uint32[W, Z, Y] (W = N/32 words along x, y minor); bit b
// of word [w, z, y] is cell x = 32w + b.  One thread computes one word, i.e.
// 32 cells: for every neighbour offset it builds the funnel-shifted word
// under the boundary mode, adds it into a 5-plane bit-sliced counter (up to
// 26 neighbours), tests the count against the born/survive masks and ORs
// the rule groups together.  Offsets, masks and the group count are runtime
// arguments, so a rule change needs no rebuild.
//
// Bound on the H100: at 256^3 the state is 2 MiB, read about (1 + 2 per
// x-shifted offset) times per word through L1/L2 and written once, and the
// adder costs ~10 integer ops per neighbour per 32 cells.  Both are tiny
// next to the launch itself (524,288 threads), so the step is bound by
// launch latency and the L2 round trips of the neighbour loads.
// Left for later PRs: staging a (z, y) tile with halo in shared memory so
// neighbour words are loaded once, fusing the coarse occupancy rebuild into
// the step, and the multi-state (Generations) age planes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 3;
constexpr int kMaxOffsets = 26 + 12 + 8;  // main + edges + corners

// Boundary modes, in the order of types.BoundaryMode.ALL.
constexpr int kClampRef = 0;
constexpr int kWrap = 1;
constexpr int kClamp = 2;

struct CaRule {
  int n_groups;
  int group_len[kMaxGroups];
  signed char off[kMaxOffsets][3];  // (dx, dy, dz)
  uint32_t born[kMaxGroups];
  uint32_t survive[kMaxGroups];
  int boundary;
};

// Source index along z or y for out[c] = a[c + d]; -1 = reads zero.
// CLAMP_REF wraps the far edge only (compute_clustered.wgsl:104 quirk).
__device__ __forceinline__ int axis_source(int c, int d, int n, int boundary) {
  const int s = c + d;
  if (s >= 0 && s < n) return s;
  if (boundary == kWrap || (boundary == kClampRef && d > 0)) {
    return ((s % n) + n) % n;
  }
  return -1;
}

// Word of cells (x + dx) for the 32 cells of word w, at row (zs, ys).
__device__ __forceinline__ uint32_t x_shifted(const uint32_t* __restrict__ a,
                                              int w, int W, size_t stride,
                                              size_t base, int dx,
                                              int boundary) {
  const uint32_t cur = __ldg(a + (size_t)w * stride + base);
  if (dx == 0) return cur;
  if (dx > 0) {
    uint32_t nb;
    if (w + 1 < W) {
      nb = __ldg(a + (size_t)(w + 1) * stride + base);
    } else {
      // WRAP and CLAMP_REF: x = N reads x = 0.
      nb = (boundary == kClamp) ? 0u : __ldg(a + base);
    }
    return (cur >> dx) | (nb << (32 - dx));
  }
  const int ad = -dx;
  uint32_t nb;
  if (w >= 1) {
    nb = __ldg(a + (size_t)(w - 1) * stride + base);
  } else {
    nb = (boundary == kWrap) ? __ldg(a + (size_t)(W - 1) * stride + base) : 0u;
  }
  return (cur << ad) | (nb >> (32 - ad));
}

// Lanes whose 5-bit count (c[0] = LSB) is a member of mask.
__device__ __forceinline__ uint32_t rule_hit(const uint32_t c[5],
                                             uint32_t mask) {
  uint32_t acc = 0u;
  for (int v = 0; v <= 26; ++v) {
    if (!((mask >> v) & 1u)) continue;
    uint32_t e = 0xFFFFFFFFu;
#pragma unroll
    for (int i = 0; i < 5; ++i) e &= ((v >> i) & 1) ? c[i] : ~c[i];
    acc |= e;
  }
  return acc;
}

__global__ void __launch_bounds__(256)
    ca_step_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                   int n, int W, CaRule rule) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)n * n;
  if (idx >= (size_t)W * stride) return;
  const int y = (int)(idx % n);
  const int z = (int)((idx / n) % n);
  const int w = (int)(idx / stride);
  const uint32_t self = __ldg(a + idx);

  uint32_t fires = 0u;
  int o = 0;
  for (int g = 0; g < rule.n_groups; ++g) {
    uint32_t c[5] = {0u, 0u, 0u, 0u, 0u};
    for (int j = 0; j < rule.group_len[g]; ++j, ++o) {
      const int dx = rule.off[o][0], dy = rule.off[o][1], dz = rule.off[o][2];
      const int zs = axis_source(z, dz, n, rule.boundary);
      const int ys = axis_source(y, dy, n, rule.boundary);
      if (zs < 0 || ys < 0) continue;  // zero word: adds nothing
      uint32_t carry = x_shifted(a, w, W, stride, (size_t)zs * n + ys, dx,
                                 rule.boundary);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const uint32_t t = c[i] & carry;
        c[i] ^= carry;
        carry = t;
      }
    }
    const uint32_t born = rule_hit(c, rule.born[g]);
    const uint32_t survive = rule_hit(c, rule.survive[g]);
    fires |= (self & survive) | (~self & born);
  }
  out[idx] = fires;
}

}  // namespace

extern "C" {

const char* ca3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Host arrays: group_len[n_groups], offsets[3 * sum(group_len)] as
// (dx, dy, dz) triples, born[n_groups], survive[n_groups].  Returns the
// cudaError_t of the launch (0 = launched).
int ca3d_ca_step(int device, const void* in, void* out, int n, int boundary,
                 int n_groups, const int* group_len, const int* offsets,
                 const unsigned* born, const unsigned* survive,
                 void* stream) {
  if (n < 32 || n % 32 != 0 || n_groups < 0 || n_groups > kMaxGroups ||
      boundary < kClampRef || boundary > kClamp) {
    return cudaErrorInvalidValue;
  }
  CaRule rule = {};
  rule.n_groups = n_groups;
  rule.boundary = boundary;
  int total = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (group_len[g] < 0 || total + group_len[g] > kMaxOffsets) {
      return cudaErrorInvalidValue;
    }
    rule.group_len[g] = group_len[g];
    rule.born[g] = born[g];
    rule.survive[g] = survive[g];
    for (int j = 0; j < group_len[g]; ++j, ++total) {
      for (int a = 0; a < 3; ++a) {
        const int v = offsets[3 * total + a];
        if (v < -31 || v > 31) {  // n >= 32, so |v| < n on every axis
          return cudaErrorInvalidValue;
        }
        rule.off[total][a] = static_cast<signed char>(v);
      }
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int W = n / 32;
  const size_t words = (size_t)W * n * n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((words + threads - 1) / threads);
  ca_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n, W,
      rule);
  return cudaGetLastError();
}

}  // extern "C"
