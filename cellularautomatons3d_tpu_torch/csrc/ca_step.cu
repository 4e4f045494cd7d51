// One generation of a totalistic 3D CA on the bit-packed state: binary
// rules, and multi-state (Generations) rules on age bit-planes.
//
// Replaces: cellularautomatons3d_tpu/ops/ca_step.py, fires_plane (with
// shift_packed, _x_shift_plane, _axis_shift_plane) over
// ops/bitplane.py popcount_planes / rule_hit, and for multi-state rules
// step_packed_multistate with decay_update (the same body in ops/loop.py
// and renderer_fast.py one_step / visibility) -- XLA programs in the JAX
// package, which eager torch would run as ~100 (binary) to ~150
// (multi-state) launches per step.
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
// neighbour words are loaded once, and fusing the coarse occupancy rebuild
// into the step.
//
// Multi-state: the state is B = 2..4 age planes uint32[B, W, Z, Y] (ages
// 0 = dead, 1 = alive, 2..S-1 dying; bit b of a cell's age in plane b).
// Only age-1 cells count as neighbours, so a neighbour's bit needs all B of
// its planes (p0 & ~p1 & ...).  The step is two launches: age_masks_kernel,
// elementwise, writes the alive plane once (B words read, 1 written per
// word), then the neighbour loop reads that plane exactly as the binary
// step reads its state, and a decay epilogue turns the fires word and the
// thread's own B age words (kept in registers) into the next B words.  A
// grid-wide dependency (every neighbour's alive bit before any cell's
// update) forbids fusing the two into one ordinary launch; recomputing the
// alive word from the B planes at every neighbour load instead was tried
// and multiplies the loop's loads by B (PERF.md has both designs' times).
// age_masks_kernel also writes the visibility plane (age >= 1: p0 | p1 |
// ...), which every frame's renderer takes.  The decay epilogue is
// ops/ca_step.py decay_update bit for bit, invalid encodings (ages >= S)
// included.  Bound: B + 1 planes read, B written per step plus the masks
// pass (B read, 1 written).  On an NVIDIA H100 80GB HBM3 (700 W), B = 4,
// Moore rule, the two launches take 0.071 / 0.399 / 3.05 ms at 256^3 /
// 512^3 / 1024^3 (chip_smoke.py phase (d)).

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

// B == 0: the binary step, a = state, out = next state.  B = 2..4: the
// multi-state step on B age planes (planes, out: uint32[B, W, Z, Y]); a is
// their alive plane (age_masks_kernel).
template <int B>
__global__ void __launch_bounds__(256)
    ca_step_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ planes,
                   uint32_t* __restrict__ out, int n, int W, int total_states,
                   CaRule rule) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)n * n;
  const size_t words = (size_t)W * stride;
  if (idx >= words) return;
  const int y = (int)(idx % n);
  const int z = (int)((idx / n) % n);
  const int w = (int)(idx / stride);
  uint32_t p[B > 0 ? B : 1];
  uint32_t self;
  if constexpr (B == 0) {
    self = __ldg(a + idx);
  } else {
    // The cell's own age words; alive = (age == 1).
#pragma unroll
    for (int b = 0; b < B; ++b) p[b] = __ldg(planes + (size_t)b * words + idx);
    self = p[0];
#pragma unroll
    for (int b = 1; b < B; ++b) self &= ~p[b];
  }

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
  if constexpr (B == 0) {
    out[idx] = fires;
  } else {
    // decay_update (ops/ca_step.py), bit-sliced: dead -> 1 if fires else 0;
    // alive -> 1 if fires else 2; dying -> age + 1 (ripple carry), and
    // age S - 1 -> 0.  select(m, x, y) = (m & x) | (~m & y) throughout.
    uint32_t dead = ~p[0], is_last = 0xFFFFFFFFu;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (b > 0) dead &= ~p[b];
      is_last &= (((total_states - 1) >> b) & 1) ? p[b] : ~p[b];
    }
    uint32_t carry = 0xFFFFFFFFu;  // +1 == carry-in of 1
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const uint32_t aged = ~is_last & (p[b] ^ carry);
      carry = p[b] & carry;
      const uint32_t from_alive = b == 0 ? fires : (b == 1 ? ~fires : 0u);
      const uint32_t from_dead = b == 0 ? fires : 0u;
      out[(size_t)b * words + idx] =
          (dead & from_dead) |
          (~dead & ((self & from_alive) | (~self & aged)));
    }
  }
}

// The membership planes of a multi-state state, one thread per word: alive
// (age == 1: p0 & ~p1 & ...) for the step's neighbour loop and vis (age >=
// 1: p0 | p1 | ...) for the renderer; either may be null.
__global__ void __launch_bounds__(256)
    age_masks_kernel(const uint32_t* __restrict__ planes, int age_bits,
                     size_t words, uint32_t* __restrict__ alive,
                     uint32_t* __restrict__ vis) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= words) return;
  const uint32_t p0 = __ldg(planes + idx);
  uint32_t a = p0, v = p0;
  for (int b = 1; b < age_bits; ++b) {
    const uint32_t pb = __ldg(planes + (size_t)b * words + idx);
    a &= ~pb;
    v |= pb;
  }
  if (alive != nullptr) alive[idx] = a;
  if (vis != nullptr) vis[idx] = v;
}

// Fill rule from the host arrays of the C entry points; false = invalid.
bool make_rule(CaRule& rule, int n, int boundary, int n_groups,
               const int* group_len, const int* offsets, const unsigned* born,
               const unsigned* survive) {
  if (n < 32 || n % 32 != 0 || n_groups < 0 || n_groups > kMaxGroups ||
      boundary < kClampRef || boundary > kClamp) {
    return false;
  }
  rule = {};
  rule.n_groups = n_groups;
  rule.boundary = boundary;
  int total = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (group_len[g] < 0 || total + group_len[g] > kMaxOffsets) return false;
    rule.group_len[g] = group_len[g];
    rule.born[g] = born[g];
    rule.survive[g] = survive[g];
    for (int j = 0; j < group_len[g]; ++j, ++total) {
      for (int a = 0; a < 3; ++a) {
        const int v = offsets[3 * total + a];
        if (v < -31 || v > 31) return false;  // n >= 32, so |v| < n on every axis
        rule.off[total][a] = static_cast<signed char>(v);
      }
    }
  }
  return true;
}

constexpr int kThreads = 256;

unsigned blocks_for(size_t words) {
  return (unsigned)((words + kThreads - 1) / kThreads);
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
  CaRule rule;
  if (!make_rule(rule, n, boundary, n_groups, group_len, offsets, born,
                 survive)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int W = n / 32;
  ca_step_kernel<0>
      <<<blocks_for((size_t)W * n * n), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(in), nullptr,
          static_cast<uint32_t*>(out), n, W, 2, rule);
  return cudaGetLastError();
}

// planes: uint32[age_bits, words]; alive, vis: uint32[words] or null.
int ca3d_age_masks(int device, const void* planes, int age_bits, int words,
                   void* alive, void* vis, void* stream) {
  if (age_bits < 1 || age_bits > 4 || words < 1 ||
      (alive == nullptr && vis == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  age_masks_kernel<<<blocks_for((size_t)words), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), age_bits, (size_t)words,
      static_cast<uint32_t*>(alive), static_cast<uint32_t*>(vis));
  return cudaGetLastError();
}

// One multi-state generation: planes, out: uint32[age_bits, n/32, n, n] with
// age_bits = bit_length(total_states - 1) in 2..4; alive: the alive plane of
// planes (ca3d_age_masks).  The rule arguments are ca3d_ca_step's.
int ca3d_ca_step_multistate(int device, const void* planes, const void* alive,
                            void* out, int n, int age_bits, int total_states,
                            int boundary, int n_groups, const int* group_len,
                            const int* offsets, const unsigned* born,
                            const unsigned* survive, void* stream) {
  CaRule rule;
  if (!make_rule(rule, n, boundary, n_groups, group_len, offsets, born,
                 survive) ||
      alive == nullptr || age_bits < 2 || age_bits > 4 || total_states < 3 ||
      ((total_states - 1) >> age_bits) != 0 ||
      ((total_states - 1) >> (age_bits - 1)) == 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int W = n / 32;
  void (*kernel)(const uint32_t*, const uint32_t*, uint32_t*, int, int, int,
                 CaRule) = age_bits == 2   ? ca_step_kernel<2>
                           : age_bits == 3 ? ca_step_kernel<3>
                                           : ca_step_kernel<4>;
  kernel<<<blocks_for((size_t)W * n * n), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(alive),
      static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out), n, W,
      total_states, rule);
  return cudaGetLastError();
}

}  // extern "C"
