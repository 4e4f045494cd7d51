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
// 32 cells: for every neighbour offset it takes the funnel-shifted word
// under the boundary mode, adds it into a bit-sliced counter of P planes
// (P = 3 when every rule group has <= 7 offsets, else 5; a template
// parameter), and evaluates the born / survive masks as a mux tree over
// the P count planes, ORing the rule groups together.  Offsets, masks and
// the group count are runtime arguments, so a rule change needs no rebuild.
//
// Tiling: a block owns a (z, y) tile of 8 x 32 words and streams along w
// over a chunk of rows (ops/ca_step.py _step_plan: the whole of W at 512^3
// and above, 2-3 rows at 256^3 so that enough blocks run).  A ring of eight
// shared-memory row buffers holds rows w-1, w, w+1 of the tile with a halo
// of R words in z and y (R = the rule's largest |dy|, |dz|: 1 for all six
// neighbourhoods, up to 31), while the next kAhead rows arrive by cp.async;
// each word of the state is read from device memory about once (plus the
// halo) instead of once per neighbour.  The z / y boundary is applied once
// per block, in a table of each tile position's source word, and the x-wrap
// of rows -1 and W once per row, not once per offset; CLAMP_REF wraps the
// far edge only (compute_clustered.wgsl:104 quirk).  Indices are 32-bit
// (the 1024^3 state is 2^25 words), and the row loop has no division.  The
// rule masks are a mux tree unrolled at compile time (an array-indexed tree
// stayed in local memory at P = 5 and cost the Moore rule half its time).
//
// Bound on the H100: the state read once and the next state written once
// (268 MB at 1024^3: 0.080 ms at 3.35 TB/s) against ~10 integer operations
// per neighbour and ~2^P per rule mask per 32 cells.
//
// Multi-state: the state is B = 2..4 age planes uint32[B, W, Z, Y] (ages
// 0 = dead, 1 = alive, 2..S-1 dying; bit b of a cell's age in plane b).
// Only age-1 cells count as neighbours, so a neighbour's bit needs all B of
// its planes (p0 & ~p1 & ...).  The step is two launches: age_masks_kernel,
// elementwise, writes the alive plane once (B words read, 1 written per
// word), then the neighbour loop streams that plane exactly as the binary
// step streams its state, and a decay epilogue turns the fires word and the
// thread's own B age words (read once, kept in registers) into the next B
// words.  A grid-wide dependency (every neighbour's alive bit before any
// cell's update) forbids fusing the two into one ordinary launch.
// age_masks_kernel also writes the visibility plane (age >= 1: p0 | p1 |
// ...), which every frame's renderer takes.  The decay epilogue is
// ops/ca_step.py decay_update bit for bit, invalid encodings (ages >= S)
// included.  Bound: B + 1 planes read, B written per step plus the masks
// pass (B read, 1 written).
//
// Slab mode (ca3d_ca_step_slab): one shard of a z- or (z, y)-sharded state
// (parallel/sharded.py), uint32[W, Z, Y] with Z = n / mz and Y = n / my (Y =
// n on a 1-D mesh).  Replaces: cellularautomatons3d_tpu/parallel/sharded.py
// _local_step_binary / _local_step_multistate, fires_plane on the haloed
// slab followed by the interior slice (XLA inside shard_map).  The kernel
// reads the slab as the padded array that JAX concatenates, without building
// it: z rows -1 and Z come from two halo planes [W, 1, Y] and, on a 2-D
// mesh, y columns -1 and Y from two halo columns [W, Z + 2, 1] that carry the
// corner ribbons; the boundary mode applies at the padded array's edges, as
// fires_plane applies it there (the halo exchange has already applied the
// global one).  The source table holds, for each tile position, the source
// (slab or one of the four halos, CaSlab) in its top bits and the word
// within that source's row of w below them.  Tiles past Z or Y load but do
// not compute.  x keeps row_source.  Multi-state: a is the slab's alive plane
// and the halos are its neighbours' alive planes; only they cross the shard
// boundary, and the decay epilogue reads the slab's own age words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 3;
constexpr int kMaxOffsets = 26 + 12 + 8;  // main + edges + corners
constexpr int kMaxHalo = 31;              // |dy|, |dz| < n for every n >= 32

// Boundary modes, in the order of types.BoundaryMode.ALL.
constexpr int kClampRef = 0;
constexpr int kWrap = 1;
constexpr int kClamp = 2;

// The block's tile: threadIdx.x walks y, threadIdx.y walks z.
constexpr int kTileY = 32;
constexpr int kTileZ = 8;
// Row buffers: rows w-1, w, w+1 in use and kAhead more in flight.
constexpr int kRing = 8;
constexpr int kAhead = 4;
static_assert(kAhead + 3 <= kRing && (kRing & (kRing - 1)) == 0, "ring");

struct CaRule {
  int n_groups;
  int group_len[kMaxGroups];
  signed char dx[kMaxOffsets];
  int soff[kMaxOffsets];  // dz * pitch + dy: the offset's word in a row buffer
  // The born / survive masks as mux leaves: word v is all ones iff count v
  // is a member (only counts 0..group_len can occur).
  uint32_t born[kMaxGroups][32];
  uint32_t survive[kMaxGroups][32];
  int boundary;
  int halo;
};

// The slab mode's sources: the slab (or its alive plane) [W, Z, Y], then
// the z halos [W, 1, Y] low and high, then the y halos [W, Z + 2, 1] low and
// high (null without a y split), each with its words per row of w.
constexpr int kSources = 5;
constexpr int kSourceShift = 28;  // source-table entry: source << 28 | word
struct CaSlab {
  const uint32_t* src[kSources];
  int stride[kSources];
  int pad_y;  // 1: y columns -1 and Y come from the y halos
};

// Source index of coordinate s in [-31, n + 30] along z or y; -1 reads
// zero.  WRAP wraps both edges; CLAMP_REF only the far one.
__device__ __forceinline__ int axis_source(int s, int n, int boundary) {
  if (s >= n) return boundary == kClamp ? -1 : s - n;
  if (s < 0) return boundary == kWrap ? s + n : -1;
  return s;
}

// Source index of coordinate v of the padded slab (extent nv), as
// fires_plane's shifts resolve it on the concatenated array for offsets
// shorter than nv; -1 reads zero (and marks tile positions no offset reaches).
__device__ __forceinline__ int padded_source(int v, int nv, int boundary) {
  if (v >= nv) return boundary == kClamp || v >= 2 * nv ? -1 : v - nv;
  if (v < 0) return boundary != kWrap || v < -nv ? -1 : v + nv;
  return v;
}

// The source-table entry of slab coordinates (zs, ys), each from -1 (the
// low halo) to Z or Y (the high one) and beyond: the source's index in the
// top bits, the word within its row of w below, -1 for a zero.
__device__ __forceinline__ int slab_source(int zs, int ys, int Z, int Y,
                                           int pad_y, int boundary) {
  const int zv = padded_source(zs + 1, Z + 2, boundary);
  const int yv = padded_source(ys + pad_y, Y + 2 * pad_y, boundary);
  if (zv < 0 || yv < 0) return -1;
  if (pad_y && yv == 0) return (3 << kSourceShift) | zv;
  if (pad_y && yv == Y + 1) return (4 << kSourceShift) | zv;
  const int y = yv - pad_y;
  if (zv == 0) return (1 << kSourceShift) | y;
  if (zv == Z + 1) return (2 << kSourceShift) | y;
  return (zv - 1) * Y + y;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The word of cells x + dx of row buffer position s: the funnel shift of
// the word with its neighbour in the previous or next row of w.
__device__ __forceinline__ uint32_t neighbour(const uint32_t* prev,
                                              const uint32_t* cur,
                                              const uint32_t* next, int s,
                                              int dx) {
  uint32_t v = cur[s];
  if (dx > 0) {
    v = __funnelshift_r(v, next[s], dx);
  } else if (dx < 0) {
    v = __funnelshift_l(prev[s], v, -dx);
  }
  return v;
}

// Lanes whose count (planes c[0..I], c[0] = LSB) is a member of a mask
// given as mux leaves (CaRule::born / survive, read from the kernel's
// parameters): plane I picks the upper or lower half of leaf[0 ..
// 2^(I+1)), recursively; 2^(I+1) - 1 three-input logic operations.
template <int I>
__device__ __forceinline__ uint32_t mux(const uint32_t* c, const uint32_t* leaf) {
  if constexpr (I < 0) {
    return leaf[0];
  } else {
    const uint32_t lo = mux<I - 1>(c, leaf);
    const uint32_t hi = mux<I - 1>(c, leaf + (1 << I));
    return (c[I] & hi) | (~c[I] & lo);
  }
}

// The x-wrap of row r (-1..W): the row of w it reads, or -1 for zeros.
__device__ __forceinline__ int row_source(int r, int W, int boundary) {
  if (r < 0) return boundary == kWrap ? W - 1 : -1;
  if (r >= W) return boundary == kClamp ? -1 : 0;
  return r;
}

// Fill row buffer dst with row r (-1..W) of the tile and its halo, from
// the block's source table src: the word z * Y + y of every position of
// the halo'd tile under the z / y boundary (in slab mode, the source and the
// word, slab_source), -1 for a zero; the x-wrap of rows -1 and W by
// row_source.  In-range words by cp.async (the caller commits), the others
// as zeros.
template <bool kSlab>
__device__ __forceinline__ void load_row(uint32_t* dst,
                                         const uint32_t* __restrict__ a,
                                         const int* src, int r, int W,
                                         int plane, int buf, int boundary,
                                         const CaSlab& slab) {
  const int ws = row_source(r, W, boundary);
  const int tid = threadIdx.y * kTileY + threadIdx.x;
  const uint32_t* row = a + ws * plane;
  for (int i = tid; i < buf; i += kTileY * kTileZ) {
    const int s = src[i];
    if (ws < 0 || s < 0) {
      dst[i] = 0u;
    } else if constexpr (kSlab) {
      const int k = s >> kSourceShift;
      cp_async4(dst + i, slab.src[k] + ws * slab.stride[k] +
                             (s & ((1 << kSourceShift) - 1)));
    } else {
      cp_async4(dst + i, row + s);
    }
  }
}

// B == 0: the binary step, a = state, out = next state.  B = 2..4: the
// multi-state step on B age planes (planes, out: uint32[B, W, Z, Y]); a is
// their alive plane (age_masks_kernel).  kSlab: a is the slab (or its alive
// plane) and its halos come from slab (the cube: Z = Y = n, slab unused).
// Block (32, 8), grid (ceil(Y/32), ceil(Z/8), chunks); dynamic shared
// memory: kRing row buffers of (8 + 2 halo) x (32 + 2 halo) words and the
// source table of as many ints.
template <int B, int P, bool kSlab>
__global__ void __launch_bounds__(kTileY * kTileZ)
    ca_step_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ planes,
                   uint32_t* __restrict__ out, int Z, int Y, int W, int chunk,
                   int total_states, const __grid_constant__ CaRule rule,
                   const __grid_constant__ CaSlab slab) {
  extern __shared__ uint32_t ring[];
  const int halo = rule.halo;
  const int pitch = kTileY + 2 * halo;
  const int rows = kTileZ + 2 * halo;
  const int buf = rows * pitch;
  const int y0 = blockIdx.x * kTileY;
  const int z0 = blockIdx.y * kTileZ;
  const int w0 = blockIdx.z * chunk;
  const int w1 = min(w0 + chunk, W);
  const int plane = Z * Y;
  const int words = W * plane;
  const int own = (z0 + threadIdx.y) * Y + y0 + threadIdx.x;
  // A tile past the slab's last plane or column loads but does not compute.
  const bool active = !kSlab || (z0 + (int)threadIdx.y < Z && y0 + (int)threadIdx.x < Y);
  const int centre = (threadIdx.y + halo) * pitch + threadIdx.x + halo;
  // The source table, after the ring: computed once, read at every row.
  int* src = reinterpret_cast<int*>(ring + kRing * buf);
  for (int i = threadIdx.y * kTileY + threadIdx.x; i < buf;
       i += kTileY * kTileZ) {
    const int row = i / pitch, col = i - row * pitch;
    if constexpr (kSlab) {
      src[i] = slab_source(z0 - halo + row, y0 - halo + col, Z, Y, slab.pad_y,
                           rule.boundary);
    } else {
      const int zs = axis_source(z0 - halo + row, Z, rule.boundary);
      const int ys = axis_source(y0 - halo + col, Y, rule.boundary);
      src[i] = zs < 0 || ys < 0 ? -1 : zs * Y + ys;
    }
  }
  __syncthreads();
  auto load = [&](int r) {
    load_row<kSlab>(ring + ((r + 1) & (kRing - 1)) * buf, a, src, r, W, plane,
                    buf, rule.boundary, slab);
  };
  // Row r lives in ring buffer (r + 1) % kRing; one cp.async group per row
  // (rows w0 - 1..w0 + 1 share one), empty past the chunk's last row w1,
  // so that at row w the kAhead - 1 most recent groups are rows w + 2 on.
  auto fetch = [&](int r) {
    if (r <= w1) load(r);
    cp_async_commit();
  };
  load(w0 - 1);
  load(w0);
  fetch(w0 + 1);
  for (int r = w0 + 2; r <= w0 + kAhead; ++r) fetch(r);
  for (int w = w0; w < w1; ++w) {
    cp_async_wait_group<kAhead - 1>();  // row w + 1 has landed
    __syncthreads();  // ... for every thread, and row w - 2 is free
    fetch(w + kAhead + 1);
    if (!active) continue;
    const uint32_t* prev = ring + (w & (kRing - 1)) * buf + centre;
    const uint32_t* cur = ring + ((w + 1) & (kRing - 1)) * buf + centre;
    const uint32_t* next = ring + ((w + 2) & (kRing - 1)) * buf + centre;
    const int idx = w * plane + own;
    uint32_t p[B > 0 ? B : 1];
    uint32_t self;
    if constexpr (B == 0) {
      self = cur[0];
    } else {
      // The cell's own age words; alive = (age == 1).
#pragma unroll
      for (int b = 0; b < B; ++b) p[b] = __ldg(planes + b * words + idx);
      self = p[0];
#pragma unroll
      for (int b = 1; b < B; ++b) self &= ~p[b];
    }

    uint32_t fires = 0u;
    int o = 0;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= rule.n_groups) break;
      uint32_t c[P];
#pragma unroll
      for (int i = 0; i < P; ++i) c[i] = 0u;
      const int end = o + rule.group_len[g];
      for (; o < end; ++o) {
        uint32_t carry = neighbour(prev, cur, next, rule.soff[o], rule.dx[o]);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const uint32_t t = c[i] & carry;
          c[i] ^= carry;
          carry = t;
        }
      }
      fires |= (self & mux<P - 1>(c, rule.survive[g])) |
               (~self & mux<P - 1>(c, rule.born[g]));
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
        out[b * words + idx] =
            (dead & from_dead) |
            (~dead & ((self & from_alive) | (~self & aged)));
      }
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

// Fill rule from the host arrays of the C entry points; false = invalid:
// more than 46 offsets or 3 groups, |dx| > 31, or |dy|, |dz| > halo.
bool make_rule(CaRule& rule, int n, int boundary, int n_groups,
               const int* group_len, const int* offsets, const unsigned* born,
               const unsigned* survive, int halo) {
  if (n < 32 || n % 32 != 0 || n_groups < 0 || n_groups > kMaxGroups ||
      boundary < kClampRef || boundary > kClamp || halo < 0 ||
      halo > kMaxHalo) {
    return false;
  }
  rule = {};
  rule.n_groups = n_groups;
  rule.boundary = boundary;
  rule.halo = halo;
  const int pitch = kTileY + 2 * halo;
  int total = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (group_len[g] < 0 || group_len[g] > 31 ||
        total + group_len[g] > kMaxOffsets) {
      return false;  // a 5-plane count holds 0..31
    }
    rule.group_len[g] = group_len[g];
    // Only counts 0..group_len are reachable (AutomatonSpec.groups).
    for (int v = 0; v < 32; ++v) {
      const bool reach = v <= group_len[g];
      rule.born[g][v] = reach && ((born[g] >> v) & 1u) ? 0xFFFFFFFFu : 0u;
      rule.survive[g][v] = reach && ((survive[g] >> v) & 1u) ? 0xFFFFFFFFu : 0u;
    }
    for (int j = 0; j < group_len[g]; ++j, ++total) {
      const int dx = offsets[3 * total];
      const int dy = offsets[3 * total + 1];
      const int dz = offsets[3 * total + 2];
      if (dx < -31 || dx > 31 || dy < -halo || dy > halo || dz < -halo ||
          dz > halo) {
        return false;
      }
      rule.dx[total] = static_cast<signed char>(dx);
      rule.soff[total] = dz * pitch + dy;
    }
  }
  return true;
}

using StepKernel = decltype(&ca_step_kernel<0, 3, false>);

template <int P, bool kSlab>
StepKernel step_kernel(int age_bits) {
  switch (age_bits) {
    case 2: return ca_step_kernel<2, P, kSlab>;
    case 3: return ca_step_kernel<3, P, kSlab>;
    case 4: return ca_step_kernel<4, P, kSlab>;
    default: return ca_step_kernel<0, P, kSlab>;
  }
}

// One launch of the step kernel: age_bits 0 (binary) or 2..4, chunk rows of
// w per block (1 <= chunk <= W), on the cube (slab null: Z = Y = 32 W) or on
// a slab of Z x Y.
cudaError_t launch_step(int age_bits, const uint32_t* a, const uint32_t* planes,
                        uint32_t* out, int W, int Z, int Y, int chunk,
                        int total_states, const CaRule& rule,
                        const CaSlab* slab, cudaStream_t stream) {
  if (chunk < 1 || chunk > W) return cudaErrorInvalidValue;
  bool wide = false;  // a group with more than 7 offsets needs 5 count planes
  for (int g = 0; g < rule.n_groups; ++g) wide = wide || rule.group_len[g] > 7;
  const StepKernel kernel =
      slab != nullptr
          ? (wide ? step_kernel<5, true>(age_bits) : step_kernel<3, true>(age_bits))
          : (wide ? step_kernel<5, false>(age_bits) : step_kernel<3, false>(age_bits));
  const size_t smem = sizeof(uint32_t) * (kRing + 1) *
                      (kTileZ + 2 * rule.halo) * (kTileY + 2 * rule.halo);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Y + kTileY - 1) / kTileY, (Z + kTileZ - 1) / kTileZ,
                  (W + chunk - 1) / chunk);
  kernel<<<grid, dim3(kTileY, kTileZ), smem, stream>>>(
      a, planes, out, Z, Y, W, chunk, total_states, rule,
      slab != nullptr ? *slab : CaSlab{});
  return cudaGetLastError();
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
// (dx, dy, dz) triples, born[n_groups], survive[n_groups].  halo: the
// largest |dy|, |dz| of the offsets (at most 31); chunk: rows of w each
// block streams (ops/ca_step.py _step_plan).  Returns the cudaError_t of
// the launch (0 = launched).
int ca3d_ca_step(int device, const void* in, void* out, int n, int boundary,
                 int n_groups, const int* group_len, const int* offsets,
                 const unsigned* born, const unsigned* survive, int halo,
                 int chunk, void* stream) {
  CaRule rule;
  if (!make_rule(rule, n, boundary, n_groups, group_len, offsets, born,
                 survive, halo)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_step(0, static_cast<const uint32_t*>(in), nullptr,
                     static_cast<uint32_t*>(out), n / 32, n, n, chunk, 2, rule,
                     nullptr, static_cast<cudaStream_t>(stream));
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
// planes (ca3d_age_masks).  The rule, halo and chunk arguments are
// ca3d_ca_step's.
int ca3d_ca_step_multistate(int device, const void* planes, const void* alive,
                            void* out, int n, int age_bits, int total_states,
                            int boundary, int n_groups, const int* group_len,
                            const int* offsets, const unsigned* born,
                            const unsigned* survive, int halo, int chunk,
                            void* stream) {
  CaRule rule;
  if (!make_rule(rule, n, boundary, n_groups, group_len, offsets, born,
                 survive, halo) ||
      alive == nullptr || age_bits < 2 || age_bits > 4 || total_states < 3 ||
      ((total_states - 1) >> age_bits) != 0 ||
      ((total_states - 1) >> (age_bits - 1)) == 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_step(age_bits, static_cast<const uint32_t*>(alive),
                     static_cast<const uint32_t*>(planes),
                     static_cast<uint32_t*>(out), n / 32, n, n, chunk,
                     total_states, rule, nullptr,
                     static_cast<cudaStream_t>(stream));
}

// One generation of a shard (slab mode): alive, out: uint32[W, Z, Y] (for
// age_bits 2..4, alive is the alive plane of planes: uint32[age_bits, W, Z,
// Y], and out has planes' shape); z_lo, z_hi: the halo planes [W, 1, Y];
// y_lo, y_hi: the halo columns [W, Z + 2, 1], or both null on a 1-D mesh (y
// keeps the boundary mode).  Offsets need |dz| <= 1 and |dy| < Y + 2 (Y
// without y halos); the rule, halo and chunk arguments are ca3d_ca_step's.
int ca3d_ca_step_slab(int device, const void* alive, const void* z_lo,
                      const void* z_hi, const void* y_lo, const void* y_hi,
                      const void* planes, void* out, int W, int Z, int Y,
                      int age_bits, int total_states, int boundary,
                      int n_groups, const int* group_len, const int* offsets,
                      const unsigned* born, const unsigned* survive, int halo,
                      int chunk, void* stream) {
  CaRule rule;
  const int pad_y = y_lo != nullptr;
  if (W < 1 || Z < 1 || Y < 1 || alive == nullptr || z_lo == nullptr ||
      z_hi == nullptr || out == nullptr || (y_hi != nullptr) != pad_y ||
      !make_rule(rule, 32 * W, boundary, n_groups, group_len, offsets, born,
                 survive, halo)) {
    return cudaErrorInvalidValue;
  }
  if (age_bits != 0 &&
      (planes == nullptr || age_bits < 2 || age_bits > 4 || total_states < 3 ||
       ((total_states - 1) >> age_bits) != 0 ||
       ((total_states - 1) >> (age_bits - 1)) == 0)) {
    return cudaErrorInvalidValue;
  }
  int total = 0;
  for (int g = 0; g < n_groups; ++g) total += group_len[g];
  for (int j = 0; j < total; ++j) {
    const int dy = offsets[3 * j + 1], dz = offsets[3 * j + 2];
    if (dz < -1 || dz > 1 || dy <= -(Y + 2 * pad_y) || dy >= Y + 2 * pad_y) {
      return cudaErrorInvalidValue;
    }
  }
  CaSlab slab = {};
  const void* src[kSources] = {alive, z_lo, z_hi, y_lo, y_hi};
  const int stride[kSources] = {Z * Y, Y, Y, Z + 2, Z + 2};
  for (int k = 0; k < kSources; ++k) {
    slab.src[k] = static_cast<const uint32_t*>(src[k]);
    slab.stride[k] = stride[k];
  }
  slab.pad_y = pad_y;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_step(age_bits, static_cast<const uint32_t*>(alive),
                     static_cast<const uint32_t*>(planes),
                     static_cast<uint32_t*>(out), W, Z, Y, chunk,
                     age_bits ? total_states : 2, rule, &slab,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
