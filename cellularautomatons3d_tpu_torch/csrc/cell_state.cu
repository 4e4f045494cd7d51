// K3: per-pixel cell-state lookups for a batch of target coordinates, one
// thread per (query, pixel).
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
// Operands: coords i32 [nq, 3, H, W], active u8 [nq, H, W] -> i32
// [nq, H, W].
//
// Bound on the H100: one scattered 4-byte load per lookup beside 17 bytes
// of coalesced operand traffic, so it is bound by device-memory bandwidth
// on the operands.  The volume is L2-resident up to 512^3 (16 MiB); at
// 1024^3 (128 MiB) a lookup may go to HBM, one 32-byte sector each
// (neighbouring pixels look up neighbouring cells, which may share one).
// The TPU kernel's z-group bitmask gate and finer strips
// exist to avoid its plane sweep; a gather needs neither.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
    cell_state_kernel(const uint32_t* __restrict__ vol, int n, size_t npix,
                      size_t total, const int* __restrict__ coords,
                      const uint8_t* __restrict__ active,
                      int* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t q = i / npix;
  const size_t pix = i - q * npix;
  int state = 0;
  if (active[i]) {
    const size_t i3 = 3 * q * npix + pix;  // [nq, 3, H, W], component 0
    const int x = max(coords[i3], 0) % n;
    const int y = max(coords[i3 + npix], 0) % n;
    const int z = max(coords[i3 + 2 * npix], 0) % n;
    const uint32_t word =
        __ldg(vol + ((size_t)(x >> 5) * n + z) * (size_t)n + y);
    state = (int)((word >> (x & 31)) & 1u);
  }
  out[i] = state;
}

}  // namespace

extern "C" {

// vol: uint32[n/32, n, n], n <= 1024; coords: i32 [nq, 3, H, W]; active: u8
// [nq, H, W]; out: i32 [nq, H, W] (0/1).  Returns the launch's
// cudaError_t.
int ca3d_cell_state(int device, const void* vol, int n, int width, int height,
                    int nq, const void* coords, const void* active, void* out,
                    void* stream) {
  if (n < 32 || n > 1024 || n % 32 != 0 || width < 1 || height < 1 ||
      nq < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t npix = (size_t)width * height;
  const size_t total = npix * (size_t)nq;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cell_state_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(vol), n, npix, total,
      static_cast<const int*>(coords), static_cast<const uint8_t*>(active),
      static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
