// K6: the patch prepass on its own, one conservative column mask per 8x8
// pixel patch, a group of kLanes lanes per patch (prepass.cuh patch_mask:
// each lane walks 32 / kLanes of the 8-plane columns, a shuffle OR gathers
// the mask).
//
// Replaces: cellularautomatons3d_tpu/render/render_fast.py, _make_prepass
// (launched by _prepass_mask), whose masks gate K1's primary sweep under
// raytrace_tiles(use_prepass=True).  The frame path on the card does not
// launch this kernel: K1 computes its own masks with the same device
// function (render_fast.cu, the prologue of MASK == kMaskInline).  This
// form gives the masks as a tensor, for K1's external-mask gate and for
// holding the device function against the plain prepass.
//
// It reads the undilated mip and dilates on read (prepass.cuh
// dilated_bit), so no dilation pass runs before it.
//
// Bound on the H100: 32,400 patches at 1080p, a ray set-up each and 32
// columns x 3 probes of a 4 KiB mip that stays in L1; 130 KB written: well
// under a microsecond of arithmetic.  The first port gave each patch one
// thread walking its columns serially (too few warps to hide the walk's
// latency); a warp per patch issued the set-up once per patch, and was
// slower still; 4 lanes a patch took a third off the first port's device
// time (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

#include "prepass.cuh"

namespace {

using namespace ca3d;

constexpr int kLanes = 4;                  // lanes per patch
constexpr int kThreads = 128;
constexpr int kPatches = kThreads / kLanes;  // patches per block

__global__ void __launch_bounds__(kThreads)
    prepass_kernel(const uint32_t* __restrict__ coarse, int n, int pw,
                   int npatch, const __grid_constant__ Cam cam,
                   int* __restrict__ out) {
  const int p = blockIdx.x * kPatches + threadIdx.x / kLanes;
  if (p - threadIdx.x % 32 / kLanes >= npatch) return;  // the whole warp
  const int sub = threadIdx.x % kLanes;
  const int q = min(p, npatch - 1);  // a patch past the end computes the last
  const int mask = patch_mask<kLanes>(cam.p, n, coarse, q % pw, q / pw, sub,
                                      0, (n >> 3) - 1);
  if (sub == 0 && p < npatch) out[p] = mask;
}

}  // namespace

extern "C" {

// coarse: uint32[n/8, n/8], n <= 256 (the coarse mip, undilated); cam:
// host float[40] (render_fast.py pack_cam); out: i32 [ceil(H/8),
// ceil(W/8)].  Returns the launch's cudaError_t.
int ca3d_prepass(int device, const void* coarse, int n, int width, int height,
                 const float* cam, void* out, void* stream) {
  if (n < 32 || n > kMaxStagedGrid || n % 32 != 0 || width < 1 || height < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Cam c;
  for (int i = 0; i < P_LEN; ++i) c.p[i] = cam[i];
  const int pw = (width + kPatch - 1) / kPatch;
  const int ph = (height + kPatch - 1) / kPatch;
  const int npatch = pw * ph;
  prepass_kernel<<<(npatch + kPatches - 1) / kPatches, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(coarse), n, pw, npatch, c,
      static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
