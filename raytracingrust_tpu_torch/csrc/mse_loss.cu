// Fused render -> MSE -> gradient kernel for sphere scenes, written for
// Hopper (sm_90a): one launch gives the fit step's loss and its gradient.
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_mse_kernel
// (reached through run_fused in _mse_cvjp, mse_loss_pallas).  It computes
//   loss = mean over pixels and channels of (m - target)^2,
//   m    = mean over the pixel's spp samples of clip(radiance, 0, clamp),
// and d loss / d fparams, (20 + 12 N,) float32.  The TPU kernel's lane
// padding (spp_pad, the 256 x 256 averaging projector, the weight block) is
// a lane-machine device and is gone: one thread takes one pixel (grid-stride
// over the pixels) and loops over its samples twice.  The first loop traces
// each sample for the pixel mean m; the second replays each sample with a
// recording trace and runs radiance.cuh's adjoint with the cotangent
//   g = 2 (m - target) / (3 H W spp) * clip'(radiance),
// where clip' is 1 inside (0, clamp), 1/2 at a sample exactly on 0 or on
// clamp (jnp.clip's rule, and the plain version's torch.minimum/maximum),
// and 0 outside.  Any spp >= 1; depth at most kMaxTape = 12.
//
// Sums: as in radiance_grad.cu (head entries in registers and warp
// shuffles, sphere entries in shared atomics, one row of partials per
// block, a second kernel adding the rows in order), with the pixel's
// squared error as one more entry; that kernel divides it by 3 H W.
//
// What bounds it on this card: per-ray FP32 work, three passes over each
// sample's chain (forward, recording forward, reverse sweep); device memory
// traffic is 12 bytes of target per pixel.

#include <cuda_runtime.h>

#include "radiance.cuh"

namespace {

using namespace rtrt;

__device__ __forceinline__ float clip(float x, float hi) {
  return fminf(fmaxf(x, 0.0f), hi);
}

__device__ __forceinline__ float clip_slope(float x, float hi) {
  if (x > 0.0f && x < hi) return 1.0f;
  return (x == 0.0f || x == hi) ? 0.5f : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
mse_kernel(const float* __restrict__ fparams, const int* __restrict__ kinds,
           int n_spheres, uint32_t k0, uint32_t k1, int n_pixels, int spp,
           int width, int max_depth, int bg_kind, int clay, float clamp,
           const float* __restrict__ target, float* __restrict__ partials) {
  __shared__ GradShared sh;
  load_scene(sh, fparams, kinds, n_spheres);
  float head[kHead];
#pragma unroll
  for (int k = 0; k < kHead; ++k) head[k] = 0.0f;
  float sse = 0.0f;
  // d loss / d m = 2 (m - target) / (3 H W); the mean over samples adds 1/spp
  const float scale = 2.0f / (3.0f * (float)n_pixels) / (float)spp;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pixels; p += stride) {
    const int pixel = (int)p;
    const float px = (float)(pixel % width), py = (float)(pixel / width);
    float mr = 0.0f, mg = 0.0f, mb = 0.0f;
    for (int s = 0; s < spp; ++s) {
      float r, g, b;
      trace<false>(sh.f, sh.kind_of, n_spheres, k0, k1,
                   (uint32_t)(pixel * spp + s), px, py, max_depth, bg_kind,
                   clay, r, g, b, nullptr);
      mr += clip(r, clamp);
      mg += clip(g, clamp);
      mb += clip(b, clamp);
    }
    mr = mr / (float)spp;
    mg = mg / (float)spp;
    mb = mb / (float)spp;
    const float er = mr - target[3 * p], eg = mg - target[3 * p + 1],
                eb = mb - target[3 * p + 2];
    sse += er * er + eg * eg + eb * eb;
    const float cr = er * scale, cg = eg * scale, cb = eb * scale;
    for (int s = 0; s < spp; ++s) {
      const uint32_t rid = (uint32_t)(pixel * spp + s);
      Tape tape;
      float r, g, b;
      trace<true>(sh.f, sh.kind_of, n_spheres, k0, k1, rid, px, py,
                  max_depth, bg_kind, clay, r, g, b, &tape);
      const float gr = cr * clip_slope(r, clamp),
                  gg = cg * clip_slope(g, clamp),
                  gb = cb * clip_slope(b, clamp);
      if (gr == 0.0f && gg == 0.0f && gb == 0.0f) continue;
      adjoint(sh.f, sh.kind_of, k0, k1, rid, px, py, bg_kind, clay, tape, gr,
              gg, gb, head, sh.gs);
    }
  }
  write_partials(sh, head, sse, n_spheres,
                 kSpheres + n_spheres * kStride + 1, partials);
}

}  // namespace

// Plain C entry, bound with ctypes (ops/mse_loss.py).  Launches the fused
// kernel on at most `max_blocks` blocks, then the row sum, on `stream`.
// `target` is (n_pixels, 3); `out` gets 20 + 12 N gradient entries and then
// the loss; `partials` holds max_blocks rows of 21 + 12 N floats.  Returns
// cudaGetLastError() of the launches.
extern "C" int rtrt_mse_loss(const float* fparams, const int* kinds,
                             int n_spheres, uint32_t k0, uint32_t k1,
                             int n_pixels, int spp, int width, int max_depth,
                             int bg_kind, int clay, float clamp,
                             const float* target, float* partials,
                             int max_blocks, float* out, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_pixels < 1 || spp < 1 ||
      width < 1 || max_depth < 0 || max_depth > kMaxTape || max_blocks < 1 ||
      (long long)n_pixels * spp >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int n_out = kSpheres + n_spheres * kStride + 1;
  const int blocks = blocks_for(n_pixels) < max_blocks ? blocks_for(n_pixels)
                                                       : max_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  mse_kernel<<<blocks, kThreads, 0, s>>>(fparams, kinds, n_spheres, k0, k1,
                                         n_pixels, spp, width, max_depth,
                                         bg_kind, clay, clamp, target,
                                         partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      partials, blocks, n_out, 3.0f * (float)n_pixels, out);
  return (int)cudaGetLastError();
}
