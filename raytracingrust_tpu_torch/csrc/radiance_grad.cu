// Radiance gradient kernel for sphere scenes, written for Hopper (sm_90a):
// the backward of the forward megakernel.
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_grad_kernel
// (reached through run_grad in _radiance_cvjp), which replays the forward
// and takes jax.vjp of _radiance_math against per-ray radiance cotangents.
// Here: one thread per ray (grid-stride over the rays) reads the ray's
// cotangent (3 floats), replays the ray with a recording trace and runs the
// hand-derived adjoint of radiance.cuh; the result is
// dfparams = sum over rays of cts[ray] . d radiance[ray] / d fparams,
// (20 + 12 N,) float32.  Rays whose cotangent is zero are skipped (their
// term is exactly 0).  Depth is capped at kMaxTape = 12, the tape's size.
//
// The sum over rays: each thread keeps the 20 head entries (camera,
// background, pixel scale) in registers for all its rays; the winners'
// sphere entries go to the block's shared sums with shared-memory atomics.
// At the end each block writes its sums as one row of `partials`, and a
// second kernel adds the rows in a fixed order.  Shared atomics add in no
// fixed order, so the result varies in its last bits between runs.
//
// What bounds it on this card: the per-ray FP32 work of two passes over the
// chain (the recording forward and the reverse sweep, which recomputes each
// bounce against its winner only) and the tape's local-memory traffic (40
// bytes a bounce, written once and read once, mostly from L1).  Device
// memory traffic is 12 bytes of cotangent per ray.

#include <cuda_runtime.h>

#include "radiance.cuh"

namespace {

using namespace rtrt;

__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ fparams, const int* __restrict__ kinds,
            int n_spheres, uint32_t k0, uint32_t k1, int n_rays, int spp,
            int width, int max_depth, int bg_kind, int clay,
            const float* __restrict__ cts, float* __restrict__ partials) {
  __shared__ GradShared sh;
  load_scene(sh, fparams, kinds, n_spheres);
  float head[kHead];
#pragma unroll
  for (int k = 0; k < kHead; ++k) head[k] = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       ray < n_rays; ray += stride) {
    const float gr = cts[3 * ray], gg = cts[3 * ray + 1],
                gb = cts[3 * ray + 2];
    if (gr == 0.0f && gg == 0.0f && gb == 0.0f) continue;
    const int pixel = (int)ray / spp;
    const float px = (float)(pixel % width), py = (float)(pixel / width);
    Tape tape;
    float r, g, b;
    trace<true>(sh.f, sh.kind_of, n_spheres, k0, k1, (uint32_t)ray, px, py,
                max_depth, bg_kind, clay, r, g, b, &tape);
    adjoint(sh.f, sh.kind_of, k0, k1, (uint32_t)ray, px, py, bg_kind, clay,
            tape, gr, gg, gb, head, sh.gs);
  }
  write_partials(sh, head, 0.0f, n_spheres, kSpheres + n_spheres * kStride,
                 partials);
}

}  // namespace

// Plain C entry, bound with ctypes (ops/radiance_grad.py).  Launches the
// gradient kernel on at most `max_blocks` blocks, then the row sum into
// `out` (20 + 12 N floats), on `stream`; `partials` holds max_blocks rows of
// 20 + 12 N floats.  Returns cudaGetLastError() of the launches.
extern "C" int rtrt_radiance_grad(const float* fparams, const int* kinds,
                                  int n_spheres, uint32_t k0, uint32_t k1,
                                  int n_rays, int spp, int width,
                                  int max_depth, int bg_kind, int clay,
                                  const float* cts, float* partials,
                                  int max_blocks, float* out, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_rays < 1 || spp < 1 ||
      width < 1 || max_depth < 0 || max_depth > kMaxTape || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int n_out = kSpheres + n_spheres * kStride;
  const int blocks = blocks_for(n_rays) < max_blocks ? blocks_for(n_rays)
                                                     : max_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  grad_kernel<<<blocks, kThreads, 0, s>>>(fparams, kinds, n_spheres, k0, k1,
                                          n_rays, spp, width, max_depth,
                                          bg_kind, clay, cts, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      partials, blocks, n_out, 0.0f, out);
  return (int)cudaGetLastError();
}
