// Radiance gradient kernel for scenes of spheres and triangles, written for
// Hopper (sm_90a): the backward of the forward megakernel.
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_grad_kernel
// (reached through run_grad in _radiance_cvjp), which replays the forward
// and takes jax.vjp of _radiance_math against per-ray radiance cotangents.
// Here: one thread per ray (grid-stride over the rays) reads the ray's
// cotangent (3 floats), replays the ray with a recording trace and runs the
// hand-derived adjoint of radiance.cuh; the result is
// dfparams = sum over rays of cts[ray] . d radiance[ray] / d fparams,
// (20 + stride N,) float32, and under a sky map the texels' gradient.  Rays
// whose cotangent is zero are skipped (their term is exactly 0).  Depth is
// capped at kMaxTape = 12, the tape's size.  The variants are the forward
// kernel's (kExt: mixes, volumes, the isotropic lobe; kSky: a sky map;
// kTri: triangles).  The TPU kernel returns the cotangents of its triangle
// operands (the per-triangle C, S and S2 columns); here a triangle's t
// passes its cotangent to the ray, and its material's go to the row of its
// material slot, a section of fparams after the spheres: the block's sums
// grow with the materials the triangles use (at most kMaxTriMats rows of
// 17 floats, 8.7 KB), not with the triangles.
//
// The texels' gradient: in the TPU package the sky's gather, and so its
// transpose, run outside the kernel (_env_finish); here the lookup is in
// the kernel, and each escaping ray adds g * thr to its texel's three
// floats with device-memory atomics into `gsky` (zeroed by the caller).  A
// ray escapes at most once, so the atomics are one per escaping ray; the
// alternative, writing each ray's texel index and g * thr for an
// index_add_ in PyTorch, would move 16 more bytes a ray and add a launch.
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

template <bool kExt, bool kSky, bool kTri>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ fparams, const int* __restrict__ kinds,
            Rows rows, uint32_t k0, uint32_t k1, int n_rays, int spp,
            int width, int max_depth, int bg_kind, int clay, Sky sky,
            float* __restrict__ gsky, const float* __restrict__ cts,
            float* __restrict__ partials) {
  __shared__ GradShared<kExt, kTri> sh;
  load_scene(sh, fparams, kinds, rows);
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
    trace<true, kExt, kSky, kTri>(sh.f, sh.kind_of, rows, k0, k1,
                                  (uint32_t)ray, px, py, max_depth, bg_kind,
                                  clay, sky, r, g, b, &tape);
    adjoint<kExt, kSky, kTri>(sh.f, sh.kind_of, rows, k0, k1, (uint32_t)ray,
                              px, py, bg_kind, clay, sky, tape, gr, gg, gb,
                              head, sh.gs, gsky);
  }
  write_partials(sh, head, 0.0f, rows, scene_floats(rows), partials);
}

}  // namespace

// Plain C entry, bound with ctypes (ops/radiance_grad.py).  Launches the
// gradient kernel on at most `max_blocks` blocks, then the row sum into
// `out` (the K floats of fparams), on `stream`; `partials` holds
// max_blocks rows of K floats.  `ext`, `mix`, `n_vol`, the triangles and
// the sky as rtrt_radiance's; under a sky map `gsky` (sky_h, sky_w, 3)
// receives the texels' gradient.  Returns cudaGetLastError() of the
// launches.
extern "C" int rtrt_radiance_grad(const float* fparams, const int* kinds,
                                  int n_spheres, uint32_t k0, uint32_t k1,
                                  int n_rays, int spp, int width,
                                  int max_depth, int bg_kind, int clay,
                                  int ext, int mix, int n_vol,
                                  const float* tri, int n_tri, int n_tm,
                                  const float* sky_img, int sky_h, int sky_w,
                                  float* gsky, const float* cts,
                                  float* partials, int max_blocks, float* out,
                                  void* stream) {
  const bool sky_map = bg_kind == kSkyMap;
  if (!rows_ok(n_spheres, ext, mix, n_vol, tri, n_tri, n_tm) || n_rays < 1 ||
      spp < 1 ||
      width < 1 || max_depth < 0 || max_depth > kMaxTape || max_blocks < 1 ||
      sky_map != (sky_img != nullptr) || sky_map != (gsky != nullptr) ||
      (sky_map && (sky_h < 1 || sky_w < 1)))
    return (int)cudaErrorInvalidValue;
  const Rows rows = make_rows(n_spheres, mix, n_vol, tri, n_tri, n_tm);
  const Sky sky{sky_img, sky_h, sky_w};
  const int n_out = scene_floats(rows);
  const int blocks = blocks_for(n_rays) < max_blocks ? blocks_for(n_rays)
                                                     : max_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = with_flags(ext, sky_map, n_tri > 0, [&](auto e, auto k,
                                                          auto t) {
    grad_kernel<decltype(e)::value, decltype(k)::value, decltype(t)::value>
        <<<blocks, kThreads, 0, s>>>(fparams, kinds, rows, k0, k1, n_rays,
                                     spp, width, max_depth, bg_kind, clay,
                                     sky, gsky, cts, partials);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  reduce_partials_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      partials, blocks, n_out, 0.0f, out);
  return (int)cudaGetLastError();
}
