// Radiance gradient kernel for scenes of spheres and triangles, written for
// Hopper (sm_90a): the backward of the forward megakernel.
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_grad_kernel
// (reached through run_grad in _radiance_cvjp), which replays the forward
// and takes jax.vjp of _radiance_math against per-ray radiance cotangents.
// Here: one thread per ray (grid-stride over the rays) reads the ray's
// cotangent (3 floats), replays the ray with a recording trace and runs the
// hand-derived adjoint of radiance.cuh (the loop below); the result is
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
// fixed order, so the result varies in its last bits between runs.  (Summing
// a warp's lanes that add to the same row with shuffles first was faster on
// the H100 at the sphere-only shapes, slower at the triangle zoo under a sky,
// the largest: not kept.)
//
// The loop, as mse_loss.cu's: each thread holds two tapes.  Iteration i
// traces ray i into tapes[cur], then runs the adjoint of the thread's last
// traced ray (its cotangent kept in registers) from tapes[cur ^ 1]; one
// iteration past the thread's last ray runs the last adjoint.  A ray whose
// cotangent is zero is neither traced nor held: `cur` stays, and the
// pending flag clears once the last ray's adjoint has run, so no adjoint
// reads a stale tape or cotangent.  The trip count is the warp's: a vote
// (__any_sync) ends the loop once no lane of the warp has a ray left, and
// reconverges the warp every iteration.  Without it the lanes of a warp
// drift apart over the iterations, and the kernel took 1.2-1.8 times as
// long on the H100 (mse_loss.cu's shuffles reconverge its warps every
// iteration too); without the vote a second tape took 5-15% longer than
// one, with it one tape measured 0-4% faster.  The loop body holds no
// barrier; every thread reaches write_partials' barrier once.  The frame
// is the two tapes, 1,008 bytes of local memory a thread; __launch_bounds__
// asks for kMinBlocks blocks an SM (at most 128 registers a thread: 94-115,
// no spill), which GradShared<true, true>'s 40 KB of shared memory a block
// allows (4 x 40 KB of the SM's 227 KB).
//
// What bounds it on this card: the per-ray FP32 work of two passes over the
// chain (the recording forward and the reverse sweep, which recomputes each
// bounce against its winner only), the tape's local-memory traffic (40
// bytes a bounce, written once and read once, mostly from L1), and the
// latency of their dependent chains at 4 blocks of 128 threads an SM; the
// lanes of a warp diverge where their paths do.  Device memory traffic is
// 12 bytes of cotangent per ray.

#include <cuda_runtime.h>

#include "radiance.cuh"

namespace {

using namespace rtrt;

constexpr unsigned kFull = 0xffffffffu;
// at least 4 blocks an SM: at most 128 registers a thread, which every
// instance needs without a spill
constexpr int kMinBlocks = 4;

template <bool kExt, bool kSky, bool kTri>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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

  Tape tapes[2];
  int cur = 0;
  bool pending = false;  // tapes[cur ^ 1] holds a ray whose adjoint is due
  uint32_t p_ray = 0;
  float p_gr = 0.0f, p_gg = 0.0f, p_gb = 0.0f;  // its cotangent
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;;
       ray += stride) {
    const bool more = ray < n_rays;
    float gr = 0.0f, gg = 0.0f, gb = 0.0f;
    if (more) {
      gr = cts[3 * ray];
      gg = cts[3 * ray + 1];
      gb = cts[3 * ray + 2];
    }
    const bool live = gr != 0.0f || gg != 0.0f || gb != 0.0f;
    if (live) {
      const int pixel = (int)ray / spp;
      float r, g, b;
      trace<true, kExt, kSky, kTri>(sh.f, sh.kind_of, rows, k0, k1,
                                    (uint32_t)ray, (float)(pixel % width),
                                    (float)(pixel / width), max_depth,
                                    bg_kind, clay, sky, r, g, b, &tapes[cur]);
    }
    if (pending) {
      const int pixel = (int)p_ray / spp;
      adjoint<kExt, kSky, kTri>(sh.f, sh.kind_of, rows, k0, k1, p_ray,
                                (float)(pixel % width),
                                (float)(pixel / width), bg_kind, clay, sky,
                                tapes[cur ^ 1], p_gr, p_gg, p_gb, head, sh.gs,
                                gsky);
    }
    pending = live;
    if (live) {
      p_ray = (uint32_t)ray;
      p_gr = gr;
      p_gg = gg;
      p_gb = gb;
      cur ^= 1;
    }
    if (!__any_sync(kFull, more)) break;  // every lane of the warp votes
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
                                  const float* box, int n_box,
                                  const float* sky_img, int sky_h, int sky_w,
                                  float* gsky, const float* cts,
                                  float* partials, int max_blocks, float* out,
                                  void* stream) {
  const bool sky_map = bg_kind == kSkyMap;
  if (!rows_ok(n_spheres, ext, mix, n_vol, tri, n_tri, n_tm, box, n_box) ||
      n_rays < 1 ||
      spp < 1 ||
      width < 1 || max_depth < 0 || max_depth > kMaxTape || max_blocks < 1 ||
      sky_map != (sky_img != nullptr) || sky_map != (gsky != nullptr) ||
      (sky_map && (sky_h < 1 || sky_w < 1)))
    return (int)cudaErrorInvalidValue;
  const Rows rows = make_rows(n_spheres, mix, n_vol, tri, n_tri, n_tm, box,
                              n_box);
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
