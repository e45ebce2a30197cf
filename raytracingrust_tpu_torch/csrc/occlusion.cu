// Shadow-ray occlusion kernel (#8) for the HDRI importance-sampling path,
// written for Hopper (sm_90a).
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py's
// _make_occlusion_kernel (reached through _occlusion_call.run and
// occlusion_bvh): for each next-event shadow ray, whether anything of the
// scene lies along it beyond T_MIN, over the solid-sphere chunk tree and
// then the triangle chunk tree.  Inputs: origins and directions as (3, R)
// float32, component-major (x of every ray, then y, then z), and the trees
// as ops/bvh_kernel.pack lays them out.  Output: (R,) bytes, 1 where the
// ray is occluded.  The TPU kernel's volume-sphere tree (free flight with
// the NEE stream's uniforms) is not here: the port's scenes have no volume
// tree yet, and ops/occlusion.py refuses a scene with volume spheres.
//
// Any-hit.  The TPU kernel runs the closest-hit walk of both trees and
// answers t_best < inf.  Here a ray stops at its first accepted candidate
// (a distance below t_best), and the answer is whether it found one.  The
// two agree on every ray: until the first accepted candidate, t_best is
// +inf in both, so both walks visit the same nodes and test the same
// primitives with the same arithmetic (bvh_walk.cuh's, shared with #5);
// the closest-hit walk's t_best is finite afterwards whatever else it
// finds, and without such a candidate both end with t_best = +inf.
//
// Design: one thread a ray, its state in registers; the triangle tree is
// walked only by rays the sphere tree did not occlude.  No TPU blocking,
// direction padding, scalar prefetch or packet cursor: each ray walks on
// its own and tests a leaf only when its own slab test hits the box.
//
// What bounds it on this card: FP32 work per node visit and primitive test
// (the data it must move, 25 bytes a ray and the trees once, is small), and
// divergence between the rays of a warp, whose shadow directions are drawn
// from the sky independently of each other.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using namespace rtrt;

__global__ void __launch_bounds__(kThreads)
occlusion_kernel(Tree sph, Tree tri, int leaf, const float* __restrict__ o,
                 const float* __restrict__ d, int n_rays,
                 unsigned char* __restrict__ out) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;  // the ragged last block
  const int i = (int)gid;
  Ray r;
  r.ox = o[i];
  r.oy = o[n_rays + i];
  r.oz = o[2 * (size_t)n_rays + i];
  r.dx = d[i];
  r.dy = d[n_rays + i];
  r.dz = d[2 * (size_t)n_rays + i];
  r.a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  r.idx = 1.0f / r.dx;
  r.idy = 1.0f / r.dy;
  r.idz = 1.0f / r.dz;
  float t_best = INFINITY;
  int win = -1;
  walk<true, true>(sph, leaf, r, t_best, win);
  if (!(t_best < INFINITY)) walk<false, true>(tri, leaf, r, t_best, win);
  out[i] = t_best < INFINITY ? 1 : 0;
}

}  // namespace

// Plain C entry, bound with ctypes (ops/occlusion.py).  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int rtrt_occlusion(
    const float* s_nodes_f, const int* s_nodes_i, const int* s_len,
    const float* s_geo, const int* s_mat, int s_nodes,
    const float* t_nodes_f, const int* t_nodes_i, const int* t_len,
    const float* t_geo, const int* t_mat, int t_nodes, int leaf,
    const float* o, const float* d, int n_rays, unsigned char* out,
    void* stream) {
  if (s_nodes < 0 || t_nodes < 0 || s_nodes + t_nodes < 1 || leaf < 1 ||
      n_rays < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Tree sph{s_nodes_f, s_nodes_i, s_len, s_geo, s_mat, s_nodes};
  const Tree tri{t_nodes_f, t_nodes_i, t_len, t_geo, t_mat, t_nodes};
  occlusion_kernel<<<blocks_for(n_rays), kThreads, 0,
                     (cudaStream_t)stream>>>(sph, tri, leaf, o, d, n_rays,
                                             out);
  return (int)cudaGetLastError();
}
