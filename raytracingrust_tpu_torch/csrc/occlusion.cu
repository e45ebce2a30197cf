// Shadow-ray occlusion kernel (#8) for the HDRI importance-sampling path,
// written for Hopper (sm_90a).
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py's
// _make_occlusion_kernel (reached through _occlusion_call.run and
// occlusion_bvh): for each next-event shadow ray, whether anything of the
// scene lies along it beyond T_MIN, over the solid-sphere chunk tree, then
// the volume-sphere tree, then the triangle chunk tree.  Inputs: origins
// and directions as (3, R) float32, component-major (x of every ray, then
// y, then z), each ray's global id, the key and the bounce's NEE stream,
// and the trees as ops/bvh_kernel.pack lays them out.  Output: (R,) bytes,
// 1 where the ray is occluded.  A volume occludes stochastically, as in
// the JAX kernel: the ray's free flight through it, -1/density * log(u)
// with u the NEE stream's column 2 + ordinal (bvh_walk.cuh's volume_t,
// #5's arithmetic), must end inside its boundary window.
//
// Any-hit.  The TPU kernel runs the closest-hit walk of the three trees and
// answers t_best < inf.  Here a ray stops at its first accepted candidate
// (a distance below t_best), and the answer is whether it found one.  The
// two agree on every ray: until the first accepted candidate, t_best is
// +inf in both, so both walks visit the same nodes and test the same
// primitives with the same arithmetic (bvh_walk.cuh's, shared with #5),
// and a candidate's acceptance depends on t_best only through "below
// t_best", which +inf makes true of every finite distance.  A volume
// candidate's own test (its window valid, its free flight inside it)
// reads nothing of t_best, and its uniform is a function of the ray id,
// the stream and the volume, not of the walk, so it too is decided the
// same in both.  The closest-hit walk's t_best is finite after the first
// accepted candidate whatever else it finds, and without one both end with
// t_best = +inf.
//
// Design: one thread a ray, its state in registers; the volume tree is
// walked only by rays the sphere tree did not occlude, the triangle tree
// only by rays neither did.  The variant without volumes (template flag
// kVol) is the kernel of scenes without them and reads no ray id.  No TPU
// blocking, direction padding, scalar prefetch or packet cursor: each ray
// walks on its own and tests a leaf only when its own slab test hits the
// box.
//
// What bounds it on this card: FP32 work per node visit and primitive test
// (the data it must move, 25 bytes a ray, 29 with volumes, and the trees
// once, is small), and divergence between the rays of a warp, whose shadow
// directions are drawn from the sky independently of each other.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using namespace rtrt;

// the NEE stream's columns: the sky direction's two, then one a volume
constexpr int kNeeVolCol = 2;

template <bool kVol>
__global__ void __launch_bounds__(kThreads)
occlusion_kernel(Tree sph, Tree vol, Tree tri, int leaf,
                 const int* __restrict__ ray_ids, uint32_t k0, uint32_t k1,
                 uint32_t stream, const float* __restrict__ o,
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
  walk<kSphereTree, true>(sph, leaf, r, t_best, win);
  if (kVol && !(t_best < INFINITY))
    walk<kVolumeTree, true>(vol, leaf, r, t_best, win,
                            Flight{k0, k1, (uint32_t)__ldg(ray_ids + i),
                                   stream, kNeeVolCol, sqrtf(r.a)});
  if (!(t_best < INFINITY))
    walk<kTriangleTree, true>(tri, leaf, r, t_best, win);
  out[i] = t_best < INFINITY ? 1 : 0;
}

}  // namespace

// Plain C entry, bound with ctypes (ops/occlusion.py).  The volume tree
// (v_*, v_nodes > 0) needs the rays' ids, the key and the NEE stream.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int rtrt_occlusion(
    const float* s_nodes_f, const int* s_nodes_i, const int* s_len,
    const float* s_geo, const int* s_mat, int s_nodes,
    const float* v_nodes_f, const int* v_nodes_i, const int* v_len,
    const float* v_geo, const int* v_mat, const float* v_nid,
    const int* v_ord, int v_nodes, const float* t_nodes_f,
    const int* t_nodes_i, const int* t_len, const float* t_geo,
    const int* t_mat, int t_nodes, int leaf, int n_vol, const int* ray_ids,
    uint32_t k0, uint32_t k1, uint32_t nee_stream, const float* o,
    const float* d, int n_rays, unsigned char* out, void* stream) {
  if (s_nodes < 0 || v_nodes < 0 || t_nodes < 0 ||
      s_nodes + v_nodes + t_nodes < 1 || leaf < 1 || n_rays < 0 ||
      n_vol < 0 || n_vol > 8 ||
      (v_nodes > 0 && (!v_nid || !v_ord || !ray_ids || n_vol < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Tree sph{s_nodes_f, s_nodes_i, s_len, s_geo, s_mat,
                 nullptr,   nullptr,   s_nodes};
  const Tree vol{v_nodes_f, v_nodes_i, v_len, v_geo, v_mat,
                 v_nid,     v_ord,     v_nodes};
  const Tree tri{t_nodes_f, t_nodes_i, t_len, t_geo, t_mat,
                 nullptr,   nullptr,   t_nodes};
  const cudaStream_t st = (cudaStream_t)stream;
  if (v_nodes > 0)
    occlusion_kernel<true><<<blocks_for(n_rays), kThreads, 0, st>>>(
        sph, vol, tri, leaf, ray_ids, k0, k1, nee_stream, o, d, n_rays, out);
  else
    occlusion_kernel<false><<<blocks_for(n_rays), kThreads, 0, st>>>(
        sph, vol, tri, leaf, ray_ids, k0, k1, nee_stream, o, d, n_rays, out);
  return (int)cudaGetLastError();
}
