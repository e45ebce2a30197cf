// Brute-force forward megakernel for scenes of spheres and triangles,
// written for Hopper (sm_90a).
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_kernel: the
// body _radiance_math with its in-kernel Threefry draw _stream_uniforms, for
// the envelope of ops/megakernel.py (0..128 spheres, constant-density volume
// spheres among them, and 0..8,192 surface triangles; Lambertian, Metal,
// Dielectric, Emission and Isotropic materials and single-level mixes of
// them; uniform, gradient or sky-map background; Full or Clay mode; any
// depth).  Per ray: a jittered camera ray, then up to max_depth bounces of
// closest hit over every sphere and every triangle, one material lobe and
// the throughput/radiance update.  Output: per-ray RGB, (n_rays, 3) float32.
// Clamping and the mean over samples stay in PyTorch.
//
// Eight variants (radiance.cuh trace's flags): solid spheres under a
// uniform or gradient background, the code of earlier builds; kExt for
// mixes, volumes and the isotropic lobe, whose rows are up to 22 floats;
// kSky for a sky map, whose texel an escaping ray looks up here (the TPU
// kernel records the escape and leaves the gather to XLA, _env_finish);
// kTri for triangles (_tri_intersect, its one-hot matmuls of the shading
// rows an index here); each combination of the three.
//
// What bounds it on this card: per-ray FP32, integer and transcendental
// work (Threefry rounds, the quadratic against every sphere, sqrt/sin/cos)
// over a tiny working set, at most 20 + 128 * 22 scene floats (and the sky's
// texels, read where rays escape), and the lanes a warp leaves idle: paths
// end after 1 to max_depth bounces, and on the zoo a warp of 32 consecutive
// rays keeps about half of its lanes busy while its longest path runs.
// The design follows:
// a persistent grid (cudaOccupancyMaxActiveBlocksPerMultiprocessor blocks an
// SM, no more than the rays need) whose lanes each hold one path's state in
// registers (radiance.cuh Path: ray, throughput, radiance; its ray id and
// bounce) and step it one bounce an iteration with radiance.cuh's bounce,
// the one bounce function that trace loops over for #3 and #4.  A lane
// whose path ends writes its 12 bytes and goes idle; once kRefill lanes of
// a warp are idle, the warp claims that many ray ids from a launch-local
// counter (__ballot_sync finds them, one atomicAdd claims them, __popc of
// the lower lanes gives each its id) and starts their camera rays, so the
// lanes stay busy to the last rays.  The counter lives in a scratch word
// the wrapper allocates and the entry zeroes on the launch's stream.  A
// claimed ray's bounces are those of trace, so the result is the same bit
// for bit, whatever lane takes it.  The scene constants are staged once per
// block into shared memory, the spheres' geometry as float4 {c, r * r}
// (stage_geo), where every lane of a warp reads the same word (a
// broadcast): the lanes of a warp may be at different bounces, but they
// all walk the spheres in index order.  Within a bounce, the sphere test
// takes no root where the discriminant is not >= 0.  On an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md) the zoo took 5.0 ms against one
// thread a ray's 17.0; claims at 8 idle lanes took less time over #1's
// eight shapes than at 1 or 16, and than each lane taking its own 4, 8 or
// 16 rays in turn (no counter).

// Triangles (kTri): the TPU kernel tests each ray against chunks of 512
// triangles as one matmul of its features [d, o x d, o, 1] by a (16, 4 TB)
// coefficient matrix, then gathers the winner's shading rows by a one-hot
// matmul.  Here one thread walks the triangles in clusters of 32
// consecutive rows (radiance.cuh cluster_thr, cluster_rows;
// ops/megakernel.py pack_tri_boxes).  A cluster's 256-byte record, read
// through the read-only path (8,192 triangles make 256 records, 64 KB,
// which L1 holds), holds a padded box and the rows' normals in half
// precision.  Where the ray's line misses the box, or meets it only past
// the best t so far or before T_MIN, a row can pass only if the ray nearly
// grazes it, so the lane takes the rows' determinants in half precision,
// two rows in three HFMA2s and a compare against a margin that covers
// their rounding, and tests only the few below the threshold; where the
// line meets the box, every row.  A tested row's 80-byte row comes as 5
// float4 loads (a broadcast where the warp's lanes test the same row): the
// determinant first, t next, u and v only for a t below the best so far.
// Each sum is the chain of fused multiply-adds that XLA's dot computes, so
// t agrees bit for bit with the TPU kernel's on the CPU, and the rows are
// visited in index order, so the winner and its tie rule are the dense
// loop's.  The slots' material rows (few: one per material) are staged in
// shared memory with the spheres'.  What bounds it: FP32 work, about 50
// operations a cluster, 3 a row whose determinant a lane takes, and 12 to
// 40 a row it tests.

// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// --fmad=false keeps every multiply and add separately rounded, as the plain
// PyTorch version and the JAX reference round them, so depth-1 radiance
// agrees bit for bit.  Where the JAX kernel calls rsqrt this computes
// 1 / sqrtf, as the plain version does.

#include <cuda_runtime.h>

#include <algorithm>

#include "radiance.cuh"

namespace {

using namespace rtrt;

constexpr unsigned kFull = 0xffffffffu;
// a warp claims new rays once this many of its lanes are idle
constexpr int kRefill = 8;

template <bool kExt, bool kSky, bool kTri>
__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ fparams,
                const int* __restrict__ kinds, Rows rows, uint32_t k0,
                uint32_t k1, int n_rays, int spp, int width, int max_depth,
                int bg_kind, int clay, Sky sky, unsigned* __restrict__ next,
                float* __restrict__ out) {
  constexpr int kMats = kTri ? kMaxTriMats : 0;
  __shared__ float4 geo[kMaxSpheres];
  __shared__ float f[kSpheres + kMaxSpheres * (kExt ? kMaxStride : kStride) +
                     kMats * (kExt ? kTriStrideMix : kTriStride)];
  __shared__ int kind_of[kMaxSpheres + kMats];
  const int n_f = scene_floats(rows);
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) f[i] = fparams[i];
  for (int i = threadIdx.x; i < rows.n + rows.n_tm; i += blockDim.x)
    kind_of[i] = kinds[i];
  stage_geo(geo, fparams, rows);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  Path p;
  int ray = 0, b = 0;  // the lane's ray (= pixel * spp + sample), its bounce
  bool live = false;     // the lane holds a path
  bool drained = false;  // the counter has passed n_rays (warp-uniform)
  for (;;) {
    const unsigned idle = __ballot_sync(kFull, !live);
    if (!drained && __popc(idle) >= kRefill) {
      const int leader = __ffs(idle) - 1;
      unsigned base = 0u;
      if (lane == leader) base = atomicAdd(next, (unsigned)__popc(idle));
      base = __shfl_sync(kFull, base, leader);
      drained = base + (unsigned)__popc(idle) >= (unsigned)n_rays;
      const unsigned id = base + __popc(idle & ((1u << lane) - 1u));
      if (!live && id < (unsigned)n_rays) {
        ray = (int)id;
        b = 0;
        live = true;
        const int pixel = ray / spp;
        start_path(f, k0, k1, (uint32_t)ray, (float)(pixel % width),
                   (float)(pixel / width), p);
      }
    }
    if (drained && !__any_sync(kFull, live)) break;
    if (!live) continue;
    int code;
    if (!bounce<kExt, kSky, kTri, true>(f, geo, kind_of, rows, k0, k1,
                                        (uint32_t)ray, b, bg_kind, clay, sky,
                                        p, code) ||
        ++b >= max_depth) {  // the path ended: its radiance
      float* o = out + 3 * (size_t)ray;
      o[0] = p.rr;
      o[1] = p.rg;
      o[2] = p.rb;
      live = false;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
uniforms_kernel(const int* __restrict__ ids, int n_ids, uint32_t k0,
                uint32_t k1, uint32_t stream, int n_cols,
                float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_ids) return;
  const uint32_t rid = (uint32_t)ids[i];
  float* o = out + i * n_cols;
  for (int j = 0; 2 * j < n_cols; ++j) {
    float a, b;
    uniform_pair(k0, k1, rid, stream, (uint32_t)j, a, b);
    o[2 * j] = a;
    if (2 * j + 1 < n_cols) o[2 * j + 1] = b;
  }
}

}  // namespace

// Plain C entries, bound with ctypes (ops/megakernel.py).  Each launches on
// `stream` and returns cudaGetLastError() of the launch.

// rtrt_radiance: `ext` selects the kExt variant (mixes, volumes or the
// isotropic lobe), `mix` and `n_vol` the scene's rows; triangles pass their
// (n_tri, 20) rows, the count of their material slots, whose rows end
// fparams and whose kinds end `kinds`, and their n_box cluster records
// (n_box, 16) (the kTri variant); a sky map
// (bg_kind kSkyMap) passes its (sky_h, sky_w, 3) texels.  `next` is one
// word of scratch in device memory, the launch's ray counter, which the
// entry zeroes on `stream` before the kernel: a launch needs a word no
// launch running beside it uses.
extern "C" int rtrt_radiance(const float* fparams, const int* kinds,
                             int n_spheres, uint32_t k0, uint32_t k1,
                             int n_rays, int spp, int width, int max_depth,
                             int bg_kind, int clay, int ext, int mix,
                             int n_vol, const float* tri, int n_tri,
                             int n_tm, const float* box, int n_box,
                             const float* sky_img, int sky_h,
                             int sky_w, unsigned* next, float* out,
                             void* stream) {
  const bool sky_map = bg_kind == kSkyMap;
  if (!rows_ok(n_spheres, ext, mix, n_vol, tri, n_tri, n_tm, box, n_box) ||
      n_rays < 0 || max_depth < 0 || next == nullptr ||
      spp < 1 || width < 1 || sky_map != (sky_img != nullptr) ||
      (sky_map && (sky_h < 1 || sky_w < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (max_depth == 0)  // no bounce: radiance 0
    return (int)cudaMemsetAsync(out, 0, 12 * (size_t)n_rays, s);
  const Rows rows = make_rows(n_spheres, mix, n_vol, tri, n_tri, n_tm, box,
                              n_box);
  const Sky sky{sky_img, sky_h, sky_w};
  return with_flags(ext, sky_map, n_tri > 0, [&](auto e, auto k, auto t) {
    const auto kernel = radiance_kernel<decltype(e)::value,
                                        decltype(k)::value,
                                        decltype(t)::value>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(next, 0, sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;
    const int grid = std::min(blocks_for(n_rays), std::max(1, sms * per_sm));
    kernel<<<grid, kThreads, 0, s>>>(fparams, kinds, rows, k0, k1, n_rays,
                                     spp, width, max_depth, bg_kind, clay,
                                     sky, next, out);
    return (int)cudaGetLastError();
  });
}

extern "C" int rtrt_uniforms(const int* ids, int n_ids, uint32_t k0,
                             uint32_t k1, uint32_t stream, int n_cols,
                             float* out, void* cuda_stream) {
  if (n_ids < 0 || n_cols < 1 || n_cols > 2 * (int)kCipherBlock)
    return (int)cudaErrorInvalidValue;
  if (n_ids == 0) return 0;
  uniforms_kernel<<<blocks_for(n_ids), kThreads, 0,
                    (cudaStream_t)cuda_stream>>>(ids, n_ids, k0, k1, stream,
                                                 n_cols, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
