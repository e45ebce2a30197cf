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
// What bounds it on this card: per-ray FP32 and transcendental work
// (Threefry rounds, the quadratic against every sphere, sqrt/sin/cos) over a
// tiny working set, at most 20 + 128 * 22 scene floats (and the sky's
// texels, read where rays escape).  The design follows:
// one thread traces one ray and keeps its whole state in registers for the
// whole chain; the scene constants are staged once per block into shared
// memory, where every lane of a warp reads the same word (a broadcast); ray
// ids and pixel coordinates come from the thread index, so the only device
// memory traffic is 12 bytes of output per ray.  The chain itself is
// radiance.cuh's trace<false>, which the gradient kernels replay.
//
// Triangles (kTri): the TPU kernel tests each ray against chunks of 512
// triangles as one matmul of its features [d, o x d, o, 1] by a (16, 4 TB)
// coefficient matrix, then gathers the winner's shading rows by a one-hot
// matmul.  Here one thread loops over every triangle: its 80-byte row
// (coefficients, flat normal, material slot) comes from device memory
// through the read-only path, as 5 float4 loads that every lane of a warp
// makes at the same address (a broadcast; 1,024 triangles are 80 KB, which
// L1 holds); the determinant and t first, u and v only for a t below the
// best so far.  Each sum is the chain of fused multiply-adds that XLA's
// dot computes, so t agrees bit for bit with the TPU kernel's on the CPU.
// The slots' material rows (few: one per material) are staged in shared
// memory with the spheres'.  What bounds it: FP32 work, about 12
// operations a triangle a bounce (up to 40 for a near one).
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// --fmad=false keeps every multiply and add separately rounded, as the plain
// PyTorch version and the JAX reference round them, so depth-1 radiance
// agrees bit for bit.  Where the JAX kernel calls rsqrt this computes
// 1 / sqrtf, as the plain version does.

#include <cuda_runtime.h>

#include "radiance.cuh"

namespace {

using namespace rtrt;

template <bool kExt, bool kSky, bool kTri>
__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ fparams,
                const int* __restrict__ kinds, Rows rows, uint32_t k0,
                uint32_t k1, int n_rays, int spp, int width, int max_depth,
                int bg_kind, int clay, Sky sky, float* __restrict__ out) {
  constexpr int kMats = kTri ? kMaxTriMats : 0;
  __shared__ float f[kSpheres + kMaxSpheres * (kExt ? kMaxStride : kStride) +
                     kMats * (kExt ? kTriStrideMix : kTriStride)];
  __shared__ int kind_of[kMaxSpheres + kMats];
  const int n_f = scene_floats(rows);
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) f[i] = fparams[i];
  for (int i = threadIdx.x; i < rows.n + rows.n_tm; i += blockDim.x)
    kind_of[i] = kinds[i];
  __syncthreads();

  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;  // the ragged last block
  const int ray = (int)gid;   // = pixel * spp + sample
  const int pixel = ray / spp;
  float rad_r, rad_g, rad_b;
  trace<false, kExt, kSky, kTri>(f, kind_of, rows, k0, k1, (uint32_t)ray,
                                 (float)(pixel % width),
                                 (float)(pixel / width), max_depth, bg_kind,
                                 clay, sky, rad_r, rad_g, rad_b, nullptr);
  float* o = out + 3 * (size_t)ray;
  o[0] = rad_r;
  o[1] = rad_g;
  o[2] = rad_b;
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
// (n_tri, 20) rows and the count of their material slots, whose rows end
// fparams and whose kinds end `kinds` (the kTri variant); a sky map
// (bg_kind kSkyMap) passes its (sky_h, sky_w, 3) texels.
extern "C" int rtrt_radiance(const float* fparams, const int* kinds,
                             int n_spheres, uint32_t k0, uint32_t k1,
                             int n_rays, int spp, int width, int max_depth,
                             int bg_kind, int clay, int ext, int mix,
                             int n_vol, const float* tri, int n_tri,
                             int n_tm, const float* sky_img, int sky_h,
                             int sky_w, float* out, void* stream) {
  const bool sky_map = bg_kind == kSkyMap;
  if (!rows_ok(n_spheres, ext, mix, n_vol, tri, n_tri, n_tm) || n_rays < 0 ||
      spp < 1 || width < 1 || sky_map != (sky_img != nullptr) ||
      (sky_map && (sky_h < 1 || sky_w < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Rows rows = make_rows(n_spheres, mix, n_vol, tri, n_tri, n_tm);
  const Sky sky{sky_img, sky_h, sky_w};
  return with_flags(ext, sky_map, n_tri > 0, [&](auto e, auto k, auto t) {
    radiance_kernel<decltype(e)::value, decltype(k)::value,
                    decltype(t)::value>
        <<<blocks_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
            fparams, kinds, rows, k0, k1, n_rays, spp, width, max_depth,
            bg_kind, clay, sky, out);
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
