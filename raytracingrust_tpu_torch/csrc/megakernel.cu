// Brute-force forward megakernel for sphere scenes, written for Hopper
// (sm_90a).
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py::_make_kernel: the
// body _radiance_math with its in-kernel Threefry draw _stream_uniforms, for
// the envelope of ops/megakernel.py (1..128 solid spheres; Lambertian, Metal,
// Dielectric and Emission; uniform or gradient background; Full or Clay
// mode; any depth).  Per ray: a jittered camera ray, then up to max_depth
// bounces of closest hit over every sphere, one material lobe and the
// throughput/radiance update.  Output: per-ray RGB, (n_rays, 3) float32.
// Clamping and the mean over samples stay in PyTorch.
//
// What bounds it on this card: per-ray FP32 and transcendental work
// (Threefry rounds, the quadratic against every sphere, sqrt/sin/cos) over a
// tiny working set, at most 20 + 128 * 12 scene floats.  The design follows:
// one thread traces one ray and keeps its whole state in registers for the
// whole chain; the scene constants are staged once per block into shared
// memory, where every lane of a warp reads the same word (a broadcast); ray
// ids and pixel coordinates come from the thread index, so the only device
// memory traffic is 12 bytes of output per ray.  The chain itself is
// radiance.cuh's trace<false>, which the gradient kernels replay.
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

__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ fparams,
                const int* __restrict__ kinds, int n_spheres, uint32_t k0,
                uint32_t k1, int n_rays, int spp, int width, int max_depth,
                int bg_kind, int clay, float* __restrict__ out) {
  __shared__ float f[kMaxFloats];
  __shared__ int kind_of[kMaxSpheres];
  const int n_f = kSpheres + n_spheres * kStride;
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) f[i] = fparams[i];
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x)
    kind_of[i] = kinds[i];
  __syncthreads();

  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;  // the ragged last block
  const int ray = (int)gid;   // = pixel * spp + sample
  const int pixel = ray / spp;
  float rad_r, rad_g, rad_b;
  trace<false>(f, kind_of, n_spheres, k0, k1, (uint32_t)ray,
               (float)(pixel % width), (float)(pixel / width), max_depth,
               bg_kind, clay, rad_r, rad_g, rad_b, nullptr);
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

extern "C" int rtrt_radiance(const float* fparams, const int* kinds,
                             int n_spheres, uint32_t k0, uint32_t k1,
                             int n_rays, int spp, int width, int max_depth,
                             int bg_kind, int clay, float* out, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_rays < 0 || spp < 1 ||
      width < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  radiance_kernel<<<blocks_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      fparams, kinds, n_spheres, k0, k1, n_rays, spp, width, max_depth,
      bg_kind, clay, out);
  return (int)cudaGetLastError();
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
