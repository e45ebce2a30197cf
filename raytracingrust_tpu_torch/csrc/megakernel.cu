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
// memory traffic is 12 bytes of output per ray.  A thread stops at its own
// ray's end: a finished ray's state never changes, so this equals the TPU
// kernel's all-lanes chain.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// --fmad=false keeps every multiply and add separately rounded, as the plain
// PyTorch version and the JAX reference round them, so depth-1 radiance
// agrees bit for bit.  Where the JAX kernel calls rsqrt this computes
// 1 / sqrtf, as the plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSpheres = 128;
// packed float layout (ops/megakernel.py, pallas_megakernel._pack_fparams)
constexpr int kCam = 0;       // origin, horizontal, vertical, lower-left
constexpr int kBg = 12;       // background color a, color b
constexpr int kInvW = 18;     // 1 / (width - 1)
constexpr int kInvH = 19;     // 1 / (height - 1)
constexpr int kSpheres = 20;  // per sphere: c xyz, r, albedo rgb, fuzz, ir,
constexpr int kStride = 12;   //             emission rgb
constexpr uint32_t kCipherBlock = 256;
constexpr float kTMin = 1e-5f;
constexpr float kTwoPi = 6.28318548202514648f;  // 2 * float32(pi)

enum Kind { kLambertian = 0, kMetal = 1, kDielectric = 2, kEmission = 3 };
enum BgKind { kUniform = 0, kGradient = 1 };

// ---------------------------------------------------------------- Threefry

__host__ __device__ constexpr int rot(int i) {
  return i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : i == 3 ? 6
       : i == 4 ? 17 : i == 5 ? 29 : i == 6 ? 16 : 24;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, kRounds rounds, key injection after every 4th round
// (raytracingrust_tpu/utils/rng.py::threefry2x32).
template <int kRounds>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    x0 += x1;
    x1 = rotl(x1, rot(i % 8)) ^ x0;
    if (i % 4 == 3) {
      const int j = i / 4 + 1;
      x0 += j % 3 == 0 ? k0 : j % 3 == 1 ? k1 : k2;
      x1 += ((j + 1) % 3 == 0 ? k0 : (j + 1) % 3 == 1 ? k1 : k2) + uint32_t(j);
    }
  }
}

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Uniform columns 2j and 2j + 1 of `stream` for ray `ray`: the two words of
// threefry(seed, x0 = ray, x1 = stream * 256 + j).
__device__ __forceinline__ void uniform_pair(uint32_t k0, uint32_t k1,
                                             uint32_t ray, uint32_t stream,
                                             uint32_t j, float& a, float& b) {
  uint32_t x0 = ray, x1 = stream * kCipherBlock + j;
  threefry2x32<13>(k0, k1, x0, x1);
  a = bits_to_uniform(x0);
  b = bits_to_uniform(x1);
}

// ---------------------------------------------------------------- tracing

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__global__ void __launch_bounds__(kThreads)
radiance_kernel(const float* __restrict__ fparams,
                const int* __restrict__ kinds, int n_spheres, uint32_t k0,
                uint32_t k1, int n_rays, int spp, int width, int max_depth,
                int bg_kind, int clay, float* __restrict__ out) {
  __shared__ float f[kSpheres + kMaxSpheres * kStride];
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
  const float px = (float)(pixel % width);
  const float py = (float)(pixel / width);
  const uint32_t rid = (uint32_t)ray;

  // camera ray from the pixel jitter (stream 0)
  float j1, j2;
  uniform_pair(k0, k1, rid, 0u, 0u, j1, j2);
  const float s = (px + j1) * f[kInvW];
  const float t = (py + j2) * f[kInvH];
  const float oxc = f[kCam + 0], oyc = f[kCam + 1], ozc = f[kCam + 2];
  float dx = f[kCam + 9] + s * f[kCam + 3] - t * f[kCam + 6] - oxc;
  float dy = f[kCam + 10] + s * f[kCam + 4] - t * f[kCam + 7] - oyc;
  float dz = f[kCam + 11] + s * f[kCam + 5] - t * f[kCam + 8] - ozc;
  float ox = 0.0f + oxc, oy = 0.0f + oyc, oz = 0.0f + ozc;
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;

  for (int b = 0; b < max_depth; ++b) {
    // bounce stream 1 + b: columns [u1, u2, coin]
    float u1, u2, u_coin, u_spare;
    uniform_pair(k0, k1, rid, 1u + (uint32_t)b, 0u, u1, u2);
    uniform_pair(k0, k1, rid, 1u + (uint32_t)b, 1u, u_coin, u_spare);
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv_a = 1.0f / a;

    // closest hit, direct quadratic; a tie keeps the lower index
    float t_best = INFINITY;
    int best = -1;
    for (int i = 0; i < n_spheres; ++i) {
      const float* sp = f + kSpheres + i * kStride;
      const float ocx = ox - sp[0], ocy = oy - sp[1], ocz = oz - sp[2];
      const float half_b = dot3(ocx, ocy, ocz, dx, dy, dz);
      const float cq = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - sp[3] * sp[3];
      const float disc = half_b * half_b - a * cq;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-half_b - sq) * inv_a;
      const float t2 = (-half_b + sq) * inv_a;
      const bool t1ok = t1 >= kTMin && t1 <= t_best;
      const bool t2ok = t2 >= kTMin && t2 <= t_best;
      const float ti = t1ok ? t1 : (t2ok ? t2 : INFINITY);
      if (disc >= 0.0f && ti < t_best) {
        t_best = ti;
        best = i;
      }
    }

    if (best < 0) {  // miss: the background ends the path
      float bg_r = f[kBg + 0], bg_g = f[kBg + 1], bg_b = f[kBg + 2];
      if (bg_kind == kGradient) {
        const float norm = 1.0f / sqrtf(dot3(dx, dy, dz, dx, dy, dz));
        const float tt = 0.5f * (dy * norm + 1.0f);
        bg_r = (1.0f - tt) * f[kBg + 0] + tt * f[kBg + 3];
        bg_g = (1.0f - tt) * f[kBg + 1] + tt * f[kBg + 4];
        bg_b = (1.0f - tt) * f[kBg + 2] + tt * f[kBg + 5];
      }
      rad_r = rad_r + thr_r * bg_r;
      rad_g = rad_g + thr_g * bg_g;
      rad_b = rad_b + thr_b * bg_b;
      break;
    }

    const float* sp = f + kSpheres + best * kStride;
    const float inv_r = 1.0f / sp[3];
    const float ptx = ox + t_best * dx;
    const float pty = oy + t_best * dy;
    const float ptz = oz + t_best * dz;
    float nx = (ptx - sp[0]) * inv_r;
    float ny = (pty - sp[1]) * inv_r;
    float nz = (ptz - sp[2]) * inv_r;
    const bool front = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    nx = nx * sgn;
    ny = ny * sgn;
    nz = nz * sgn;

    // unit-sphere-surface sample
    const float zs = 1.0f - 2.0f * u1;
    const float rs = sqrtf(fmaxf(0.0f, 1.0f - zs * zs));
    const float phi = kTwoPi * u2;
    const float sx = rs * cosf(phi);
    const float sy = rs * sinf(phi);
    const float sz = zs;
    float ldx = nx + sx, ldy = ny + sy, ldz = nz + sz;
    if (fabsf(ldx) < 1e-8f && fabsf(ldy) < 1e-8f && fabsf(ldz) < 1e-8f) {
      ldx = nx;
      ldy = ny;
      ldz = nz;
    }

    float at_r = 0.0f, at_g = 0.0f, at_b = 0.0f;
    float ndx = nx, ndy = ny, ndz = nz;
    bool scatters = true;
    const int kind = kind_of[best];
    if (clay) {  // a gray Lambertian everywhere
      at_r = at_g = at_b = 0.8f;
      ndx = ldx;
      ndy = ldy;
      ndz = ldz;
    } else if (kind == kLambertian) {
      at_r = sp[4];
      at_g = sp[5];
      at_b = sp[6];
      ndx = ldx;
      ndy = ldy;
      ndz = ldz;
    } else if (kind == kMetal) {
      const float fuzz = sp[7];
      const float dn = dot3(dx, dy, dz, nx, ny, nz);
      const float rfx = dx - 2.0f * dn * nx;
      const float rfy = dy - 2.0f * dn * ny;
      const float rfz = dz - 2.0f * dn * nz;
      const float inv_len =
          1.0f / sqrtf(fmaxf(dot3(rfx, rfy, rfz, rfx, rfy, rfz), 1e-30f));
      ndx = rfx * inv_len + fuzz * sx;
      ndy = rfy * inv_len + fuzz * sy;
      ndz = rfz * inv_len + fuzz * sz;
      scatters = dot3(ndx, ndy, ndz, nx, ny, nz) > 0.0f;
      if (scatters) {
        at_r = sp[4];
        at_g = sp[5];
        at_b = sp[6];
      }
    } else if (kind == kDielectric) {
      const float ir = sp[8];
      const float ratio = front ? 1.0f / ir : ir;
      const float inv_len = 1.0f / sqrtf(fmaxf(a, 1e-30f));
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      const float cos_t = fminf(-dot3(nx, ny, nz, udx, udy, udz), 1.0f);
      const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float omc = 1.0f - cos_t;
      const float omc2 = omc * omc;
      const float schl = r0 + (1.0f - r0) * omc2 * omc2 * omc;
      if (ratio * sin_t > 1.0f || schl > u_coin) {  // reflect
        const float udn = dot3(udx, udy, udz, nx, ny, nz);
        ndx = udx - 2.0f * udn * nx;
        ndy = udy - 2.0f * udn * ny;
        ndz = udz - 2.0f * udn * nz;
      } else {  // refract
        const float perp_x = ratio * (udx + cos_t * nx);
        const float perp_y = ratio * (udy + cos_t * ny);
        const float perp_z = ratio * (udz + cos_t * nz);
        const float par = -sqrtf(fmaxf(
            fabsf(1.0f - dot3(perp_x, perp_y, perp_z, perp_x, perp_y,
                              perp_z)),
            1e-12f));
        ndx = perp_x + par * nx;
        ndy = perp_y + par * ny;
        ndz = perp_z + par * nz;
      }
      at_r = at_g = at_b = 1.0f;
    } else if (kind == kEmission) {
      at_r = sp[9];
      at_g = sp[10];
      at_b = sp[11];
      scatters = false;
    }

    if (!scatters) {  // absorbed or emitted: the path ends
      rad_r = rad_r + thr_r * at_r;
      rad_g = rad_g + thr_g * at_g;
      rad_b = rad_b + thr_b * at_b;
      break;
    }
    thr_r = thr_r * at_r;
    thr_g = thr_g * at_g;
    thr_b = thr_b * at_b;
    ox = ptx;
    oy = pty;
    oz = ptz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }

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

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

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
