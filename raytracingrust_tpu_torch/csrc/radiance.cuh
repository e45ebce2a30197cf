// Device code shared by the kernels of csrc/: the Threefry draw, the camera
// ray, the background and the material lobes (every intersect stage), the
// forward bounce chain of the brute sphere kernel, its hand-derived adjoint,
// and the per-block gradient sums.
//
//   megakernel.cu     radiance_kernel   forward, per-ray RGB
//   radiance_grad.cu  grad_kernel       d(sum cts . radiance)/d(fparams)
//   mse_loss.cu       mse_kernel        MSE of the clamped pixel means, and
//                                       its gradient, in one launch
//   bvh_forward.cu    bvh_kernel        forward over the chunk-leaf BVH,
//                                       per-ray RGB (and each bounce's
//                                       winner code in record mode)
//
// The forward chain is raytracingrust_tpu/ops/pallas_megakernel.py's
// _radiance_math for the envelope of ops/megakernel.py.  Its branches past
// solid spheres under a uniform or gradient background sit behind three
// template flags, so a scene without them runs the code it ran before:
// kExt (single-level mixes, constant-density volume spheres, the isotropic
// lobe; the row stride and the volume count are run-time values), kSky
// (a sky map, its nearest texel looked up where a ray escapes) and kTri
// (surface triangles, _tri_intersect's bilinear test after the spheres).
// The adjoint is the reverse of that chain with its discrete decisions
// (winner, root, front face, metal-above-surface, dielectric reflect, the
// mix leaf, a volume's window and free-flight test) held fixed, which is
// what jax.vjp of _radiance_math and autograd of the plain PyTorch version
// compute where they are finite.  Spheres a ray misses contribute nothing: unlike
// jax.vjp through jnp.sqrt(jnp.maximum(disc, 0)), no masked branch is
// differentiated, so no NaN can come out of one.
//
// Reverse mode needs the forward's states.  A recording trace writes, per
// bounce, the ray entering it, the throughput it carries and the packed
// decisions into a per-thread tape of kMaxTape bounces (local memory); the
// reverse sweep recomputes the rest of each bounce from that record with the
// same operations, so every recomputed value has the forward's bits.
//
// Built with --fmad=false (ops/_build.py): every multiply and add is rounded
// on its own, as in the plain PyTorch version.

#pragma once

#include <math.h>
#include <stdint.h>

namespace rtrt {

constexpr int kThreads = 128;
constexpr int kMaxSpheres = 128;
// packed float layout (ops/megakernel.py, pallas_megakernel._pack_fparams)
constexpr int kCam = 0;       // origin, horizontal, vertical, lower-left
constexpr int kBg = 12;       // background color a, color b
constexpr int kInvW = 18;     // 1 / (width - 1)
constexpr int kInvH = 19;     // 1 / (height - 1)
constexpr int kSpheres = 20;  // per sphere: c xyz, r, albedo rgb, fuzz, ir,
constexpr int kStride = 12;   //             emission rgb
// kExt rows: with mixes leaf A in the base slots, then the mix factor and
// leaf B (stride 21); with volume spheres one more slot, -1/density
constexpr int kFactor = 12;
constexpr int kLeafA = 4;
constexpr int kLeafB = 13;
constexpr int kStrideMix = 21;
constexpr int kMaxStride = kStrideMix + 1;
constexpr int kHead = kSpheres;
constexpr uint32_t kCipherBlock = 256;
constexpr float kTMin = 1e-5f;
constexpr float kTwoPi = 6.28318548202514648f;  // 2 * float32(pi)
// bounces a recording trace can hold: the JAX fit path's depth gate
// (pallas_megakernel.UNROLL_MAX_DEPTH)
constexpr int kMaxTape = 12;
// kTri: the triangles' rows (ops/megakernel.py pack_tri), in device memory:
// n = e1 x e2, v0 x e2, e2, v0 x e1, e1, v0 . n, the flat normal, the slot
constexpr int kMaxTris = 8192;
constexpr int kTriCols = 20;
constexpr int kTriNrm = 16;
constexpr int kTriSlot = 19;
// ... and the rows of their material slots after the spheres' in fparams:
// leaf A, then with mixes the factor and leaf B
constexpr int kMaxTriMats = 128;
constexpr int kTriStride = 8;
constexpr int kTriStrideMix = 17;
// a material row from its leaf A on, a sphere's or a slot's: the factor,
// then leaf B
constexpr int kRowFactor = kFactor - kLeafA;
constexpr int kRowLeafB = kLeafB - kLeafA;
constexpr float kTriDetEps = 1e-8f;  // pallas_megakernel.TRI_DET_EPS

enum Kind {
  kLambertian = 0,
  kMetal = 1,
  kDielectric = 2,
  kEmission = 3,
  kIsotropic = 4,
  kMix = 5
};
enum BgKind { kUniform = 0, kGradient = 1, kSkyMap = 2 };

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

// Uniform column c of `stream` for ray `ray`.
__device__ __forceinline__ float uniform_col(uint32_t k0, uint32_t k1,
                                             uint32_t ray, uint32_t stream,
                                             uint32_t c) {
  float a, b;
  uniform_pair(k0, k1, ray, stream, c >> 1, a, b);
  return (c & 1u) ? b : a;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// ---------------------------------------------------------------- the tape

// Bounce::code: the winner in bits 0-13 (a sphere, or under kTriHit a
// triangle up to kMaxTris - 1; kMiss when none), then the bounce's discrete
// decisions.  The code stays one int, so the tape's frame keeps its size.
constexpr int kWinner = 0x3fff;
constexpr int kMiss = 0x3fff;
constexpr int kRoot2 = 1 << 14;    // the far root of the quadratic won
constexpr int kFront = 1 << 15;    // the ray hit the outside
constexpr int kMetalOk = 1 << 16;  // the metal lobe left above the surface
constexpr int kReflect = 1 << 17;  // the dielectric reflected
constexpr int kVolume = 1 << 18;   // a volume's free flight won (kExt)
constexpr int kPickB = 1 << 19;    // the mix coin picked leaf B (kExt)
constexpr int kTriHit = 1 << 20;   // the winner is a triangle (kTri)

// The brute kernels' scene rows (ops/megakernel.py): the sphere count, the
// floats of a row (kStride outside kExt), single-level mixes, and the
// volume spheres, the last n_vol; under kTri the triangles' rows in device
// memory, their count and the count of their material slots.
struct Rows {
  int n, stride, mix, n_vol;
  const float* tri;
  int n_tri, n_tm;
};

// Floats of one triangle material slot's row.
__host__ __device__ inline int tri_stride(const Rows& rows) {
  return rows.mix ? kTriStrideMix : kTriStride;
}

// Floats of fparams: the head, the spheres' rows, the slots' rows.
__host__ __device__ inline int scene_floats(const Rows& rows) {
  return kSpheres + rows.n * rows.stride + rows.n_tm * tri_stride(rows);
}

// A winner's material kind: with mixes kind A in bits 0-7, kind B in bits
// 8-15, picked by the code's kPickB.
__device__ __forceinline__ int kind_at(int kinds, int code) {
  return ((code & kPickB) ? kinds >> 8 : kinds) & 0xff;
}

struct Bounce {
  float ox, oy, oz, dx, dy, dz;  // the ray entering the bounce
  float tr, tg, tb;              // the throughput it carries
  int code;
};

struct Tape {
  Bounce b[kMaxTape];
  int n;       // bounces traced
  bool ended;  // the path ended (miss or absorbed/emitted) at bounce n - 1
};

// ---------------------------------------------------------------- forward

// The jittered camera ray of ray `rid` (stream 0), from the packed head.
__device__ __forceinline__ void camera_ray(const float* f, uint32_t k0,
                                           uint32_t k1, uint32_t rid,
                                           float px, float py, float& ox,
                                           float& oy, float& oz, float& dx,
                                           float& dy, float& dz) {
  float j1, j2;
  uniform_pair(k0, k1, rid, 0u, 0u, j1, j2);
  const float s = (px + j1) * f[kInvW];
  const float t = (py + j2) * f[kInvH];
  const float oxc = f[kCam + 0], oyc = f[kCam + 1], ozc = f[kCam + 2];
  dx = f[kCam + 9] + s * f[kCam + 3] - t * f[kCam + 6] - oxc;
  dy = f[kCam + 10] + s * f[kCam + 4] - t * f[kCam + 7] - oyc;
  dz = f[kCam + 11] + s * f[kCam + 5] - t * f[kCam + 8] - ozc;
  ox = 0.0f + oxc;
  oy = 0.0f + oyc;
  oz = 0.0f + ozc;
}

// The background's radiance along d.
__device__ __forceinline__ void background(const float* f, int bg_kind,
                                           float dx, float dy, float dz,
                                           float& r, float& g, float& b) {
  r = f[kBg + 0];
  g = f[kBg + 1];
  b = f[kBg + 2];
  if (bg_kind == kGradient) {
    const float norm = 1.0f / sqrtf(dot3(dx, dy, dz, dx, dy, dz));
    const float tt = 0.5f * (dy * norm + 1.0f);
    r = (1.0f - tt) * f[kBg + 0] + tt * f[kBg + 3];
    g = (1.0f - tt) * f[kBg + 1] + tt * f[kBg + 4];
    b = (1.0f - tt) * f[kBg + 2] + tt * f[kBg + 5];
  }
}

// An equirect sky map in device memory: (h, w, 3) float32 texels, row-major
// (models/backgrounds.Background.image), read whole by the lookup.
struct Sky {
  const float* img;
  int h, w;
};

constexpr float kPi = 3.14159274f;         // float32(pi)
constexpr float kInvPi = 0.318309873f;     // float32(1) / float32(pi)
constexpr float kInvTwoPi = 0.159154937f;  // float32(1) / float32(2 pi)

// The offset of the sky map's texel along d: its nearest texel, as
// models/backgrounds.Background.sample computes it on the card, operation
// for operation: d normalized by true division, theta = acos of -y clamped
// to [-1, 1], phi = atan2(-z, x) + float32(pi), both scaled by the float32
// reciprocals, floor(v w) wrapped to the width, floor(u h) wrapped to the
// height and flipped.  acosf and atan2f are the functions torch.acos and
// torch.atan2 call on the card.  The gather reads global memory: a 2K sky
// is 25 MB, inside the card's L2.
__device__ __forceinline__ size_t sky_texel(const Sky& sky, float dx,
                                            float dy, float dz) {
  const float len = sqrtf(dot3(dx, dy, dz, dx, dy, dz));
  const float nx = dx / len, ny = dy / len, nz = dz / len;
  const float theta = acosf(fminf(fmaxf(-ny, -1.0f), 1.0f));
  const float phi = atan2f(-nz, nx) + kPi;
  const float u = theta * kInvPi;
  const float v = phi * kInvTwoPi;
  int x = (int)floorf(v * (float)sky.w) % sky.w;
  int y = (int)floorf(u * (float)sky.h) % sky.h;
  x += x < 0 ? sky.w : 0;
  y += y < 0 ? sky.h : 0;
  return 3 * ((size_t)(sky.h - 1 - y) * sky.w + x);
}

// The sky map's radiance along d: its texel of sky_texel.
__device__ __forceinline__ void sky_radiance(const Sky& sky, float dx,
                                             float dy, float dz, float& r,
                                             float& g, float& b) {
  const float* t = sky.img + sky_texel(sky, dx, dy, dz);
  r = __ldg(t + 0);
  g = __ldg(t + 1);
  b = __ldg(t + 2);
}

// The unit-sphere-surface sample of the bounce's (u1, u2).
__device__ __forceinline__ void sphere_sample(float u1, float u2, float& sx,
                                              float& sy, float& sz) {
  const float zs = 1.0f - 2.0f * u1;
  const float rs = sqrtf(fmaxf(0.0f, 1.0f - zs * zs));
  const float phi = kTwoPi * u2;
  sx = rs * cosf(phi);
  sy = rs * sinf(phi);
  sz = zs;
}

// The cube root of a uniform, exp(log(max(u, 1e-38)) * (1/3)): the JAX
// package's cbrt01, which utils/rng.py computes with torch.log and
// torch.exp (logf and expf on the card) so the isotropic directions agree
// bit for bit.
__device__ __forceinline__ float cbrt01(float u) {
  return expf(logf(fmaxf(u, 1e-38f)) * (1.0f / 3.0f));
}

// The metal lobe: d reflected about the front-facing normal n, normalized,
// plus fuzz times the sphere sample s -> nd; true when nd leaves above the
// surface (the path goes on).
__device__ __forceinline__ bool metal_lobe(float fuzz, float dx, float dy,
                                           float dz, float nx, float ny,
                                           float nz, float sx, float sy,
                                           float sz, float& ndx, float& ndy,
                                           float& ndz) {
  const float dn = dot3(dx, dy, dz, nx, ny, nz);
  const float rfx = dx - 2.0f * dn * nx;
  const float rfy = dy - 2.0f * dn * ny;
  const float rfz = dz - 2.0f * dn * nz;
  const float inv_len =
      1.0f / sqrtf(fmaxf(dot3(rfx, rfy, rfz, rfx, rfy, rfz), 1e-30f));
  ndx = rfx * inv_len + fuzz * sx;
  ndy = rfy * inv_len + fuzz * sy;
  ndz = rfz * inv_len + fuzz * sz;
  return dot3(ndx, ndy, ndz, nx, ny, nz) > 0.0f;
}

// The dielectric's choice: true when it reflects (total internal reflection,
// or Schlick's reflectance above the coin).  Also gives the refraction
// ratio, the unit direction ud and cos_t, which its directions use.
__device__ __forceinline__ bool dielectric_reflects(
    float ir, bool front, float a, float dx, float dy, float dz, float nx,
    float ny, float nz, float u_coin, float& ratio, float& udx, float& udy,
    float& udz, float& cos_t) {
  ratio = front ? 1.0f / ir : ir;
  const float inv_len = 1.0f / sqrtf(fmaxf(a, 1e-30f));
  udx = dx * inv_len;
  udy = dy * inv_len;
  udz = dz * inv_len;
  cos_t = fminf(-dot3(nx, ny, nz, udx, udy, udz), 1.0f);
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  float r0 = (1.0f - ratio) / (1.0f + ratio);
  r0 = r0 * r0;
  const float omc = 1.0f - cos_t;
  const float omc2 = omc * omc;
  const float schl = r0 + (1.0f - r0) * omc2 * omc2 * omc;
  return ratio * sin_t > 1.0f || schl > u_coin;
}

// The lobe of a hit, shared by every intersect stage: the winner's material
// `mat` (albedo rgb, fuzz, ir, emission rgb) and `kind`, the ray d with
// a = d.d, the front-facing normal n and the bounce's uniforms -> the
// throughput factor `at`, the new direction nd, whether the path goes on,
// and the lobe's decisions added to `code`.  kIso: the isotropic lobe
// (lib/volume.rs:75-88), a point of the unit ball, the sphere sample times
// cbrt01(u_r), compiled in by the kernels whose scenes may have one.
template <bool kIso = false>
__device__ __forceinline__ void scatter(const float* mat, int kind, int clay,
                                        bool front, float a, float dx,
                                        float dy, float dz, float nx,
                                        float ny, float nz, float u1,
                                        float u2, float u_coin, float& at_r,
                                        float& at_g, float& at_b, float& ndx,
                                        float& ndy, float& ndz,
                                        bool& scatters, int& code,
                                        float u_r = 0.0f) {
  float sx, sy, sz;
  sphere_sample(u1, u2, sx, sy, sz);
  float ldx = nx + sx, ldy = ny + sy, ldz = nz + sz;
  if (fabsf(ldx) < 1e-8f && fabsf(ldy) < 1e-8f && fabsf(ldz) < 1e-8f) {
    ldx = nx;
    ldy = ny;
    ldz = nz;
  }

  at_r = at_g = at_b = 0.0f;
  ndx = nx;
  ndy = ny;
  ndz = nz;
  scatters = true;
  if (clay) {  // a gray Lambertian everywhere
    at_r = at_g = at_b = 0.8f;
    ndx = ldx;
    ndy = ldy;
    ndz = ldz;
  } else if (kind == kLambertian) {
    at_r = mat[0];
    at_g = mat[1];
    at_b = mat[2];
    ndx = ldx;
    ndy = ldy;
    ndz = ldz;
  } else if (kind == kMetal) {
    scatters = metal_lobe(mat[3], dx, dy, dz, nx, ny, nz, sx, sy, sz, ndx,
                          ndy, ndz);
    if (scatters) {
      at_r = mat[0];
      at_g = mat[1];
      at_b = mat[2];
      code |= kMetalOk;
    }
  } else if (kind == kDielectric) {
    float ratio, udx, udy, udz, cos_t;
    if (dielectric_reflects(mat[4], front, a, dx, dy, dz, nx, ny, nz, u_coin,
                            ratio, udx, udy, udz, cos_t)) {  // reflect
      const float udn = dot3(udx, udy, udz, nx, ny, nz);
      ndx = udx - 2.0f * udn * nx;
      ndy = udy - 2.0f * udn * ny;
      ndz = udz - 2.0f * udn * nz;
      code |= kReflect;
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
    at_r = mat[5];
    at_g = mat[6];
    at_b = mat[7];
    scatters = false;
  } else if (kIso && kind == kIsotropic) {
    const float crt = cbrt01(u_r);
    at_r = mat[0];
    at_g = mat[1];
    at_b = mat[2];
    ndx = sx * crt;
    ndy = sy * crt;
    ndz = sz * crt;
  }
}

// ---------------------------------------------------------------- triangles

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The determinant a = -n . d and num_t = n . o - v0 . n of triangle row g:
// _tri_intersect's matmul as XLA's float32 dot computes it on the CPU, a
// fused multiply-add a feature, in feature order (d, w, o, 1), each rounded
// once.  __fmaf_rn is fused whatever --fmad says.
__device__ __forceinline__ void tri_det_t(const float* g, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float& a, float& num_t) {
  const float4 q0 = ldg4(g);       // n, (v0 x e2).x
  const float4 q3 = ldg4(g + 12);  // e1, v0 . n
  a = __fmaf_rn(-q0.z, dz, __fmaf_rn(-q0.y, dy, __fmul_rn(-q0.x, dx)));
  num_t = __fadd_rn(
      __fmaf_rn(q0.z, oz, __fmaf_rn(q0.y, oy, __fmul_rn(q0.x, ox))), -q3.w);
}

// _tri_intersect's test of triangle row g against the ray (o, d) with
// w = o x d: a hit needs |a| > kTriDetEps, u, v >= 0, u + v <= 1 and
// t > T_MIN, with f = 1 / a, u = f num_u, v = f num_v, t = f num_t.  True,
// with `t`, when it hits below `bound` (so a tie keeps the earlier winner);
// num_u and num_v are computed only for such a t.
__device__ __forceinline__ bool tri_hit(const float* g, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float wx, float wy,
                                        float wz, float bound, float& t) {
  float a, num_t;
  tri_det_t(g, ox, oy, oz, dx, dy, dz, a, num_t);
  if (!(fabsf(a) > kTriDetEps)) return false;
  const float f = 1.0f / a;
  t = f * num_t;
  if (!(t > kTMin && t < bound)) return false;
  const float4 q0 = ldg4(g), q1 = ldg4(g + 4), q2 = ldg4(g + 8),
               q3 = ldg4(g + 12);
  // num_u = (v0 x e2) . d + e2 . w
  const float num_u = __fmaf_rn(
      q2.x, wz,
      __fmaf_rn(q1.w, wy,
                __fmaf_rn(q1.z, wx,
                          __fmaf_rn(q1.y, dz,
                                    __fmaf_rn(q1.x, dy,
                                              __fmul_rn(q0.w, dx))))));
  const float u = f * num_u;
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  // num_v = -(v0 x e1) . d - e1 . w
  const float num_v = __fmaf_rn(
      -q3.z, wz,
      __fmaf_rn(-q3.y, wy,
                __fmaf_rn(-q3.x, wx,
                          __fmaf_rn(-q2.w, dz,
                                    __fmaf_rn(-q2.z, dy,
                                              __fmul_rn(-q2.y, dx))))));
  const float v = f * num_v;
  return v >= 0.0f && u + v <= 1.0f;
}

// One ray's radiance.  With kRecord the bounces go to `tape` (the caller
// keeps max_depth <= kMaxTape); without it `tape` is unused, and the
// arithmetic is the same either way.  A thread stops at its own ray's end: a
// finished ray's state never changes, so this equals the TPU kernel's
// all-lanes chain.
//
// kExt: the bounce's columns shift by MAX_MIX_DEPTH = 4 with mixes (coin 0
// is the mix coin: u >= factor picks leaf A); a volume sphere's candidate
// is its boundary window's entry h1 = max(t1, T_MIN) plus the free flight
// -1/density * log(u) along the unit ray, drawn from column off + 4 + its
// ordinal, accepted inside the window; its hit shades with the normal
// (1, 0, 0) (lib/volume.rs:35-73); the isotropic lobe draws u_r, column
// off + 3.  kSky: an escaping ray adds its throughput times the sky's
// texel.  kTri: after the spheres every triangle is tested (tri_hit), and
// the closest replaces the sphere winner only with a strictly lower t (the
// lowest t, and among equal t the lowest index, as _tri_intersect's chunk
// minimum); its hit shades with the flat normal and its material slot's
// row, leaf A or under a mix the leaf its coin picks.
template <bool kRecord, bool kExt = false, bool kSky = false,
          bool kTri = false>
__device__ __forceinline__ void trace(const float* f, const int* kind_of,
                                      const Rows& rows, uint32_t k0,
                                      uint32_t k1, uint32_t rid, float px,
                                      float py, int max_depth, int bg_kind,
                                      int clay, const Sky& sky, float& rad_r,
                                      float& rad_g, float& rad_b,
                                      Tape* tape) {
  const int stride = kExt ? rows.stride : kStride;
  const int n_solid = kExt ? rows.n - rows.n_vol : rows.n;
  // the cipher word pair of [u1, u2]: columns off, off + 1
  const uint32_t jl = (kExt && rows.mix) ? 2u : 0u;
  float ox, oy, oz, dx, dy, dz;
  camera_ray(f, k0, k1, rid, px, py, ox, oy, oz, dx, dy, dz);
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  rad_r = 0.0f;
  rad_g = 0.0f;
  rad_b = 0.0f;
  if (kRecord) {
    tape->n = 0;
    tape->ended = false;
  }

  for (int b = 0; b < max_depth; ++b) {
    // bounce stream 1 + b: columns [u1, u2, coin, u_r] from off
    const uint32_t stream = 1u + (uint32_t)b;
    float u1, u2, u_coin, u_r;
    uniform_pair(k0, k1, rid, stream, jl, u1, u2);
    uniform_pair(k0, k1, rid, stream, jl + 1u, u_coin, u_r);
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv_a = 1.0f / a;
    const float ray_len = (kExt && rows.n_vol) ? sqrtf(a) : 0.0f;
    if (kRecord) {
      tape->b[b] = Bounce{ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b, kMiss};
      tape->n = b + 1;
    }

    // closest hit, direct quadratic; a tie keeps the lower index
    float t_best = INFINITY;
    int best = -1;
    bool root2 = false;
    for (int i = 0; i < rows.n; ++i) {
      const float* sp = f + kSpheres + i * stride;
      const float ocx = ox - sp[0], ocy = oy - sp[1], ocz = oz - sp[2];
      const float half_b = dot3(ocx, ocy, ocz, dx, dy, dz);
      const float cq = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - sp[3] * sp[3];
      const float disc = half_b * half_b - a * cq;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t1 = (-half_b - sq) * inv_a;
      const float t2 = (-half_b + sq) * inv_a;
      if (kExt && i >= n_solid) {  // a volume: window, then free flight
        float h1 = fmaxf(t1, kTMin);
        const float h2 = t2 >= t1 + kTMin ? t2 : INFINITY;
        if (disc >= 0.0f && h1 < h2) {
          h1 = fmaxf(h1, 0.0f);
          const float dist_inside = (h2 - h1) * ray_len;
          const float u_v = uniform_col(k0, k1, rid, stream,
                                        2u * jl + 4u + (uint32_t)(i - n_solid));
          const float hit_dist = sp[stride - 1] * logf(fmaxf(u_v, 1e-37f));
          const float ti = h1 + hit_dist / ray_len;
          if (hit_dist <= dist_inside && ti < t_best) {
            t_best = ti;
            best = i;
            root2 = false;
          }
        }
        continue;
      }
      const bool t1ok = t1 >= kTMin && t1 <= t_best;
      const bool t2ok = t2 >= kTMin && t2 <= t_best;
      const float ti = t1ok ? t1 : (t2ok ? t2 : INFINITY);
      if (disc >= 0.0f && ti < t_best) {
        t_best = ti;
        best = i;
        root2 = !t1ok;
      }
    }
    int tri_best = -1;
    if (kTri) {
      const float wx = oy * dz - oz * dy;
      const float wy = oz * dx - ox * dz;
      const float wz = ox * dy - oy * dx;
      for (int j = 0; j < rows.n_tri; ++j) {
        float tt;
        if (tri_hit(rows.tri + (size_t)j * kTriCols, ox, oy, oz, dx, dy, dz,
                    wx, wy, wz, t_best, tt)) {
          t_best = tt;
          tri_best = j;
        }
      }
    }

    if (best < 0 && tri_best < 0) {  // miss: the background ends the path
      float bg_r, bg_g, bg_b;
      if (kSky)
        sky_radiance(sky, dx, dy, dz, bg_r, bg_g, bg_b);
      else
        background(f, bg_kind, dx, dy, dz, bg_r, bg_g, bg_b);
      rad_r = rad_r + thr_r * bg_r;
      rad_g = rad_g + thr_g * bg_g;
      rad_b = rad_b + thr_b * bg_b;
      if (kRecord) tape->ended = true;
      break;
    }

    const float ptx = ox + t_best * dx;
    const float pty = oy + t_best * dy;
    const float ptz = oz + t_best * dz;
    float nx, ny, nz;
    const float* row;  // the winner's material row: leaf A, factor, leaf B
    int code, kinds;
    if (kTri && tri_best >= 0) {  // the flat normal, the slot's row
      const float* g = rows.tri + (size_t)tri_best * kTriCols;
      const float4 q4 = ldg4(g + kTriNrm);
      nx = q4.x;
      ny = q4.y;
      nz = q4.z;
      const int slot = (int)q4.w;
      row = f + kSpheres + rows.n * stride + slot * tri_stride(rows);
      code = tri_best | kTriHit;
      kinds = kind_of[rows.n + slot];
    } else {
      const float* sp = f + kSpheres + best * stride;
      const bool vol = kExt && best >= n_solid;
      const float inv_r = 1.0f / sp[3];
      nx = vol ? 1.0f : (ptx - sp[0]) * inv_r;
      ny = vol ? 0.0f : (pty - sp[1]) * inv_r;
      nz = vol ? 0.0f : (ptz - sp[2]) * inv_r;
      row = sp + kLeafA;
      code = best | (root2 ? kRoot2 : 0) | (vol ? kVolume : 0);
      kinds = kind_of[best];
    }
    const bool front = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    nx = nx * sgn;
    ny = ny * sgn;
    nz = nz * sgn;
    code |= front ? kFront : 0;
    const float* mat = row;
    if (kExt && rows.mix &&
        !(uniform_col(k0, k1, rid, stream, 0u) >= row[kRowFactor])) {
      mat = row + kRowLeafB;
      code |= kPickB;
    }
    const int kind = kExt ? kind_at(kinds, code) : kinds;

    float at_r, at_g, at_b, ndx, ndy, ndz;
    bool scatters;
    scatter<kExt>(mat, kind, clay, front, a, dx, dy, dz, nx, ny, nz, u1, u2,
                  u_coin, at_r, at_g, at_b, ndx, ndy, ndz, scatters, code,
                  u_r);
    if (kRecord) tape->b[b].code = code;

    if (!scatters) {  // absorbed or emitted: the path ends
      rad_r = rad_r + thr_r * at_r;
      rad_g = rad_g + thr_g * at_g;
      rad_b = rad_b + thr_b * at_b;
      if (kRecord) tape->ended = true;
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
}

// ---------------------------------------------------------------- adjoint

// The offset in fparams of a recorded winner's material row (from its leaf
// A on: the factor and leaf B follow), and its kinds.
template <bool kTri>
__device__ __forceinline__ int row_at(const Rows& rows, int stride, int code,
                                      const int* kind_of, int& kinds) {
  const int w = code & kWinner;
  if (kTri && (code & kTriHit)) {
    const int slot =
        (int)__ldg(rows.tri + (size_t)w * kTriCols + kTriSlot);
    kinds = kind_of[rows.n + slot];
    return kSpheres + rows.n * stride + slot * tri_stride(rows);
  }
  kinds = kind_of[w];
  return kSpheres + w * stride + kLeafA;
}

// Adds d(loss)/d(fparams) of one recorded ray, given g = d(loss)/d(radiance).
// The head entries (camera, background, pixel scale: fparams 0..19) add into
// `head`, which the caller keeps in registers; the winning spheres' entries
// add into the block's `gs` (shared memory, `stride` floats per sphere) with
// atomics; under kSky the looked-up texel's entries add into `gsky` (device
// memory, (h, w, 3) floats) with atomics.
//
// The radiance of a path that ends at bounce B is thr_B * L_B, where L_B is
// the background (a miss) or the winner's emission (Metal below the surface
// gives 0), and thr_{b+1} = thr_b * at_b.  The sweep runs b = B .. 0 with the
// adjoints of the state entering bounce b + 1: origin (= hit point p_b),
// direction (= the lobe's new direction) and throughput.
//
// kExt: the cotangents of a hit's material go to the leaf its mix coin
// picked (the factor gets none: the coin is a comparison).  A volume's hit
// t = h1 + hit_dist / |d| runs back through |d|, through -1/density
// (hit_dist = -1/density * log u) and, while the ray starts outside the
// sphere (t1 >= T_MIN), through its entry t1 = (-half_b - sq) / a into
// origin, direction, center and radius; its normal is a constant.  The
// isotropic lobe's throughput factor is the albedo and its direction
// depends on no parameter.  kSky: a miss's L_B is the texel, constant in d
// (the lookup is piecewise constant); g * thr goes to the texel.  kTri: a
// triangle's t = num_t / a (recomputed as the forward computed it) runs
// back into origin and direction, dt/do = n / a and dt/dd = -t n / a with
// n = e1 x e2 and a = -n . d; its flat normal is a constant and its
// vertices get no cotangent (they are not trained); its material's
// cotangents go to its slot's row, the leaf its coin picked.
template <bool kExt = false, bool kSky = false, bool kTri = false>
__device__ __forceinline__ void adjoint(const float* f, const int* kind_of,
                                        const Rows& rows, uint32_t k0,
                                        uint32_t k1, uint32_t rid, float px,
                                        float py, int bg_kind, int clay,
                                        const Sky& sky, const Tape& tape,
                                        float gr, float gg, float gb,
                                        float (&head)[kHead], float* gs,
                                        float* gsky) {
  if (!tape.ended) return;  // outlived max_depth: radiance 0 everywhere
  const int stride = kExt ? rows.stride : kStride;
  const int n_solid = kExt ? rows.n - rows.n_vol : rows.n;
  const uint32_t jl = (kExt && rows.mix) ? 2u : 0u;
  int b = tape.n - 1;
  float gox = 0.0f, goy = 0.0f, goz = 0.0f;
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;  // L_B
  {
    const Bounce& e = tape.b[b];
    const float glr = gr * e.tr, glg = gg * e.tg, glb = gb * e.tb;
    const int w = e.code & kWinner;
    if (w == kMiss && kSky) {
      const size_t t = sky_texel(sky, e.dx, e.dy, e.dz);
      lr = __ldg(sky.img + t + 0);
      lg = __ldg(sky.img + t + 1);
      lb = __ldg(sky.img + t + 2);
      atomicAdd(gsky + t + 0, glr);
      atomicAdd(gsky + t + 1, glg);
      atomicAdd(gsky + t + 2, glb);
    } else if (w == kMiss) {
      const float* ca = f + kBg;
      const float* cb = f + kBg + 3;
      if (bg_kind == kGradient) {
        const float norm =
            1.0f / sqrtf(dot3(e.dx, e.dy, e.dz, e.dx, e.dy, e.dz));
        const float tt = 0.5f * (e.dy * norm + 1.0f);
        lr = (1.0f - tt) * ca[0] + tt * cb[0];
        lg = (1.0f - tt) * ca[1] + tt * cb[1];
        lb = (1.0f - tt) * ca[2] + tt * cb[2];
        head[kBg + 0] += (1.0f - tt) * glr;
        head[kBg + 1] += (1.0f - tt) * glg;
        head[kBg + 2] += (1.0f - tt) * glb;
        head[kBg + 3] += tt * glr;
        head[kBg + 4] += tt * glg;
        head[kBg + 5] += tt * glb;
        const float gtt = glr * (cb[0] - ca[0]) + glg * (cb[1] - ca[1]) +
                          glb * (cb[2] - ca[2]);
        // tt = 0.5 (dy norm + 1), norm = (d.d)^(-1/2)
        const float gnorm = 0.5f * gtt * e.dy;
        gdy += 0.5f * gtt * norm;
        const float gdd = -0.5f * gnorm * norm * norm * norm;
        gdx += 2.0f * gdd * e.dx;
        gdy += 2.0f * gdd * e.dy;
        gdz += 2.0f * gdd * e.dz;
      } else {
        lr = ca[0];
        lg = ca[1];
        lb = ca[2];
        head[kBg + 0] += glr;
        head[kBg + 1] += glg;
        head[kBg + 2] += glb;
      }
    } else if (!clay) {
      int kinds;
      const int off = row_at<kTri>(rows, stride, e.code, kind_of, kinds);
      if ((kExt ? kind_at(kinds, e.code) : kinds) == kEmission) {
        const int mo = (kExt && (e.code & kPickB)) ? kRowLeafB : 0;
        const float* mat = f + off + mo;
        float* gmat = gs + (off - kHead) + mo;
        lr = mat[5];
        lg = mat[6];
        lb = mat[7];
        atomicAdd(gmat + 5, glr);
        atomicAdd(gmat + 6, glg);
        atomicAdd(gmat + 7, glb);
      }
    }  // else Metal below the surface: L = 0, constant
  }
  float gtr = gr * lr, gtg = gg * lg, gtb = gb * lb;

  for (--b; b >= 0; --b) {  // bounce b scattered
    const Bounce& e = tape.b[b];
    const int w = e.code & kWinner;
    const bool tri = kTri && (e.code & kTriHit);
    int kinds;
    const int off = row_at<kTri>(rows, stride, e.code, kind_of, kinds);
    const int mo = (kExt && (e.code & kPickB)) ? kRowLeafB : 0;
    const float* mat = f + off + mo;
    float* gmat = gs + (off - kHead) + mo;
    const bool vol = kExt && (e.code & kVolume);
    const float ox = e.ox, oy = e.oy, oz = e.oz;
    const float dx = e.dx, dy = e.dy, dz = e.dz;
    // adjoints of its outputs: hit point, new direction
    const float gpx0 = gox, gpy0 = goy, gpz0 = goz;
    const float gndx = gdx, gndy = gdy, gndz = gdz;

    // ---- recompute the bounce
    const uint32_t stream = 1u + (uint32_t)b;
    float u1, u2;
    uniform_pair(k0, k1, rid, stream, jl, u1, u2);
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float sgn = (e.code & kFront) ? 1.0f : -1.0f;
    float t, nx, ny, nz;
    // a sphere's: the root and the normal's inputs
    float inv_a = 0.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f, r = 1.0f;
    float ocx = 0.0f, ocy = 0.0f, ocz = 0.0f, half_b = 0.0f, cq = 0.0f;
    float sq = 0.0f, num = 0.0f, inv_r = 1.0f, qx = 0.0f, qy = 0.0f,
          qz = 0.0f;
    bool root2 = false, entry = false;
    float ray_len = 1.0f, hit_dist = 0.0f, log_u = 0.0f;
    // a triangle's: t = num_t * (1 / det)
    const float* g = nullptr;
    float det = 1.0f, num_t = 0.0f, inv_det = 1.0f;
    if (tri) {
      g = rows.tri + (size_t)w * kTriCols;
      tri_det_t(g, ox, oy, oz, dx, dy, dz, det, num_t);
      inv_det = 1.0f / det;
      t = inv_det * num_t;
      const float4 q4 = ldg4(g + kTriNrm);
      nx = q4.x * sgn;
      ny = q4.y * sgn;
      nz = q4.z * sgn;
    } else {
      const float* sp = f + kSpheres + w * stride;
      inv_a = 1.0f / a;
      cx = sp[0];
      cy = sp[1];
      cz = sp[2];
      r = sp[3];
      ocx = ox - cx;
      ocy = oy - cy;
      ocz = oz - cz;
      half_b = dot3(ocx, ocy, ocz, dx, dy, dz);
      cq = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
      const float disc = half_b * half_b - a * cq;
      sq = sqrtf(fmaxf(disc, 0.0f));
      root2 = (e.code & kRoot2) != 0;
      num = root2 ? (-half_b + sq) : (-half_b - sq);
      t = num * inv_a;
      // a volume's hit: t = h1 + hit_dist / ray_len
      entry = t >= kTMin;  // the window opens at t1 (volumes)
      if (vol) {
        ray_len = sqrtf(a);
        log_u = logf(fmaxf(uniform_col(k0, k1, rid, stream,
                                       2u * jl + 4u + (uint32_t)(w - n_solid)),
                           1e-37f));
        hit_dist = sp[stride - 1] * log_u;
        t = fmaxf(fmaxf(t, kTMin), 0.0f) + hit_dist / ray_len;
      }
      inv_r = 1.0f / r;
      const float ptx = ox + t * dx, pty = oy + t * dy, ptz = oz + t * dz;
      qx = ptx - cx;
      qy = pty - cy;
      qz = ptz - cz;
      nx = vol ? sgn : qx * inv_r * sgn;
      ny = vol ? 0.0f * sgn : qy * inv_r * sgn;
      nz = vol ? 0.0f * sgn : qz * inv_r * sgn;
    }

    // ---- the lobe: adjoints of n, d, a; throughput factor at
    float gnx = 0.0f, gny = 0.0f, gnz = 0.0f;
    float g_dx = 0.0f, g_dy = 0.0f, g_dz = 0.0f, ga = 0.0f;
    float atr = 1.0f, atg = 1.0f, atb = 1.0f;
    const int kind = clay ? kLambertian
                          : (kExt ? kind_at(kinds, e.code) : kinds);
    if (clay) {  // at = 0.8, d' = n + s (or n)
      atr = atg = atb = 0.8f;
      gnx = gndx;
      gny = gndy;
      gnz = gndz;
    } else if (kind == kLambertian) {  // at = albedo, d' = n + s (or n)
      atr = mat[0];
      atg = mat[1];
      atb = mat[2];
      gnx = gndx;
      gny = gndy;
      gnz = gndz;
    } else if (kExt && kind == kIsotropic) {  // at = albedo, d' = s cbrt(u)
      atr = mat[0];
      atg = mat[1];
      atb = mat[2];
    } else if (kind == kMetal) {  // above the surface: at = albedo
      atr = mat[0];
      atg = mat[1];
      atb = mat[2];
      float sx, sy, sz;
      sphere_sample(u1, u2, sx, sy, sz);
      const float dn = dot3(dx, dy, dz, nx, ny, nz);
      const float rfx = dx - 2.0f * dn * nx;
      const float rfy = dy - 2.0f * dn * ny;
      const float rfz = dz - 2.0f * dn * nz;
      const float ll = dot3(rfx, rfy, rfz, rfx, rfy, rfz);
      const float inv_len = 1.0f / sqrtf(fmaxf(ll, 1e-30f));
      // d' = rf * inv_len + fuzz * s
      atomicAdd(gmat + 3, dot3(gndx, gndy, gndz, sx, sy, sz));
      float grfx = gndx * inv_len, grfy = gndy * inv_len,
            grfz = gndz * inv_len;
      const float ginv = dot3(gndx, gndy, gndz, rfx, rfy, rfz);
      const float gll =
          ll >= 1e-30f ? -0.5f * ginv * inv_len * inv_len * inv_len : 0.0f;
      grfx += 2.0f * gll * rfx;
      grfy += 2.0f * gll * rfy;
      grfz += 2.0f * gll * rfz;
      // rf = d - 2 (d.n) n
      const float gdn = -2.0f * dot3(grfx, grfy, grfz, nx, ny, nz);
      g_dx = grfx + gdn * nx;
      g_dy = grfy + gdn * ny;
      g_dz = grfz + gdn * nz;
      gnx = -2.0f * dn * grfx + gdn * dx;
      gny = -2.0f * dn * grfy + gdn * dy;
      gnz = -2.0f * dn * grfz + gdn * dz;
    } else {  // Dielectric: at = 1
      const float ir = mat[4];
      const bool front = (e.code & kFront) != 0;
      const float ratio = front ? 1.0f / ir : ir;
      const float inv_len = 1.0f / sqrtf(fmaxf(a, 1e-30f));
      const float udx = dx * inv_len, udy = dy * inv_len, udz = dz * inv_len;
      const float xc = -dot3(nx, ny, nz, udx, udy, udz);
      const float cos_t = fminf(xc, 1.0f);
      float gudx = 0.0f, gudy = 0.0f, gudz = 0.0f, gcos = 0.0f;
      if (e.code & kReflect) {  // d' = ud - 2 (ud.n) n
        const float udn = dot3(udx, udy, udz, nx, ny, nz);
        const float gudn = -2.0f * dot3(gndx, gndy, gndz, nx, ny, nz);
        gudx = gndx + gudn * nx;
        gudy = gndy + gudn * ny;
        gudz = gndz + gudn * nz;
        gnx = -2.0f * udn * gndx + gudn * udx;
        gny = -2.0f * udn * gndy + gudn * udy;
        gnz = -2.0f * udn * gndz + gudn * udz;
      } else {  // d' = perp + par n
        const float wx = udx + cos_t * nx, wy = udy + cos_t * ny,
                    wz = udz + cos_t * nz;
        const float perp_x = ratio * wx, perp_y = ratio * wy,
                    perp_z = ratio * wz;
        const float q =
            fabsf(1.0f - dot3(perp_x, perp_y, perp_z, perp_x, perp_y, perp_z));
        const float sqq = sqrtf(fmaxf(q, 1e-12f));
        const float par = -sqq;
        float gpx = gndx, gpy = gndy, gpz = gndz;
        const float gpar = dot3(gndx, gndy, gndz, nx, ny, nz);
        gnx = par * gndx;
        gny = par * gndy;
        gnz = par * gndz;
        // par = -sqrt(max(|1 - perp.perp|, 1e-12))
        const float gq = q >= 1e-12f ? -0.5f * gpar / sqq : 0.0f;
        const float om = 1.0f - dot3(perp_x, perp_y, perp_z, perp_x, perp_y,
                                     perp_z);
        const float gpp = om > 0.0f ? -gq : (om < 0.0f ? gq : 0.0f);
        gpx += 2.0f * gpp * perp_x;
        gpy += 2.0f * gpp * perp_y;
        gpz += 2.0f * gpp * perp_z;
        // perp = ratio (ud + cos_t n)
        const float gratio = dot3(gpx, gpy, gpz, wx, wy, wz);
        const float gwx = ratio * gpx, gwy = ratio * gpy, gwz = ratio * gpz;
        gudx = gwx;
        gudy = gwy;
        gudz = gwz;
        gcos = dot3(gwx, gwy, gwz, nx, ny, nz);
        gnx += cos_t * gwx;
        gny += cos_t * gwy;
        gnz += cos_t * gwz;
        atomicAdd(gmat + 4, front ? -gratio * ratio * ratio : gratio);
      }
      // cos_t = min(-(n . ud), 1)
      if (xc <= 1.0f) {
        gnx -= gcos * udx;
        gny -= gcos * udy;
        gnz -= gcos * udz;
        gudx -= gcos * nx;
        gudy -= gcos * ny;
        gudz -= gcos * nz;
      }
      // ud = d * inv_len, inv_len = max(a, 1e-30)^(-1/2)
      g_dx = gudx * inv_len;
      g_dy = gudy * inv_len;
      g_dz = gudz * inv_len;
      const float ginv = dot3(gudx, gudy, gudz, dx, dy, dz);
      ga = a >= 1e-30f ? -0.5f * ginv * inv_len * inv_len * inv_len : 0.0f;
    }

    // ---- throughput: thr' = thr * at
    if (!clay && (kind == kLambertian || kind == kMetal ||
                  (kExt && kind == kIsotropic))) {
      atomicAdd(gmat + 0, gtr * e.tr);
      atomicAdd(gmat + 1, gtg * e.tg);
      atomicAdd(gmat + 2, gtb * e.tb);
    }
    gtr = gtr * atr;
    gtg = gtg * atg;
    gtb = gtb * atb;

    // ---- normal n = sgn (p - c) / r (a volume's and a triangle's are
    // constant), hit point p = o + t d
    float gcx = 0.0f, gcy = 0.0f, gcz = 0.0f, grad_r = 0.0f;
    float gpx = gpx0, gpy = gpy0, gpz = gpz0;
    if (!vol && !tri) {
      const float gqx = sgn * gnx * inv_r, gqy = sgn * gny * inv_r,
                  gqz = sgn * gnz * inv_r;
      const float ginv_r = sgn * dot3(gnx, gny, gnz, qx, qy, qz);
      gcx = -gqx;
      gcy = -gqy;
      gcz = -gqz;
      grad_r = -ginv_r * inv_r * inv_r;
      gpx = gpx0 + gqx;
      gpy = gpy0 + gqy;
      gpz = gpz0 + gqz;
    }
    float gx = gpx, gy = gpy, gz = gpz;  // origin
    g_dx += t * gpx;
    g_dy += t * gpy;
    g_dz += t * gpz;
    float gt = dot3(gpx, gpy, gpz, dx, dy, dz);

    if (tri) {
      // t = num_t / det: num_t = n . o - v0 . n, det = -n . d
      const float4 q0 = ldg4(g);
      const float gnum_t = gt * inv_det;
      const float gdet = -(gt * num_t) * inv_det * inv_det;
      gx += gnum_t * q0.x;
      gy += gnum_t * q0.y;
      gz += gnum_t * q0.z;
      g_dx += 2.0f * ga * dx - gdet * q0.x;
      g_dy += 2.0f * ga * dy - gdet * q0.y;
      g_dz += 2.0f * ga * dz - gdet * q0.z;
      gox = gx;
      goy = gy;
      goz = gz;
      gdx = g_dx;
      gdy = g_dy;
      gdz = g_dz;
      continue;
    }
    float* gsp = gs + w * stride;
    if (vol) {
      // t = max(t1, T_MIN) + hit_dist / ray_len, ray_len = sqrt(a)
      const float ghd = gt / ray_len;
      atomicAdd(gsp + stride - 1, ghd * log_u);
      ga += 0.5f * (-ghd * hit_dist / ray_len) / ray_len;
      if (!entry) gt = 0.0f;  // the ray starts inside: h1 = T_MIN
    }

    // ---- the root t = (-half_b -+ sq) / a
    const float gnum = gt * inv_a;
    const float ginv_a = gt * num;
    float ghb = -gnum;
    const float gsq = root2 ? gnum : -gnum;
    const float gdisc = sq > 0.0f ? 0.5f * gsq / sq : 0.0f;
    ghb += 2.0f * half_b * gdisc;
    ga += -cq * gdisc - ginv_a * inv_a * inv_a;
    const float gcq = -a * gdisc;
    const float gocx = 2.0f * gcq * ocx + ghb * dx;
    const float gocy = 2.0f * gcq * ocy + ghb * dy;
    const float gocz = 2.0f * gcq * ocz + ghb * dz;
    grad_r += -2.0f * gcq * r;
    g_dx += ghb * ocx + 2.0f * ga * dx;
    g_dy += ghb * ocy + 2.0f * ga * dy;
    g_dz += ghb * ocz + 2.0f * ga * dz;
    gx += gocx;
    gy += gocy;
    gz += gocz;
    gcx -= gocx;
    gcy -= gocy;
    gcz -= gocz;
    atomicAdd(gsp + 0, gcx);
    atomicAdd(gsp + 1, gcy);
    atomicAdd(gsp + 2, gcz);
    atomicAdd(gsp + 3, grad_r);
    gox = gx;
    goy = gy;
    goz = gz;
    gdx = g_dx;
    gdy = g_dy;
    gdz = g_dz;
  }

  // ---- the camera ray: o = origin, d = ll + s h - t v - origin
  float j1, j2;
  uniform_pair(k0, k1, rid, 0u, 0u, j1, j2);
  const float s = (px + j1) * f[kInvW];
  const float t = (py + j2) * f[kInvH];
  head[kCam + 0] += gox - gdx;
  head[kCam + 1] += goy - gdy;
  head[kCam + 2] += goz - gdz;
  head[kCam + 3] += s * gdx;
  head[kCam + 4] += s * gdy;
  head[kCam + 5] += s * gdz;
  head[kCam + 6] -= t * gdx;
  head[kCam + 7] -= t * gdy;
  head[kCam + 8] -= t * gdz;
  head[kCam + 9] += gdx;
  head[kCam + 10] += gdy;
  head[kCam + 11] += gdz;
  head[kInvW] += (px + j1) * dot3(gdx, gdy, gdz, f[kCam + 3], f[kCam + 4],
                                  f[kCam + 5]);
  head[kInvH] -= (py + j2) * dot3(gdx, gdy, gdz, f[kCam + 6], f[kCam + 7],
                                  f[kCam + 8]);
}

// ---------------------------------------------------------------- sums

// Shared memory of a gradient block: the scene, and the block's sums (rows
// of at most kMaxStride floats under kExt; under kTri the triangles'
// material slots after them, rows of at most kTriStrideMix floats).
template <bool kExt, bool kTri = false>
struct GradShared {
  static constexpr int kRow = kExt ? kMaxStride : kStride;
  static constexpr int kMats = kTri ? kMaxTriMats : 0;
  static constexpr int kMatRow = kExt ? kTriStrideMix : kTriStride;
  float f[kSpheres + kMaxSpheres * kRow + kMats * kMatRow];
  int kind_of[kMaxSpheres + kMats];
  // entries of d/d(fparams) past the head: spheres', then slots'
  float gs[kMaxSpheres * kRow + kMats * kMatRow];
  float ghead[kHead + 1];  // head entries, then one extra sum
};

template <bool kExt, bool kTri>
__device__ __forceinline__ void load_scene(GradShared<kExt, kTri>& sh,
                                           const float* fparams,
                                           const int* kinds,
                                           const Rows& rows) {
  const int n_f = scene_floats(rows);
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) sh.f[i] = fparams[i];
  for (int i = threadIdx.x; i < rows.n + rows.n_tm; i += blockDim.x)
    sh.kind_of[i] = kinds[i];
  for (int i = threadIdx.x; i < n_f - kHead; i += blockDim.x) sh.gs[i] = 0.0f;
  for (int i = threadIdx.x; i <= kHead; i += blockDim.x) sh.ghead[i] = 0.0f;
  __syncthreads();
}

// Every thread of the block calls this once, at its end: the head entries and
// `extra` are summed over each warp with shuffles, then over the block in
// shared memory; the block's n_out sums (head, spheres and slots, then
// extra when n_out = scene_floats + 1) go to row blockIdx.x of `partials`.
template <bool kExt, bool kTri>
__device__ __forceinline__ void write_partials(GradShared<kExt, kTri>& sh,
                                               float (&head)[kHead],
                                               float extra, const Rows& rows,
                                               int n_out, float* partials) {
#pragma unroll
  for (int k = 0; k <= kHead; ++k) {
    float v = k < kHead ? head[k] : extra;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&sh.ghead[k], v);
  }
  __syncthreads();
  const int k_sph = scene_floats(rows);
  float* row = partials + (size_t)blockIdx.x * n_out;
  for (int k = threadIdx.x; k < n_out; k += blockDim.x)
    row[k] = k < kHead ? sh.ghead[k]
             : k < k_sph ? sh.gs[k - kHead] : sh.ghead[kHead];
}

// The row stride of a scene (ops/megakernel.py sphere_stride).
inline int row_stride(int mix, int n_vol) {
  return (mix ? kStrideMix : kStride) + (n_vol > 0 ? 1 : 0);
}

// The run-time flags of a launch are consistent: the extended variant for
// mixes and volumes, volumes among the spheres, triangles (16-byte aligned
// rows) with their material slots and only then, at least one primitive.
inline bool rows_ok(int n_spheres, int ext, int mix, int n_vol,
                    const float* tri, int n_tri, int n_tm) {
  return n_spheres >= 0 && n_spheres <= kMaxSpheres && n_vol >= 0 &&
         n_vol <= n_spheres && (ext || (!mix && n_vol == 0)) && n_tri >= 0 &&
         n_tri <= kMaxTris && n_tm >= 0 && n_tm <= kMaxTriMats &&
         (n_tri > 0) == (n_tm > 0) && (n_tri > 0) == (tri != nullptr) &&
         ((uintptr_t)tri & 15) == 0 && n_spheres + n_tri > 0;
}

// A launch's rows.
inline Rows make_rows(int n_spheres, int mix, int n_vol, const float* tri,
                      int n_tri, int n_tm) {
  return Rows{n_spheres, row_stride(mix, n_vol), mix, n_vol, tri, n_tri,
              n_tm};
}

// out[k] = sum over the n_blocks rows of partials[., k], in row order;
// the last entry is divided by `last_div` when it is not 0.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                       int n_out, float last_div, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_out) return;
  float acc = 0.0f;
  for (int i = 0; i < n_blocks; ++i) acc += partials[(size_t)i * n_out + k];
  if (k == n_out - 1 && last_div != 0.0f) acc = acc / last_div;
  out[k] = acc;
}

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// A template flag as a value: with_flags(a, b, c, f) calls
// f(Flag<a>{}, Flag<b>{}, Flag<c>{}), so an entry names its kernel's
// launch once and reads the variant as decltype(x)::value; what each flag
// means is the caller's (#1 and #3 pass kExt, kSky, kTri).
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <class F>
inline auto with_flags(bool a, bool b, F f) {
  if (a)
    return b ? f(Flag<true>{}, Flag<true>{}) : f(Flag<true>{}, Flag<false>{});
  return b ? f(Flag<false>{}, Flag<true>{}) : f(Flag<false>{}, Flag<false>{});
}

template <class F>
inline auto with_flags(bool a, bool b, bool c, F f) {
  if (c)
    return with_flags(a, b,
                      [&](auto x, auto y) { return f(x, y, Flag<true>{}); });
  return with_flags(a, b,
                    [&](auto x, auto y) { return f(x, y, Flag<false>{}); });
}

}  // namespace rtrt
