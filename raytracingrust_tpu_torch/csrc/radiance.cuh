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
// _radiance_math for the envelope of ops/megakernel.py.  The adjoint is the
// reverse of that chain with its discrete decisions (winner, root, front
// face, metal-above-surface, dielectric reflect) held fixed, which is what
// jax.vjp of _radiance_math and autograd of the plain PyTorch version compute
// where they are finite.  Spheres a ray misses contribute nothing: unlike
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
constexpr int kHead = kSpheres;
constexpr int kMaxFloats = kSpheres + kMaxSpheres * kStride;
constexpr uint32_t kCipherBlock = 256;
constexpr float kTMin = 1e-5f;
constexpr float kTwoPi = 6.28318548202514648f;  // 2 * float32(pi)
// bounces a recording trace can hold: the JAX fit path's depth gate
// (pallas_megakernel.UNROLL_MAX_DEPTH)
constexpr int kMaxTape = 12;

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

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// ---------------------------------------------------------------- the tape

// Bounce::code: the winning sphere in bits 0-7 (kMiss when none), then the
// bounce's discrete decisions.
constexpr int kWinner = 0xff;
constexpr int kMiss = 0xff;
constexpr int kRoot2 = 1 << 8;     // the far root of the quadratic won
constexpr int kFront = 1 << 9;     // the ray hit the outside
constexpr int kMetalOk = 1 << 10;  // the metal lobe left above the surface
constexpr int kReflect = 1 << 11;  // the dielectric reflected

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
// and the lobe's decisions added to `code`.
__device__ __forceinline__ void scatter(const float* mat, int kind, int clay,
                                        bool front, float a, float dx,
                                        float dy, float dz, float nx,
                                        float ny, float nz, float u1,
                                        float u2, float u_coin, float& at_r,
                                        float& at_g, float& at_b, float& ndx,
                                        float& ndy, float& ndz,
                                        bool& scatters, int& code) {
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
  }
}

// One ray's radiance.  With kRecord the bounces go to `tape` (the caller
// keeps max_depth <= kMaxTape); without it `tape` is unused, and the
// arithmetic is the same either way.  A thread stops at its own ray's end: a
// finished ray's state never changes, so this equals the TPU kernel's
// all-lanes chain.
template <bool kRecord>
__device__ __forceinline__ void trace(const float* f, const int* kind_of,
                                      int n_spheres, uint32_t k0, uint32_t k1,
                                      uint32_t rid, float px, float py,
                                      int max_depth, int bg_kind, int clay,
                                      float& rad_r, float& rad_g,
                                      float& rad_b, Tape* tape) {
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
    // bounce stream 1 + b: columns [u1, u2, coin]
    float u1, u2, u_coin, u_spare;
    uniform_pair(k0, k1, rid, 1u + (uint32_t)b, 0u, u1, u2);
    uniform_pair(k0, k1, rid, 1u + (uint32_t)b, 1u, u_coin, u_spare);
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv_a = 1.0f / a;
    if (kRecord) {
      tape->b[b] = Bounce{ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b, kMiss};
      tape->n = b + 1;
    }

    // closest hit, direct quadratic; a tie keeps the lower index
    float t_best = INFINITY;
    int best = -1;
    bool root2 = false;
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
        root2 = !t1ok;
      }
    }

    if (best < 0) {  // miss: the background ends the path
      float bg_r, bg_g, bg_b;
      background(f, bg_kind, dx, dy, dz, bg_r, bg_g, bg_b);
      rad_r = rad_r + thr_r * bg_r;
      rad_g = rad_g + thr_g * bg_g;
      rad_b = rad_b + thr_b * bg_b;
      if (kRecord) tape->ended = true;
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
    int code = best | (root2 ? kRoot2 : 0) | (front ? kFront : 0);

    float at_r, at_g, at_b, ndx, ndy, ndz;
    bool scatters;
    scatter(sp + 4, kind_of[best], clay, front, a, dx, dy, dz, nx, ny, nz,
            u1, u2, u_coin, at_r, at_g, at_b, ndx, ndy, ndz, scatters, code);
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

// Adds d(loss)/d(fparams) of one recorded ray, given g = d(loss)/d(radiance).
// The head entries (camera, background, pixel scale: fparams 0..19) add into
// `head`, which the caller keeps in registers; the winning spheres' entries
// add into the block's `gs` (shared memory, kStride floats per sphere) with
// atomics.
//
// The radiance of a path that ends at bounce B is thr_B * L_B, where L_B is
// the background (a miss) or the winner's emission (Metal below the surface
// gives 0), and thr_{b+1} = thr_b * at_b.  The sweep runs b = B .. 0 with the
// adjoints of the state entering bounce b + 1: origin (= hit point p_b),
// direction (= the lobe's new direction) and throughput.
__device__ __forceinline__ void adjoint(const float* f, const int* kind_of,
                                        uint32_t k0, uint32_t k1,
                                        uint32_t rid, float px, float py,
                                        int bg_kind, int clay,
                                        const Tape& tape, float gr, float gg,
                                        float gb, float (&head)[kHead],
                                        float* gs) {
  if (!tape.ended) return;  // outlived max_depth: radiance 0 everywhere
  int b = tape.n - 1;
  float gox = 0.0f, goy = 0.0f, goz = 0.0f;
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;  // L_B
  {
    const Bounce& e = tape.b[b];
    const float glr = gr * e.tr, glg = gg * e.tg, glb = gb * e.tb;
    const int w = e.code & kWinner;
    if (w == kMiss) {
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
    } else if (!clay && kind_of[w] == kEmission) {
      const float* sp = f + kSpheres + w * kStride;
      lr = sp[9];
      lg = sp[10];
      lb = sp[11];
      atomicAdd(gs + w * kStride + 9, glr);
      atomicAdd(gs + w * kStride + 10, glg);
      atomicAdd(gs + w * kStride + 11, glb);
    }  // else Metal below the surface: L = 0, constant
  }
  float gtr = gr * lr, gtg = gg * lg, gtb = gb * lb;

  for (--b; b >= 0; --b) {  // bounce b scattered
    const Bounce& e = tape.b[b];
    const int w = e.code & kWinner;
    const float* sp = f + kSpheres + w * kStride;
    float* gsp = gs + w * kStride;
    const float ox = e.ox, oy = e.oy, oz = e.oz;
    const float dx = e.dx, dy = e.dy, dz = e.dz;
    // adjoints of its outputs: hit point, new direction
    const float gpx0 = gox, gpy0 = goy, gpz0 = goz;
    const float gndx = gdx, gndy = gdy, gndz = gdz;

    // ---- recompute the bounce
    float u1, u2;
    uniform_pair(k0, k1, rid, 1u + (uint32_t)b, 0u, u1, u2);
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv_a = 1.0f / a;
    const float cx = sp[0], cy = sp[1], cz = sp[2], r = sp[3];
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float half_b = dot3(ocx, ocy, ocz, dx, dy, dz);
    const float cq = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
    const float disc = half_b * half_b - a * cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const bool root2 = (e.code & kRoot2) != 0;
    const float num = root2 ? (-half_b + sq) : (-half_b - sq);
    const float t = num * inv_a;
    const float inv_r = 1.0f / r;
    const float ptx = ox + t * dx, pty = oy + t * dy, ptz = oz + t * dz;
    const float qx = ptx - cx, qy = pty - cy, qz = ptz - cz;
    const float sgn = (e.code & kFront) ? 1.0f : -1.0f;
    const float nx = qx * inv_r * sgn, ny = qy * inv_r * sgn,
                nz = qz * inv_r * sgn;

    // ---- the lobe: adjoints of n, d, a; throughput factor at
    float gnx = 0.0f, gny = 0.0f, gnz = 0.0f;
    float g_dx = 0.0f, g_dy = 0.0f, g_dz = 0.0f, ga = 0.0f;
    float atr = 1.0f, atg = 1.0f, atb = 1.0f;
    const int kind = clay ? kLambertian : kind_of[w];
    if (clay) {  // at = 0.8, d' = n + s (or n)
      atr = atg = atb = 0.8f;
      gnx = gndx;
      gny = gndy;
      gnz = gndz;
    } else if (kind == kLambertian) {  // at = albedo, d' = n + s (or n)
      atr = sp[4];
      atg = sp[5];
      atb = sp[6];
      gnx = gndx;
      gny = gndy;
      gnz = gndz;
    } else if (kind == kMetal) {  // above the surface: at = albedo
      atr = sp[4];
      atg = sp[5];
      atb = sp[6];
      float sx, sy, sz;
      sphere_sample(u1, u2, sx, sy, sz);
      const float dn = dot3(dx, dy, dz, nx, ny, nz);
      const float rfx = dx - 2.0f * dn * nx;
      const float rfy = dy - 2.0f * dn * ny;
      const float rfz = dz - 2.0f * dn * nz;
      const float ll = dot3(rfx, rfy, rfz, rfx, rfy, rfz);
      const float inv_len = 1.0f / sqrtf(fmaxf(ll, 1e-30f));
      // d' = rf * inv_len + fuzz * s
      atomicAdd(gsp + 7, dot3(gndx, gndy, gndz, sx, sy, sz));
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
      const float ir = sp[8];
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
        atomicAdd(gsp + 8, front ? -gratio * ratio * ratio : gratio);
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
    if (!clay && (kind == kLambertian || kind == kMetal)) {
      atomicAdd(gsp + 4, gtr * e.tr);
      atomicAdd(gsp + 5, gtg * e.tg);
      atomicAdd(gsp + 6, gtb * e.tb);
    }
    gtr = gtr * atr;
    gtg = gtg * atg;
    gtb = gtb * atb;

    // ---- normal n = sgn (p - c) / r, hit point p = o + t d
    const float gqx = sgn * gnx * inv_r, gqy = sgn * gny * inv_r,
                gqz = sgn * gnz * inv_r;
    const float ginv_r = sgn * dot3(gnx, gny, gnz, qx, qy, qz);
    float gcx = -gqx, gcy = -gqy, gcz = -gqz;
    float grad_r = -ginv_r * inv_r * inv_r;
    const float gpx = gpx0 + gqx, gpy = gpy0 + gqy, gpz = gpz0 + gqz;
    float gx = gpx, gy = gpy, gz = gpz;  // origin
    g_dx += t * gpx;
    g_dy += t * gpy;
    g_dz += t * gpz;
    const float gt = dot3(gpx, gpy, gpz, dx, dy, dz);

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

// Shared memory of a gradient block: the scene, and the block's sums.
struct GradShared {
  float f[kMaxFloats];
  int kind_of[kMaxSpheres];
  float gs[kMaxSpheres * kStride];  // per-sphere entries of d/d(fparams)
  float ghead[kHead + 1];           // head entries, then one extra sum
};

__device__ __forceinline__ void load_scene(GradShared& sh,
                                           const float* fparams,
                                           const int* kinds, int n_spheres) {
  const int n_f = kSpheres + n_spheres * kStride;
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) sh.f[i] = fparams[i];
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x)
    sh.kind_of[i] = kinds[i];
  for (int i = threadIdx.x; i < n_spheres * kStride; i += blockDim.x)
    sh.gs[i] = 0.0f;
  for (int i = threadIdx.x; i <= kHead; i += blockDim.x) sh.ghead[i] = 0.0f;
  __syncthreads();
}

// Every thread of the block calls this once, at its end: the head entries and
// `extra` are summed over each warp with shuffles, then over the block in
// shared memory; the block's n_out sums (head, spheres, then extra when
// n_out = K + 1) go to row blockIdx.x of `partials`.
__device__ __forceinline__ void write_partials(GradShared& sh,
                                               float (&head)[kHead],
                                               float extra, int n_spheres,
                                               int n_out, float* partials) {
#pragma unroll
  for (int k = 0; k <= kHead; ++k) {
    float v = k < kHead ? head[k] : extra;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(&sh.ghead[k], v);
  }
  __syncthreads();
  const int k_sph = kSpheres + n_spheres * kStride;
  float* row = partials + (size_t)blockIdx.x * n_out;
  for (int k = threadIdx.x; k < n_out; k += blockDim.x)
    row[k] = k < kHead ? sh.ghead[k]
             : k < k_sph ? sh.gs[k - kHead] : sh.ghead[kHead];
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

}  // namespace rtrt
