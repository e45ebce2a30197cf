// BVH forward kernel (#5) for scenes beyond the brute kernel, written for
// Hopper (sm_90a).
//
// Replaces the forward of raytracingrust_tpu/ops/pallas_megakernel.py's
// packet-traversal kernel: _make_bvh_kernel(record=False) over
// _radiance_math's BVH branch, _traverse_tree, _sphere_chunk_hit,
// _tri_chunk_hit/_row_mt and _merge_leaf_rows, for the envelope of
// ops/bvh_kernel.py (solid spheres and surface triangles; Lambertian, Metal,
// Dielectric and Emission; uniform or gradient background; Full or Clay
// mode; any depth).  Per ray: the jittered camera ray, then per bounce a
// stackless walk of the solid-sphere chunk tree, then of the triangle chunk
// tree starting from the sphere pass's nearest hit, then radiance.cuh's
// lobes.  Output: per-ray RGB, (n_rays, 3) float32.
//
// Record mode (template flag kRecord; _make_bvh_kernel(record=True)) also
// writes each bounce's winner code, (max_depth, n_rays) int32, for the
// replay gradient (diff/replay.py): the winner's slot in bits 0-26 (sphere
// slots first, triangle slots after the sphere tree's n_chunks * leaf), the
// front face at bit 27, and at bits 28 and 29 the metal lobe's
// above-the-surface test and the dielectric's reflect choice, evaluated for
// every hit whatever its kind when the scene holds that kind (`rec_mask`),
// as the JAX record does; -1 on a miss and for every bounce after the path
// ended.  Bounce-major, so a warp's stores coalesce.  The walk and the
// arithmetic of the radiance are the same in both modes.
//
// Design: one thread a ray, its whole state in registers.  The TPU kernel
// moves one node cursor for a block of 2,048 rays and intersects a leaf's
// 128 primitives as matrices; here each ray walks the tree on its own (the
// skip links need no stack), tests a leaf only when its own slab test hits
// the leaf's box, and tests only the chunk's real primitives (padding can
// never win).  Nodes and primitives are read from device memory through the
// read-only path; neighbouring rays walk mostly the same nodes, so a warp's
// loads are mostly one broadcast.  The arithmetic is ops/bvh_kernel.py's
// plain version's, operation for operation: the sphere root and normal by
// true division (not the brute kernel's reciprocal), the direct
// cross-product Moller-Trumbore, and slab min/max that propagate NaN as
// torch.minimum does (an axis-parallel ray's 0 * inf reads as a miss;
// fminf/fmaxf would drop the NaN and read a hit).
//
// What bounds it on this card: FP32 work per node visit and primitive test,
// and divergence between the rays of a warp once bounces scatter them; the
// scene (nodes and primitives, a few hundred KB) stays in L2.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "radiance.cuh"

namespace {

using namespace rtrt;

constexpr float kTriDetEps = 1e-8f;  // pallas_megakernel.TRI_DET_EPS

// min and max that return NaN when either argument is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (a < b ? a : b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (a > b ? a : b);
}

// One chunk tree in device memory (ops/bvh_kernel.pack): nodes (K, 6)
// float [min | max] and (K, 3) int [hit link, miss link, chunk or -1], each
// chunk's primitive count, and the primitives in slot order with their
// material ids.  n_nodes == 0: no tree.
struct Tree {
  const float* nodes_f;
  const int* nodes_i;
  const int* chunk_len;
  const float* geo;  // spheres: 4 floats a slot; triangles: 12
  const int* mat;
  int n_nodes;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, idx, idy, idz, a;
};

// record-mode code layout (pallas_megakernel.py's record bits)
constexpr int kRecSlot = (1 << 27) - 1;
constexpr int kRecFront = 1 << 27;
constexpr int kRecMetalOk = 1 << 28;
constexpr int kRecReflect = 1 << 29;

// The decision bits of a hit's record: the front face, and the decisions of
// the lobes `mask` names, from the winner's material row whatever its kind.
__device__ __forceinline__ int decision_bits(const float* mat, bool front,
                                             float a, float dx, float dy,
                                             float dz, float nx, float ny,
                                             float nz, float u1, float u2,
                                             float u_coin, int mask) {
  int bits = front ? kRecFront : 0;
  if (mask & kRecMetalOk) {
    float sx, sy, sz, mdx, mdy, mdz;
    sphere_sample(u1, u2, sx, sy, sz);
    if (metal_lobe(mat[3], dx, dy, dz, nx, ny, nz, sx, sy, sz, mdx, mdy,
                   mdz))
      bits |= kRecMetalOk;
  }
  if (mask & kRecReflect) {
    float ratio, udx, udy, udz, cos_t;
    if (dielectric_reflects(mat[4], front, a, dx, dy, dz, nx, ny, nz, u_coin,
                            ratio, udx, udy, udz, cos_t))
      bits |= kRecReflect;
  }
  return bits;
}

// Candidate distance of sphere slot s (_sphere_chunk_hit): the near root if
// in [T_MIN, tb], else the far root; radius 0 never hits.
__device__ __forceinline__ float sphere_t(const float* geo, int s,
                                          const Ray& r, float tb) {
  const float4 g = __ldg(reinterpret_cast<const float4*>(geo) + s);
  const float ocx = r.ox - g.x, ocy = r.oy - g.y, ocz = r.oz - g.z;
  const float hb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - g.w * g.w;
  const float disc = hb * hb - r.a * cq;
  const bool ok = disc >= 0.0f && g.w > 0.0f;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-hb - sq) / r.a;
  const float t2 = (-hb + sq) / r.a;
  if (ok && t1 >= kTMin && t1 <= tb) return t1;
  if (ok && t2 >= kTMin && t2 <= tb) return t2;
  return INFINITY;
}

// Candidate distance of triangle slot s (_row_mt): t in (T_MIN, tb].
__device__ __forceinline__ float triangle_t(const float* geo, int s,
                                            const Ray& r, float tb) {
  const float4* g = reinterpret_cast<const float4*>(geo) + 3 * s;
  const float4 g0 = __ldg(g), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
  const float v0x = g0.x, v0y = g0.y, v0z = g0.z;
  const float e1x = g0.w, e1y = g1.x, e1z = g1.y;
  const float e2x = g1.z, e2y = g1.w, e2z = g2.x;
  const float hx = r.dy * e2z - r.dz * e2y;  // h = d x e2
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  const bool ok = fabsf(det) > kTriDetEps;
  const float f = 1.0f / (ok ? det : 1.0f);
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;  // q = s x e1
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
  if (ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
      tt > kTMin && tt <= tb)
    return tt;
  return INFINITY;
}

// The ray's stackless walk of one tree (_traverse_tree for one ray).  A
// leaf's winner is its nearest candidate, the lowest slot among equals; it
// replaces (t_best, win) only when strictly nearer (_merge_leaf_rows).
template <bool kSphere>
__device__ __forceinline__ void walk(const Tree& tree, int leaf,
                                     const Ray& r, float& t_best, int& win) {
  int node = 0;
  while (node < tree.n_nodes) {
    const float* box = tree.nodes_f + 6 * node;
    const float t0x = (__ldg(box + 0) - r.ox) * r.idx;
    const float t0y = (__ldg(box + 1) - r.oy) * r.idy;
    const float t0z = (__ldg(box + 2) - r.oz) * r.idz;
    const float t1x = (__ldg(box + 3) - r.ox) * r.idx;
    const float t1y = (__ldg(box + 4) - r.oy) * r.idy;
    const float t1z = (__ldg(box + 5) - r.oz) * r.idz;
    const float entry =
        max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                max_nan(min_nan(t0z, t1z), kTMin));
    const float exit_ =
        min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                min_nan(max_nan(t0z, t1z), t_best));
    const int* links = tree.nodes_i + 3 * node;
    if (!(exit_ > entry)) {
      node = __ldg(links + 1);
      continue;
    }
    const int chunk = __ldg(links + 2);
    if (chunk >= 0) {
      const int base = chunk * leaf;
      const int n = __ldg(tree.chunk_len + chunk);
      const float tb = t_best;  // the whole leaf tests against its entry t
      float c_best = INFINITY;
      int c_win = -1;
      for (int j = 0; j < n; ++j) {
        const float ti = kSphere ? sphere_t(tree.geo, base + j, r, tb)
                                 : triangle_t(tree.geo, base + j, r, tb);
        if (ti < c_best) {
          c_best = ti;
          c_win = base + j;
        }
      }
      if (c_best < tb) {
        t_best = c_best;
        win = c_win;
      }
    }
    node = __ldg(links + 0);
  }
}

template <bool kRecord>
__global__ void __launch_bounds__(kThreads)
bvh_radiance_kernel(const float* __restrict__ head,
                    const float* __restrict__ mats,
                    const int* __restrict__ kinds, Tree sph, Tree tri,
                    int leaf, uint32_t k0, uint32_t k1, int n_rays, int spp,
                    int width, int max_depth, int bg_kind, int clay,
                    float* __restrict__ out, int* __restrict__ rec,
                    int rec_mask, int tri_base) {
  __shared__ float f[kHead];
  for (int i = threadIdx.x; i < kHead; i += blockDim.x) f[i] = head[i];
  __syncthreads();

  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;  // the ragged last block
  const int ray = (int)gid;   // = pixel * spp + sample
  const int pixel = ray / spp;
  Ray r;
  camera_ray(f, k0, k1, (uint32_t)ray, (float)(pixel % width),
             (float)(pixel / width), r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  int ended = max_depth;  // record mode: the bounces after the path's end

  for (int b = 0; b < max_depth; ++b) {
    // bounce stream 1 + b: columns [u1, u2, coin]
    float u1, u2, u_coin, u_spare;
    uniform_pair(k0, k1, (uint32_t)ray, 1u + (uint32_t)b, 0u, u1, u2);
    uniform_pair(k0, k1, (uint32_t)ray, 1u + (uint32_t)b, 1u, u_coin,
                 u_spare);
    r.a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
    r.idx = 1.0f / r.dx;
    r.idy = 1.0f / r.dy;
    r.idz = 1.0f / r.dz;

    float t_best = INFINITY;
    int w_sph = -1, w_tri = -1;
    walk<true>(sph, leaf, r, t_best, w_sph);
    walk<false>(tri, leaf, r, t_best, w_tri);

    if (!(t_best < INFINITY)) {  // miss: the background ends the path
      float bg_r, bg_g, bg_b;
      background(f, bg_kind, r.dx, r.dy, r.dz, bg_r, bg_g, bg_b);
      rad_r = rad_r + thr_r * bg_r;
      rad_g = rad_g + thr_g * bg_g;
      rad_b = rad_b + thr_b * bg_b;
      if (kRecord) {
        rec[(size_t)b * n_rays + ray] = -1;
        ended = b + 1;
      }
      break;
    }

    const float ptx = r.ox + t_best * r.dx;
    const float pty = r.oy + t_best * r.dy;
    const float ptz = r.oz + t_best * r.dz;
    float nx, ny, nz;
    int mid;
    if (w_tri >= 0) {  // the triangle pass found a nearer hit: flat normal
      const float* g = tri.geo + 12 * w_tri;
      nx = __ldg(g + 9);
      ny = __ldg(g + 10);
      nz = __ldg(g + 11);
      mid = __ldg(tri.mat + w_tri);
    } else {  // (p - c) / r, by true division
      const float4 g = __ldg(reinterpret_cast<const float4*>(sph.geo) +
                             w_sph);
      const float g_rad = g.w > 0.0f ? g.w : 1.0f;
      nx = (ptx - g.x) / g_rad;
      ny = (pty - g.y) / g_rad;
      nz = (ptz - g.z) / g_rad;
      mid = __ldg(sph.mat + w_sph);
    }
    const bool front = dot3(r.dx, r.dy, r.dz, nx, ny, nz) < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    nx = nx * sgn;
    ny = ny * sgn;
    nz = nz * sgn;

    float mat[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) mat[k] = __ldg(mats + 8 * mid + k);
    float at_r, at_g, at_b, ndx, ndy, ndz;
    bool scatters;
    int code = 0;
    scatter(mat, __ldg(kinds + mid), clay, front, r.a, r.dx, r.dy, r.dz, nx,
            ny, nz, u1, u2, u_coin, at_r, at_g, at_b, ndx, ndy, ndz,
            scatters, code);
    if (kRecord) {
      const int slot = w_tri >= 0 ? tri_base + w_tri : w_sph;
      rec[(size_t)b * n_rays + ray] =
          slot | decision_bits(mat, front, r.a, r.dx, r.dy, r.dz, nx, ny,
                               nz, u1, u2, u_coin, rec_mask);
    }

    if (!scatters) {  // absorbed or emitted: the path ends
      rad_r = rad_r + thr_r * at_r;
      rad_g = rad_g + thr_g * at_g;
      rad_b = rad_b + thr_b * at_b;
      if (kRecord) ended = b + 1;
      break;
    }
    thr_r = thr_r * at_r;
    thr_g = thr_g * at_g;
    thr_b = thr_b * at_b;
    r.ox = ptx;
    r.oy = pty;
    r.oz = ptz;
    r.dx = ndx;
    r.dy = ndy;
    r.dz = ndz;
  }
  if (kRecord)
    for (int b = ended; b < max_depth; ++b) rec[(size_t)b * n_rays + ray] = -1;
  float* o = out + 3 * (size_t)ray;
  o[0] = rad_r;
  o[1] = rad_g;
  o[2] = rad_b;
}

}  // namespace

// Plain C entry, bound with ctypes (ops/bvh_kernel.py).  With `rec` not
// null it launches the record variant, which writes the codes there, the
// decision bits `rec_mask` names and triangle slots offset by `tri_base`.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int rtrt_bvh_radiance(
    const float* head, const float* mats, const int* kinds, int n_mats,
    const float* s_nodes_f, const int* s_nodes_i, const int* s_len,
    const float* s_geo, const int* s_mat, int s_nodes,
    const float* t_nodes_f, const int* t_nodes_i, const int* t_len,
    const float* t_geo, const int* t_mat, int t_nodes, int leaf, uint32_t k0,
    uint32_t k1, int n_rays, int spp, int width, int max_depth, int bg_kind,
    int clay, float* out, int* rec, int rec_mask, int tri_base,
    void* stream) {
  if (n_mats < 1 || s_nodes < 0 || t_nodes < 0 || s_nodes + t_nodes < 1 ||
      leaf < 1 || n_rays < 0 || spp < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const Tree sph{s_nodes_f, s_nodes_i, s_len, s_geo, s_mat, s_nodes};
  const Tree tri{t_nodes_f, t_nodes_i, t_len, t_geo, t_mat, t_nodes};
  if (rec)
    bvh_radiance_kernel<true><<<blocks_for(n_rays), kThreads, 0,
                                (cudaStream_t)stream>>>(
        head, mats, kinds, sph, tri, leaf, k0, k1, n_rays, spp, width,
        max_depth, bg_kind, clay, out, rec, rec_mask, tri_base);
  else
    bvh_radiance_kernel<false><<<blocks_for(n_rays), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        head, mats, kinds, sph, tri, leaf, k0, k1, n_rays, spp, width,
        max_depth, bg_kind, clay, out, nullptr, 0, 0);
  return (int)cudaGetLastError();
}
