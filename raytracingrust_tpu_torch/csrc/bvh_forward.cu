// BVH forward kernel (#5) for scenes beyond the brute kernel, written for
// Hopper (sm_90a).
//
// Replaces the forward of raytracingrust_tpu/ops/pallas_megakernel.py's
// packet-traversal kernel: _make_bvh_kernel(record=False) over
// _radiance_math's BVH branch, _traverse_tree, _sphere_chunk_hit,
// _vol_chunk_hit, _tri_chunk_hit/_row_mt, _mv_min_t, _merge_leaf_rows and
// _mixn_resolve, for the envelope of ops/bvh_kernel.py (solid spheres, up
// to 8 sphere volumes, surface triangles and up to 4 mesh volumes;
// Lambertian, Metal, Dielectric, Emission, Isotropic and mixes nested up to
// 4 levels; uniform, gradient or sky-map background; Full or Clay mode;
// any depth).  Per ray: the jittered camera ray, then per bounce a
// stackless walk of the solid-sphere chunk tree, then of the volume-sphere
// tree, then of the surface-triangle tree, each starting from the nearest
// hit of the walks before it, then the walks of each mesh volume's tree;
// the winner's mix resolved with the bounce's coins; then radiance.cuh's
// lobes.  Output: per-ray RGB, (n_rays, 3) float32.
//
// A bounce's uniforms are the JAX columns of stream 1 + b: with mixes the
// four coins first (off = 4), then u1, u2, the coin and u_r at off + 0..3,
// and volume v's free-flight uniform at off + 4 + v, which a volume
// candidate draws (its own Threefry pair) only when the ray's window of it
// is valid; mesh volume v's at off + 4 + n_vol + v, likewise.  A volume's
// hit has the dummy normal (1, 0, 0).  The template flag kExt compiles the
// volume walk, the mix rounds and the isotropic lobe; a scene without them
// launches the variant without them.
//
// Mesh volumes (template flag kMv, which implies kExt; pallas_megakernel.py
// :1620-1671): after the trees, each volume's crossing scan of its
// boundary triangles (bvh_walk.cuh mesh_volume_scan): the entry at any t,
// since a ray may start inside the medium, which a walk whose slab test
// floors t at T_MIN cannot find; then the exit; then the free flight.  The
// JAX kernel scans every boundary triangle twice a bounce (_mv_min_t); a
// ray there pays for the whole boundary even when its line passes nowhere
// near it.  Here each pass is a stackless walk of the volume's own tree
// (bvh_walk.cuh mv_walk; ops/bvh.build_mv_trees, leaves of 4 triangles,
// padded boxes), which looks at the whole line, at any sign, and tests a
// leaf only when the line crosses its box within bounds fixed before the
// walk: the entry pass skips a line that meets the root box only before
// T_MIN and boxes that begin past the trees' nearest hit, the exit pass
// boxes that end below its floor.  The least t is the dense scan's bit for
// bit (the same candidates, the same arithmetic) wherever it can change
// the hit.  A scene without mesh volumes launches the variants without the
// scan, so it keeps the code it ran.  What bounds the scan: FP32 work,
// about 37 operations a node visit and 50 a triangle test, and the
// divergence of a warp's rays between the nodes they visit.
//
// A sky map (template flag kSky): a ray that escapes adds its throughput
// times the sky's nearest texel, looked up here (radiance.cuh
// sky_radiance) from the (h, w, 3) texels in global memory.  The TPU
// kernel writes the escaping direction and throughput out and gathers
// after the kernel, since Mosaic has no in-kernel gather; here the lookup
// is the one PyTorch makes on the card, bit for bit.  The record variant
// runs under a black uniform background instead: the codes do not depend
// on the background, and the replay adds the sky.
//
// The inspection views (bvh_view_kernel, _make_bvh_kernel's `debug`): one
// intersection with bounce stream 1's volume uniforms, no scatter chain; a
// hit gives 0.5 * (its normalized front-facing normal + 1) (Normal) or
// black (Random), a miss the background, a sky map's included.
//
// Record mode (template flag kRecord; _make_bvh_kernel(record=True)) also
// writes each bounce's winner code, (max_depth, n_rays) int32, for the
// replay gradient (diff/replay.py): the winner's slot in bits 0-26 (sphere
// slots first, volume slots from vol_base, triangle slots from tri_base,
// mesh volume v as mv_base + v),
// the front face at bit 27, and at bits 28 and 29 the metal lobe's
// above-the-surface test and the dielectric's reflect choice of the
// resolved material, evaluated for every hit whatever its kind when the
// scene holds that kind (`rec_mask`), as the JAX record does; -1 on a miss
// and for every bounce after the path ended.  Bounce-major, so a warp's
// stores coalesce.  The walk and the arithmetic of the radiance are the
// same in both modes.
//
// Design: one thread a ray, its whole state in registers.  The TPU kernel
// moves one node cursor for a block of 2,048 rays and intersects a leaf's
// 128 primitives as matrices; here each ray walks the tree on its own (the
// skip links need no stack), tests a leaf only when its own slab test hits
// the leaf's box, and tests only the chunk's real primitives (padding can
// never win).  Nodes and primitives are read from device memory through the
// read-only path; neighbouring rays walk mostly the same nodes, so a warp's
// loads are mostly one broadcast.  The walk is bvh_walk.cuh's, shared with
// the occlusion kernel (#8); the arithmetic is ops/bvh_kernel.py's plain
// version's, operation for operation: the sphere root and normal by true
// division (not the brute kernel's reciprocal), the free flight by logf
// (torch.log's on the card), the direct cross-product Moller-Trumbore, and
// slab min/max that propagate NaN as torch.minimum does.
//
// What bounds it on this card: FP32 work per node visit and primitive test
// (a volume candidate whose window a ray crosses adds a Threefry draw and a
// logf), and divergence between the rays of a warp once bounces scatter
// them; the scene (nodes and primitives, a few hundred KB) stays in L2.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

using namespace rtrt;

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

// The mix table of the scene's materials (null without mixes).
struct MixTable {
  const int* first;     // (M,) self for a non-mix row
  const int* second;    // (M,)
  const float* factor;  // (M,)
};

// The resolution rounds of a hit's material (ops/shade.resolve_mix): a mix
// picks its first child when the level's coin is at least its factor.
__device__ __forceinline__ int resolve_mix(const MixTable& mx,
                                           const int* kinds, int mid,
                                           const float (&coin)[4]) {
#pragma unroll
  for (int level = 0; level < 4; ++level) {
    if (__ldg(kinds + mid) == kMix)
      mid = coin[level] >= __ldg(mx.factor + mid) ? __ldg(mx.first + mid)
                                                  : __ldg(mx.second + mid);
  }
  return mid;
}

// The outward normal at the hit point p and the raw material id of the
// ray's winner, the last pass that found a nearer hit: a volume's dummy
// (1, 0, 0), a triangle's flat normal, a sphere's (p - c) / r by true
// division.
template <bool kExt, bool kMv = false>
__device__ __forceinline__ int winner(const Tree& sph, const Tree& vol,
                                      const Tree& tri, const MeshVols& mv,
                                      int w_sph, int w_vol, int w_tri,
                                      int w_mv, float ptx, float pty,
                                      float ptz, float& nx, float& ny,
                                      float& nz) {
  if (kMv && w_mv >= 0) {  // the mesh volumes' scan found a nearer hit
    nx = 1.0f;
    ny = 0.0f;
    nz = 0.0f;
    return __ldg(mv.mat + w_mv);
  }
  if (w_tri >= 0) {  // the triangle pass found a nearer hit
    const float* g = tri.geo + 12 * w_tri;
    nx = __ldg(g + 9);
    ny = __ldg(g + 10);
    nz = __ldg(g + 11);
    return __ldg(tri.mat + w_tri);
  }
  if (kExt && w_vol >= 0) {
    nx = 1.0f;
    ny = 0.0f;
    nz = 0.0f;
    return __ldg(vol.mat + w_vol);
  }
  const float4 g = __ldg(reinterpret_cast<const float4*>(sph.geo) + w_sph);
  const float g_rad = g.w > 0.0f ? g.w : 1.0f;
  nx = (ptx - g.x) / g_rad;
  ny = (pty - g.y) / g_rad;
  nz = (ptz - g.z) / g_rad;
  return __ldg(sph.mat + w_sph);
}

// The packed head into shared memory, then the thread's ray: its id
// (= pixel * spp + sample) and its jittered camera ray; false for the
// threads past the last ray.
__device__ __forceinline__ bool start_ray(const float* __restrict__ head,
                                          float* f, uint32_t k0, uint32_t k1,
                                          int n_rays, int spp, int width,
                                          int& ray, Ray& r) {
  for (int i = threadIdx.x; i < kHead; i += blockDim.x) f[i] = head[i];
  __syncthreads();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return false;  // the ragged last block
  ray = (int)gid;
  const int pixel = ray / spp;
  camera_ray(f, k0, k1, (uint32_t)ray, (float)(pixel % width),
             (float)(pixel / width), r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  return true;
}

// kExt: the scene has volumes, mixes or an isotropic material (a
// compile-time flag, so scenes without them run the code they always ran).
// kSky: the background is a sky map, looked up on a miss.  kMv: the scene
// has mesh volumes, whose free flights draw from column mv_col0 + v.
template <bool kRecord, bool kExt, bool kSky, bool kMv>
__global__ void __launch_bounds__(kThreads)
bvh_radiance_kernel(const float* __restrict__ head,
                    const float* __restrict__ mats,
                    const int* __restrict__ kinds, Tree sph, Tree vol,
                    Tree tri, int leaf, MixTable mx, uint32_t k0,
                    uint32_t k1, int n_rays, int spp, int width,
                    int max_depth, int bg_kind, int clay, Sky sky,
                    float* __restrict__ out, int* __restrict__ rec,
                    int rec_mask, int vol_base, int tri_base, MeshVols mv,
                    int mv_col0, int mv_base) {
  __shared__ float f[kHead];
  int ray;
  Ray r;
  if (!start_ray(head, f, k0, k1, n_rays, spp, width, ray, r)) return;
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  int ended = max_depth;  // record mode: the bounces after the path's end
  // the lobe's first uniform column: after the four mix coins, if any
  const int off = kExt && mx.first ? 4 : 0;

  for (int b = 0; b < max_depth; ++b) {
    // bounce stream 1 + b: columns [u1, u2, coin, u_r] from `off`
    float u1, u2, u_coin, u_r;
    const uint32_t stream = 1u + (uint32_t)b;
    uniform_pair(k0, k1, (uint32_t)ray, stream, (uint32_t)off >> 1, u1, u2);
    uniform_pair(k0, k1, (uint32_t)ray, stream, ((uint32_t)off >> 1) + 1u,
                 u_coin, u_r);
    r.a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
    r.idx = 1.0f / r.dx;
    r.idy = 1.0f / r.dy;
    r.idz = 1.0f / r.dz;

    float t_best = INFINITY;
    int w_sph = -1, w_vol = -1, w_tri = -1, w_mv = -1;
    walk<kSphereTree>(sph, leaf, r, t_best, w_sph);
    if (kExt && vol.n_nodes)
      walk<kVolumeTree>(vol, leaf, r, t_best, w_vol,
                        Flight{k0, k1, (uint32_t)ray, stream, off + 4,
                               sqrtf(r.a)});
    walk<kTriangleTree>(tri, leaf, r, t_best, w_tri);
    if (kMv)
      mesh_volume_scan(mv, r, t_best, w_mv,
                       Flight{k0, k1, (uint32_t)ray, stream, mv_col0,
                              sqrtf(r.a)});

    if (!(t_best < INFINITY)) {  // miss: the background ends the path
      float bg_r, bg_g, bg_b;
      if (kSky)
        sky_radiance(sky, r.dx, r.dy, r.dz, bg_r, bg_g, bg_b);
      else
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
    int mid = winner<kExt, kMv>(sph, vol, tri, mv, w_sph, w_vol, w_tri, w_mv,
                                ptx, pty, ptz, nx, ny, nz);
    if (kExt && mx.first) {  // the mix coins: columns 0 .. 3
      float coin[4];
      uniform_pair(k0, k1, (uint32_t)ray, stream, 0u, coin[0], coin[1]);
      uniform_pair(k0, k1, (uint32_t)ray, stream, 1u, coin[2], coin[3]);
      mid = resolve_mix(mx, kinds, mid, coin);
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
    scatter<kExt>(mat, __ldg(kinds + mid), clay, front, r.a, r.dx, r.dy,
                  r.dz, nx, ny, nz, u1, u2, u_coin, at_r, at_g, at_b, ndx,
                  ndy, ndz, scatters, code, u_r);
    if (kRecord) {
      const int slot = (kMv && w_mv >= 0)     ? mv_base + w_mv
                       : w_tri >= 0           ? tri_base + w_tri
                       : (kExt && w_vol >= 0) ? vol_base + w_vol
                                              : w_sph;
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

// The inspection views: one intersection of the camera ray, its volume
// candidates drawing from bounce stream 1 at column `vol_col0` + ordinal
// (after the mix coins and the lobe's four columns, as #5's first bounce
// draws them), its mesh volumes' (kMv) at `mv_col0` + v; a hit gives
// 0.5 * (n / |n| + 1) of the front-facing normal n (`normal`) or black, a
// miss the background (kSky: the sky map).  Depth 0 traces nothing.
template <bool kSky, bool kMv>
__global__ void __launch_bounds__(kThreads)
bvh_view_kernel(const float* __restrict__ head, Tree sph, Tree vol, Tree tri,
                int leaf, uint32_t k0, uint32_t k1, int n_rays, int spp,
                int width, int max_depth, int bg_kind, Sky sky, int normal,
                int vol_col0, MeshVols mv, int mv_col0,
                float* __restrict__ out) {
  __shared__ float f[kHead];
  int ray;
  Ray r;
  if (!start_ray(head, f, k0, k1, n_rays, spp, width, ray, r)) return;
  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  if (max_depth > 0) {
    r.a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
    r.idx = 1.0f / r.dx;
    r.idy = 1.0f / r.dy;
    r.idz = 1.0f / r.dz;
    float t_best = INFINITY;
    int w_sph = -1, w_vol = -1, w_tri = -1, w_mv = -1;
    walk<kSphereTree>(sph, leaf, r, t_best, w_sph);
    if (vol.n_nodes)
      walk<kVolumeTree>(vol, leaf, r, t_best, w_vol,
                        Flight{k0, k1, (uint32_t)ray, 1u, vol_col0,
                               sqrtf(r.a)});
    walk<kTriangleTree>(tri, leaf, r, t_best, w_tri);
    if (kMv)
      mesh_volume_scan(mv, r, t_best, w_mv,
                       Flight{k0, k1, (uint32_t)ray, 1u, mv_col0,
                              sqrtf(r.a)});
    if (!(t_best < INFINITY)) {
      if (kSky)
        sky_radiance(sky, r.dx, r.dy, r.dz, c_r, c_g, c_b);
      else
        background(f, bg_kind, r.dx, r.dy, r.dz, c_r, c_g, c_b);
    } else if (normal) {
      float nx, ny, nz;
      winner<true, kMv>(sph, vol, tri, mv, w_sph, w_vol, w_tri, w_mv,
                        r.ox + t_best * r.dx, r.oy + t_best * r.dy,
                        r.oz + t_best * r.dz, nx, ny, nz);
      const float sgn = dot3(r.dx, r.dy, r.dz, nx, ny, nz) < 0.0f ? 1.0f
                                                                  : -1.0f;
      nx = nx * sgn;
      ny = ny * sgn;
      nz = nz * sgn;
      const float inv_n =
          1.0f / sqrtf(fmaxf(dot3(nx, ny, nz, nx, ny, nz), 1e-30f));
      c_r = 0.5f * (nx * inv_n + 1.0f);
      c_g = 0.5f * (ny * inv_n + 1.0f);
      c_b = 0.5f * (nz * inv_n + 1.0f);
    }
  }
  float* o = out + 3 * (size_t)ray;
  o[0] = c_r;
  o[1] = c_g;
  o[2] = c_b;
}

// Everything one launch of the radiance kernel takes, whatever its variant.
struct Args {
  const float* head;
  const float* mats;
  const int* kinds;
  Tree sph, vol, tri;
  int leaf;
  MixTable mx;
  uint32_t k0, k1;
  int n_rays, spp, width, max_depth, bg_kind, clay;
  Sky sky;
  float* out;
  int* rec;
  int rec_mask, vol_base, tri_base;
  MeshVols mv;
  int mv_col0, mv_base;
};

template <bool kRecord, bool kExt, bool kSky, bool kMv>
void launch(const Args& a, cudaStream_t stream) {
  bvh_radiance_kernel<kRecord, kExt, kSky, kMv>
      <<<blocks_for(a.n_rays), kThreads, 0, stream>>>(
          a.head, a.mats, a.kinds, a.sph, a.vol, a.tri, a.leaf, a.mx, a.k0,
          a.k1, a.n_rays, a.spp, a.width, a.max_depth, a.bg_kind, a.clay,
          a.sky, a.out, a.rec, a.rec_mask, a.vol_base, a.tri_base, a.mv,
          a.mv_col0, a.mv_base);
}

template <bool kSky, bool kMv>
void launch_view(const Args& a, int normal, int vol_col0,
                 cudaStream_t stream) {
  bvh_view_kernel<kSky, kMv><<<blocks_for(a.n_rays), kThreads, 0, stream>>>(
      a.head, a.sph, a.vol, a.tri, a.leaf, a.k0, a.k1, a.n_rays, a.spp,
      a.width, a.max_depth, a.bg_kind, a.sky, normal, vol_col0, a.mv,
      a.mv_col0, a.out);
}

}  // namespace

// Plain C entry, bound with ctypes (ops/bvh_kernel.py).  With `rec` not
// null it launches the record variant, which writes the codes there, the
// decision bits `rec_mask` names, volume slots offset by `vol_base` and
// triangle slots by `tri_base`.  The volume tree (v_*), the mix table
// (null without mixes) and `iso` (an isotropic material is reachable)
// select the kernel's extended variant; without them it is the variant
// of solid spheres and triangles.  `sky` (the (sky_h, sky_w, 3) texels,
// bg_kind kSkyMap) selects the sky variant, which the record walk does not
// take.  `view` 1 (Normal) or 2 (Random) launches the inspection view
// instead, forward only.  The mesh volumes (mv_*, n_mv of them: their
// trees' nodes, links, leaf counts and rows, `mv_leaf` slots a leaf, each
// volume's [first node, end); their codes from mv_base) select the
// variants with the crossing scan.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int rtrt_bvh_radiance(
    const float* head, const float* mats, const int* kinds, int n_mats,
    const float* s_nodes_f, const int* s_nodes_i, const int* s_len,
    const float* s_geo, const int* s_mat, int s_nodes,
    const float* v_nodes_f, const int* v_nodes_i, const int* v_len,
    const float* v_geo, const int* v_mat, const float* v_nid,
    const int* v_ord, int v_nodes, const float* t_nodes_f,
    const int* t_nodes_i, const int* t_len, const float* t_geo,
    const int* t_mat, int t_nodes, int leaf, const int* mix_first,
    const int* mix_second, const float* mix_factor, int n_vol, int iso,
    uint32_t k0, uint32_t k1, int n_rays, int spp, int width, int max_depth,
    int bg_kind, int clay, float* out, int* rec, int rec_mask, int vol_base,
    int tri_base, const float* sky, int sky_h, int sky_w, int view,
    const float* mv_nodes_f, const int* mv_nodes_i, const int* mv_len,
    const float* mv_geo, const int* mv_bounds, const float* mv_nid,
    const int* mv_mat, int n_mv, int mv_leaf, int mv_base, void* stream) {
  const bool has_sky = bg_kind == kSkyMap;
  const bool has_mv = n_mv > 0;
  if (n_mats < 1 || s_nodes < 0 || v_nodes < 0 || t_nodes < 0 ||
      (s_nodes + v_nodes + t_nodes < 1 && !has_mv) || leaf < 1 ||
      n_rays < 0 || n_mv < 0 || n_mv > 4 ||
      (has_mv && (!mv_nodes_f || !mv_nodes_i || !mv_len || !mv_geo ||
                  !mv_bounds || !mv_nid || !mv_mat || mv_leaf < 1 ||
                  mv_base < 0)) ||
      spp < 1 || width < 1 || n_vol < 0 || n_vol > 8 ||
      (v_nodes > 0 && (!v_nid || !v_ord)) ||
      (mix_first && (!mix_second || !mix_factor)) || bg_kind < kUniform ||
      bg_kind > kSkyMap || has_sky != (sky != nullptr) ||
      (has_sky && (sky_h < 1 || sky_w < 1)) || view < 0 || view > 2 ||
      (rec && (has_sky || view)))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int vol_col0 = (mix_first ? 4 : 0) + 4;  // after the lobe's columns
  const Args a{head,
               mats,
               kinds,
               Tree{s_nodes_f, s_nodes_i, s_len, s_geo, s_mat, nullptr,
                    nullptr, s_nodes},
               Tree{v_nodes_f, v_nodes_i, v_len, v_geo, v_mat, v_nid, v_ord,
                    v_nodes},
               Tree{t_nodes_f, t_nodes_i, t_len, t_geo, t_mat, nullptr,
                    nullptr, t_nodes},
               leaf,
               MixTable{mix_first, mix_second, mix_factor},
               k0,
               k1,
               n_rays,
               spp,
               width,
               max_depth,
               bg_kind,
               clay,
               Sky{sky, sky_h, sky_w},
               out,
               rec,
               rec ? rec_mask : 0,
               rec ? vol_base : 0,
               rec ? tri_base : 0,
               MeshVols{Tree{mv_nodes_f, mv_nodes_i, mv_len, mv_geo, nullptr,
                             nullptr, nullptr, 0},
                        mv_bounds, mv_nid, mv_mat, mv_leaf, n_mv},
               vol_col0 + n_vol,
               rec ? mv_base : 0};
  const bool ext = v_nodes > 0 || mix_first || iso || has_mv;
  const cudaStream_t st = (cudaStream_t)stream;
  if (view) {
    if (has_mv && has_sky)
      launch_view<true, true>(a, view == 1, vol_col0, st);
    else if (has_mv)
      launch_view<false, true>(a, view == 1, vol_col0, st);
    else if (has_sky)
      launch_view<true, false>(a, view == 1, vol_col0, st);
    else
      launch_view<false, false>(a, view == 1, vol_col0, st);
    return (int)cudaGetLastError();
  }
  if (rec && has_mv)
    launch<true, true, false, true>(a, st);
  else if (rec && ext)
    launch<true, true, false, false>(a, st);
  else if (rec)
    launch<true, false, false, false>(a, st);
  else if (has_mv && has_sky)
    launch<false, true, true, true>(a, st);
  else if (has_mv)
    launch<false, true, false, true>(a, st);
  else if (ext && has_sky)
    launch<false, true, true, false>(a, st);
  else if (ext)
    launch<false, true, false, false>(a, st);
  else if (has_sky)
    launch<false, false, true, false>(a, st);
  else
    launch<false, false, false, false>(a, st);
  return (int)cudaGetLastError();
}
