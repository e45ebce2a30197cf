// The per-ray walk of a chunk tree, shared by the BVH kernel (#5,
// bvh_forward.cu) and the shadow-ray occlusion kernel (#8, occlusion.cu).
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py's _traverse_tree,
// _sphere_chunk_hit, _vol_chunk_hit, _tri_chunk_hit/_row_mt, _mv_min_t and
// _merge_leaf_rows for one ray: a stackless walk over skip links, a
// NaN-propagating slab test, and the leaf's primitives tested against the
// ray's nearest hit so far; and the dense crossing scan of a mesh volume's
// boundary.  The arithmetic is ops/bvh_kernel.py's plain version's,
// operation for operation: the sphere root by true division, the volume's
// boundary window and free flight, the direct cross-product
// Moller-Trumbore, and slab min/max that propagate NaN as torch.minimum
// does (an axis-parallel ray's 0 * inf reads as a miss; fminf/fmaxf would
// drop the NaN and read a hit).

#pragma once

#include "radiance.cuh"

namespace rtrt {

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
// material ids; a volume tree's slots also carry -1/density and the
// volume's ordinal.  n_nodes == 0: no tree.
struct Tree {
  const float* nodes_f;
  const int* nodes_i;
  const int* chunk_len;
  const float* geo;  // spheres and volumes: 4 floats a slot; triangles: 12
  const int* mat;
  const float* nid;  // volumes only
  const int* ord;    // volumes only
  int n_nodes;
};

// A ray, with a = d.d and the reciprocals of d's components.
struct Ray {
  float ox, oy, oz, dx, dy, dz, idx, idy, idz, a;
};

// What a volume candidate needs beyond the ray: its length sqrt(a), and
// where its free-flight uniforms are: column col0 + ordinal of the ray's
// stream (uniform_pair's cipher (col0 + ordinal) / 2, word of the parity).
struct Flight {
  uint32_t k0, k1, ray, stream;
  int col0;
  float ray_len;
};

enum TreeKind { kSphereTree, kVolumeTree, kTriangleTree };

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

// Candidate distance of volume slot s (_vol_chunk_hit): the boundary
// window [h1, h2] from the quadratic (the far root only when at least
// T_MIN past the near one; the entry clamped to T_MIN, then to 0), and the
// free flight -1/density * log(u) from the entry, with the volume's own
// uniform, drawn only when the window is valid; accepted when it ends
// inside the window and nearer than tb.
__device__ __forceinline__ float volume_t(const Tree& tree, int s,
                                          const Ray& r, float tb,
                                          const Flight& fl) {
  const float4 g = __ldg(reinterpret_cast<const float4*>(tree.geo) + s);
  const float ocx = r.ox - g.x, ocy = r.oy - g.y, ocz = r.oz - g.z;
  const float hb = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - g.w * g.w;
  const float disc = hb * hb - r.a * cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-hb - sq) / r.a;
  const float t2 = (-hb + sq) / r.a;
  float h1 = max_nan(t1, kTMin);
  const float h2 = t2 >= t1 + kTMin ? t2 : INFINITY;
  if (!(disc >= 0.0f && g.w > 0.0f && h1 < h2)) return INFINITY;
  h1 = max_nan(h1, 0.0f);
  const float dist_inside = (h2 - h1) * fl.ray_len;
  const int c = fl.col0 + __ldg(tree.ord + s);
  float u0, u1;
  uniform_pair(fl.k0, fl.k1, fl.ray, fl.stream, (uint32_t)c >> 1, u0, u1);
  const float u = (c & 1) ? u1 : u0;
  const float hit_dist = __ldg(tree.nid + s) * logf(fmaxf(u, 1e-37f));
  const float ti = h1 + hit_dist / fl.ray_len;
  if (hit_dist <= dist_inside && ti < tb) return ti;
  return INFINITY;
}

// The raw Moller-Trumbore t of triangle slot s (_row_mt), at any sign;
// true when the determinant is away from 0 and the barycentrics lie in the
// triangle.
__device__ __forceinline__ bool triangle_raw(const float* geo, int s,
                                             const Ray& r, float& tt) {
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
  tt = f * (e2x * qx + e2y * qy + e2z * qz);
  return ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

// Candidate distance of triangle slot s: t in (T_MIN, tb].
__device__ __forceinline__ float triangle_t(const float* geo, int s,
                                            const Ray& r, float tb) {
  float tt;
  if (triangle_raw(geo, s, r, tt) && tt > kTMin && tt <= tb) return tt;
  return INFINITY;
}

// The mesh volumes (ops/bvh_kernel.pack): their boundary triangles, 12
// floats a slot as the triangle tree's, and per volume its first slot, its
// triangle count, -1/density and raw material id.  n == 0: none.
struct MeshVols {
  const float* geo;
  const int* start;
  const int* count;
  const float* nid;
  const int* mat;
  int n;
};

// The least raw t at or above `floor` of the n triangles from slot s0, or
// inf (_mv_min_t): no T_MIN and no t_best, since a crossing exists at any
// t.  A warp's rays read the same slot together, so each load is one
// broadcast from L1.
__device__ __forceinline__ float mv_min_t(const float* geo, int s0, int n,
                                          const Ray& r, float floor) {
  float best = INFINITY;
  for (int j = 0; j < n; ++j) {
    float tt;
    if (triangle_raw(geo, s0 + j, r, tt) && tt >= floor && tt < best)
      best = tt;
  }
  return best;
}

// Each mesh volume's candidate in index order (pallas_megakernel.py
// :1620-1671): the entry t1, the least raw t at any sign; the exit t2, the
// least t at or past t1 + T_MIN (scanned only when there is an entry); the
// window [max(t1, T_MIN, 0), t2]; the free flight of uniform column
// fl.col0 + v, drawn only for a valid window; it replaces (t_best, win)
// when it ends inside the window and nearer than t_best.
__device__ __forceinline__ void mesh_volume_scan(const MeshVols& mv,
                                                 const Ray& r, float& t_best,
                                                 int& win, const Flight& fl) {
  for (int v = 0; v < mv.n; ++v) {
    const int s0 = __ldg(mv.start + v), n = __ldg(mv.count + v);
    const float t1 = mv_min_t(mv.geo, s0, n, r, -INFINITY);
    if (!(t1 < INFINITY)) continue;  // no entry: t2 would be inf too
    const float t2 = mv_min_t(mv.geo, s0, n, r, t1 + kTMin);
    float h1 = max_nan(t1, kTMin);
    if (!(t2 < INFINITY && h1 < t2)) continue;
    h1 = max_nan(h1, 0.0f);
    const float dist_inside = (t2 - h1) * fl.ray_len;
    const int c = fl.col0 + v;
    float u0, u1;
    uniform_pair(fl.k0, fl.k1, fl.ray, fl.stream, (uint32_t)c >> 1, u0, u1);
    const float u = (c & 1) ? u1 : u0;
    const float hit_dist = __ldg(mv.nid + v) * logf(fmaxf(u, 1e-37f));
    const float ti = h1 + hit_dist / fl.ray_len;
    if (hit_dist <= dist_inside && ti < t_best) {
      t_best = ti;
      win = v;
    }
  }
}

// The ray's stackless walk of one tree (_traverse_tree for one ray).  A
// leaf's winner is its nearest candidate, the lowest slot among equals; it
// replaces (t_best, win) only when strictly nearer (_merge_leaf_rows).
// kAnyHit: the walk ends at the first candidate nearer than t_best, the
// lowest slot of the first leaf that has one (the shadow-ray test).  `fl`
// is read by a volume tree's walk only.
template <int kKind, bool kAnyHit = false>
__device__ __forceinline__ void walk(const Tree& tree, int leaf,
                                     const Ray& r, float& t_best, int& win,
                                     const Flight& fl = Flight{}) {
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
        const float ti =
            kKind == kSphereTree   ? sphere_t(tree.geo, base + j, r, tb)
            : kKind == kVolumeTree ? volume_t(tree, base + j, r, tb, fl)
                                   : triangle_t(tree.geo, base + j, r, tb);
        if (ti < c_best) {
          c_best = ti;
          c_win = base + j;
          if (kAnyHit && c_best < tb) break;
        }
      }
      if (c_best < tb) {
        t_best = c_best;
        win = c_win;
        if (kAnyHit) return;
      }
    }
    node = __ldg(links + 0);
  }
}

}  // namespace rtrt
