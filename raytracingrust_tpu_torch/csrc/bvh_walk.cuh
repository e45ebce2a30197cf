// The per-ray walk of a chunk tree, shared by the BVH kernel (#5,
// bvh_forward.cu) and the shadow-ray occlusion kernel (#8, occlusion.cu).
//
// Replaces raytracingrust_tpu/ops/pallas_megakernel.py's _traverse_tree,
// _sphere_chunk_hit, _vol_chunk_hit, _tri_chunk_hit/_row_mt, _mv_min_t and
// _merge_leaf_rows for one ray: a stackless walk over skip links, a
// NaN-propagating slab test, and the leaf's primitives tested against the
// ray's nearest hit so far; and the crossing scan of a mesh volume's
// boundary, which the JAX kernel makes densely (_mv_min_t over every
// boundary triangle) and which here walks the volume's own small tree
// (mv_walk).  Inside a chunk of the sphere or triangle tree #5 and #8 walk
// the chunk's own small tree (sub_walk), where the JAX kernel tests every
// slot of the chunk.  The arithmetic is ops/bvh_kernel.py's plain version's,
// operation for operation: the sphere root by true division, the volume's
// boundary window and free flight, the direct cross-product
// Moller-Trumbore, and slab min/max that propagate NaN as torch.minimum
// does (an axis-parallel ray's 0 * inf reads as a miss; fminf/fmaxf would
// drop the NaN and read a hit); in the mesh volumes' walk a NaN slab reads
// as the whole line instead.

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

// The mesh volumes (ops/bvh_kernel.pack): every volume's boundary tree
// one after another (ops/bvh.build_mv_trees: boxes already padded, links
// and chunks global, triangles 12 floats a slot as the triangle tree's,
// `leaf` slots a chunk), each volume's [first node, end), and per volume
// -1/density and raw material id.  n == 0: none.
struct MeshVols {
  Tree tree;  // nodes_f, nodes_i, chunk_len, geo; mat, nid, ord unused
  const int* bounds;
  const float* nid;
  const int* mat;
  int leaf;
  int n;
};

// How far the walk widens a node's interval [entry, exit] before it
// compares it with the bounds: kMvSlack of the larger of |entry| and
// |exit| (ops/bvh_kernel.MV_SLACK).  A ray that grazes a triangle gets a
// Moller-Trumbore t whose relative error grows as the ray turns parallel
// to it, and that t may lie a little outside the box's interval; the slack
// keeps such a triangle in the walk.
constexpr float kMvSlack = 0.03125f;

// One slab of a mesh volume's node box: the line's parameters at its two
// planes, in order; a NaN end ((lo - o) * inf, a line parallel to the slab
// that lies in one of its planes) reads as the whole line inside it.
__device__ __forceinline__ void mv_slab(float lo, float hi, float o,
                                        float inv, float& t_near,
                                        float& t_far) {
  const float a = (lo - o) * inv;
  const float b = (hi - o) * inv;
  if (a != a || b != b) {
    t_near = -INFINITY;
    t_far = INFINITY;
  } else {
    t_near = a < b ? a : b;
    t_far = a < b ? b : a;
  }
}

// How many crossings the entry walk keeps for the exit: a line crosses a
// convex boundary twice and a concave one a few times more; one that
// passes through an edge or a vertex crosses every triangle there
// (ops/bvh_kernel.MV_KEEP).
constexpr int kMvKeep = 4;

// The least raw t at or above `floor` of volume v's boundary triangles
// whose box the walk reaches, or inf, by a stackless walk of the volume's
// tree.  A node's interval [entry, exit] is its box's along the ray's
// whole line, at any sign, so a ray that starts inside the medium finds
// the crossings behind it (the trees' walk floors entry at T_MIN and
// cannot).  The walk descends into a node when entry <= exit and neither
// entry - slack > `bound` nor exit + slack < `floor` (`root_floor` at the
// volume's root), and tests a leaf's triangles with triangle_raw, as the
// JAX kernel's dense _mv_min_t tests every triangle.  The decisions do not
// depend on what the walk has found, so the plain version (ops/bvh_kernel
// _mv_walk) makes them level by level.  With bound inf and root_floor ==
// floor the answer is _mv_min_t's bit for bit: the minimum over the same
// candidates, each t from the same arithmetic, since the padded boxes and
// the slack never cut off a triangle the dense scan accepts.
//
// kKeep (the entry walk): the walk also keeps the first kMvKeep crossings
// it finds and the least entry - slack of a box it skipped for `bound`
// (no crossing in such a box lies below it), and sets `t2` to the least
// kept crossing at or past the answer + T_MIN when that is the least of
// all (every crossing kept, none skipped below it), else NaN: the exit
// walk is then needed.
template <bool kKeep>
__device__ __forceinline__ float mv_walk(const MeshVols& mv, int v,
                                         const Ray& r, float floor,
                                         float root_floor, float bound,
                                         float& t2) {
  const Tree& tr = mv.tree;
  const int first = __ldg(mv.bounds + 2 * v);
  const int end = __ldg(mv.bounds + 2 * v + 1);
  float best = INFINITY;
  float kept[kMvKeep];
  int n_kept = 0;
  float cut = INFINITY;
  int node = first;
  while (node < end) {
    const float* box = tr.nodes_f + 6 * node;
    float nx, fx, ny, fy, nz, fz;
    mv_slab(__ldg(box + 0), __ldg(box + 3), r.ox, r.idx, nx, fx);
    mv_slab(__ldg(box + 1), __ldg(box + 4), r.oy, r.idy, ny, fy);
    mv_slab(__ldg(box + 2), __ldg(box + 5), r.oz, r.idz, nz, fz);
    const float entry = fmaxf(fmaxf(nx, ny), nz);
    const float exit_ = fminf(fminf(fx, fy), fz);
    const float slack = kMvSlack * fmaxf(fabsf(entry), fabsf(exit_));
    const float lo = node == first ? root_floor : floor;
    const float near = entry - slack;
    const int* links = tr.nodes_i + 3 * node;
    const bool empty = !(entry <= exit_);
    if (empty || near > bound || exit_ + slack < lo) {
      if (kKeep && !empty && near > bound) cut = fminf(cut, near);
      node = __ldg(links + 1);
      continue;
    }
    const int chunk = __ldg(links + 2);
    if (chunk >= 0) {
      const int base = chunk * mv.leaf;
      const int n = __ldg(tr.chunk_len + chunk);
      for (int j = 0; j < n; ++j) {
        float tt;
        if (!(triangle_raw(tr.geo, base + j, r, tt) && tt >= floor)) continue;
        if (tt < best) best = tt;
        if (kKeep) {
#pragma unroll
          for (int k = 0; k < kMvKeep; ++k)  // registers, not a stack
            if (k == n_kept) kept[k] = tt;
          ++n_kept;
        }
      }
    }
    node = __ldg(links + 0);
  }
  if (kKeep) {
    const float past = best + kTMin;
    float t = INFINITY;
#pragma unroll
    for (int k = 0; k < kMvKeep; ++k)
      if (k < n_kept && kept[k] >= past && kept[k] < t) t = kept[k];
    t2 = n_kept <= kMvKeep && t <= cut ? t : NAN;
  }
  return best;
}

// Each mesh volume's candidate in index order (pallas_megakernel.py
// :1620-1671): the entry t1, the least raw t at any sign; the exit t2, the
// least t at or past t1 + T_MIN (from the crossings the entry walk kept,
// else by a second walk; none without an entry); the window
// [max(t1, T_MIN, 0), t2]; the free flight of uniform column fl.col0 + v,
// drawn only for a valid window; it replaces (t_best, win) when it ends
// inside the window and nearer than t_best.  The entry walk skips what
// cannot change that: a volume whose line crosses its root box only before
// T_MIN (then t2 < T_MIN: no window), and boxes that begin past t_best (a
// window that opens past t_best ends its free flight there too, -1/density
// being <= 0); what it then finds is the least t when that t is at most
// t_best, and otherwise a candidate that cannot win.
__device__ __forceinline__ void mesh_volume_scan(const MeshVols& mv,
                                                 const Ray& r, float& t_best,
                                                 int& win, const Flight& fl) {
  for (int v = 0; v < mv.n; ++v) {
    const float nid = __ldg(mv.nid + v);
    float t2;
    const float t1 = mv_walk<true>(mv, v, r, -INFINITY, kTMin,
                                   nid <= 0.0f ? t_best : INFINITY, t2);
    if (!(t1 < INFINITY)) continue;  // no entry: t2 would be inf too
    if (t2 != t2) {
      float unused;
      t2 = mv_walk<false>(mv, v, r, t1 + kTMin, t1 + kTMin, INFINITY,
                          unused);
    }
    float h1 = max_nan(t1, kTMin);
    if (!(t2 < INFINITY && h1 < t2)) continue;
    h1 = max_nan(h1, 0.0f);
    const float dist_inside = (t2 - h1) * fl.ray_len;
    const int c = fl.col0 + v;
    float u0, u1;
    uniform_pair(fl.k0, fl.k1, fl.ray, fl.stream, (uint32_t)c >> 1, u0, u1);
    const float u = (c & 1) ? u1 : u0;
    const float hit_dist = nid * logf(fmaxf(u, 1e-37f));
    const float ti = h1 + hit_dist / fl.ray_len;
    if (hit_dist <= dist_inside && ti < t_best) {
      t_best = ti;
      win = v;
    }
  }
}

// One slab of a small-tree node's box grown by the cone pad e: the line's
// parameters at its planes, lo - o = a and hi - o = b, moved out by e, in
// order; a NaN end reads as the whole line.
__device__ __forceinline__ void sub_slab(float a, float b, float e, float inv,
                                         float& t_near, float& t_far) {
  a = (a - e) * inv;
  b = (b + e) * inv;
  if (a != a || b != b) {
    t_near = -INFINITY;
    t_far = INFINITY;
  } else {
    t_near = a < b ? a : b;
    t_far = a < b ? b : a;
  }
}

// The small trees inside the chunks of a sphere or triangle tree
// (ops/bvh.build_sub_trees, ops/bvh_kernel.sub_boxes): per chunk `stride`
// nodes in DFS order, each a padded box as two float4 [min xyz, 0] and
// [max xyz, 0] computed from the rows the launch reads, and a word: its
// skip link (local to the chunk; its first child is the next node) in bits
// 0-7, its first member in the chunk's leaf order in bits 8-15, and for a
// leaf its member count from bit 16 (0: an inner node); the chunk's slots in
// leaf order, chunk-local.  boxes == nullptr: no small trees.
struct SubTree {
  const float4* boxes;
  const int* words;
  const unsigned char* order;
  int stride;
};

// The cone pad of sub_walk (ops/bvh_kernel.SUB_CONE), as a share of the
// farthest plane of a node's box from the ray's origin.
constexpr float kSubCone = 0x1p-8f;

// A chunk of at most kSubDense slots takes the dense loop in #5 too
// (ops/bvh_kernel.SUB_DENSE): its lanes test the same slots in lockstep,
// each a broadcast load, which beats a walk that skips few of them.
constexpr int kSubDense = 64;

// The least (t, slot) among the slots of chunk `chunk` that the dense leaf
// test accepts against `tb` (the walk's bound when it entered the chunk),
// into (c_best, c_win); slots tested only in the leaves of the chunk's
// small tree whose box the ray's line reaches.  A leaf's slots are tested
// in leaf order, not slot order, so a candidate replaces the best so far
// when nearer, or as near with a lower slot: whatever the order, the
// result is the dense loop's nearest, lowest slot among equals.
//
// The walk.  Each node's box grows by e = kSubCone * m on each side, m the
// largest of |plane - o| over its six planes (fmaxf: a NaN plane, whose
// slab reads as the whole line, does not count), and its interval along
// the ray's whole line is taken slab by slab, a slab with a NaN end
// ((plane - o) * inf: a line parallel to it and in one of its planes) as
// the whole line, so that a NaN never drops a box.  The walk goes into
// the node when entry <= exit, entry <= tb and exit >= T_MIN.  Those
// decisions read nothing the walk finds, so the plain twin
// (ops/bvh_kernel._sub_leaf) makes them a level at a time, op for op.
// Leaves are collected while the lanes of a warp traverse, and tested when
// the lanes have one each (the while-while loop of Aila and Laine), so a
// warp's lanes test their leaves together.
//
// Why no candidate of the dense test is cut off.  Let the dense test
// accept slot s at t_c in [T_MIN, tb] (a triangle: (T_MIN, tb]), and let
// p = o + t_c d in exact arithmetic.  If p lies in the node's box grown by
// e' < e, every slab's interval, rounded, holds t_c (each end is (plane -
// o -+ e) / d_i to a relative 2^-22 after the two roundings of plane - o
// -+ e, a shift of the plane by less than 2^-21 (m + e), far below
// e - e'), so entry <= t_c <= exit, entry <= tb and exit >= T_MIN: the
// node is entered.  The boxes hold every member's sphere (center -+ |r|)
// or triangle (its three vertices), rounded outward by the pad's 2^-20 of
// the chunk's largest coordinate.  It remains to bound how far p lies from
// the primitive, in units of m of any box that holds it:
// - A sphere.  With w = o - c (rounded), the direct quadratic
//   a t^2 + 2 hb t + cq, rounded in hb, cq and disc = hb^2 - a cq, has its
//   computed root t_c as an exact root of a quadratic whose coefficients
//   differ from the exact ones by at most 29 u (|w|^2 + r^2) in the
//   constant term (u = 2^-24; hb and a by 3 u relative, cq by
//   4 u (|w|^2 + r^2), disc by 17 u a (|w|^2 + r^2), the root's sqrt, sum
//   and division by 3 u).  So |p - c|^2 <= r^2 + 29 u (|w|^2 + r^2), and
//   p is within sqrt(29 u) sqrt(|w|^2 + r^2) <= sqrt(87 u) m < 2^-8.7 m of
//   the sphere (each |w_i| + r is at most m).  This is the grazing and
//   tangent case: a computed disc >= 0 where the true one is below 0, its
//   error growing with |w|^2 (the cancellation in cq = |w|^2 - r^2), which
//   the sqrt turns into a distance.  A pad fixed by the box could not hold
//   it for a far origin, nor a slack on t for a line parallel to an axis
//   (its slab in that axis is all or nothing): hence a pad that grows with
//   the origin's distance, each node's own (a chunk's root box may hold a
//   ground sphere of radius 1,000, which a pad from the root would spread
//   over every small box).
// - A ray that starts on a sphere's surface (after a bounce, t near
//   T_MIN), or inside it: the same bound; the far root -hb + sq cancels,
//   an absolute error of 3 u (|hb| + sq) / a in t, which moves p by less
//   than 2^-21 m along the ray.
// - A triangle.  Moller-Trumbore solves o + t d = v0 + u e1 + v e2 by
//   Cramer's rule; a grazing ray (det near 0) has t, u and v far from
//   their exact values, but the error lies along the system's near-null
//   direction, t and (u, v) moving together so that o + t d and
//   v0 + u e1 + v e2 both slide along d: p stays within a few ulps of
//   |o - v0|, over the sine of the triangle's smallest angle, of the point
//   v0 + u_c e1 + v_c e2, which the accepted u_c, v_c put inside the
//   triangle: below e for any angle above about 2^-12 rad.
// So p lies in every box on the way to s's leaf, grown by less than e.
//
// kAnyHit (#8's shadow rays): the walk ends at the first slot, in the
// order it tests them, whose candidate lies below tb, and leaves it in
// (c_best, c_win); without one it leaves them as they were.  So the chunk
// has a candidate below tb under this walk exactly when it has one under
// the dense test: a slot found here is found by the dense test, with the
// same arithmetic against the same bound, and the dense test's candidates
// all lie in leaves this walk enters.
template <int kKind, bool kAnyHit = false>
__device__ __forceinline__ void sub_walk(const Tree& tree,
                                         const SubTree& sub, int chunk,
                                         int leaf, const Ray& r, float tb,
                                         float& c_best, int& c_win) {
  const int base = chunk * leaf;
  const float4* box = sub.boxes + 2 * chunk * sub.stride;
  const int* words = sub.words + chunk * sub.stride;
  const int end = __ldg(words) & 0xff;  // the root's skip link
  int node = 0;
  while (node < end) {
    int found = 0;  // the word of a leaf to test
    while (node < end) {
      const float4 lo = __ldg(box + 2 * node), hi = __ldg(box + 2 * node + 1);
      const int word = __ldg(words + node);
      const float ax = lo.x - r.ox, ay = lo.y - r.oy, az = lo.z - r.oz;
      const float bx = hi.x - r.ox, by = hi.y - r.oy, bz = hi.z - r.oz;
      const float e = fmaxf(fmaxf(fmaxf(fabsf(ax), fabsf(bx)),
                                  fmaxf(fabsf(ay), fabsf(by))),
                            fmaxf(fabsf(az), fabsf(bz))) *
                      kSubCone;
      float nx, fx, ny, fy, nz, fz;
      sub_slab(ax, bx, e, r.idx, nx, fx);
      sub_slab(ay, by, e, r.idy, ny, fy);
      sub_slab(az, bz, e, r.idz, nz, fz);
      const float entry = fmaxf(fmaxf(nx, ny), nz);
      const float exit_ = fminf(fminf(fx, fy), fz);
      if (!(entry <= exit_ && entry <= tb && exit_ >= kTMin)) {
        node = word & 0xff;
        continue;
      }
      ++node;  // the first child, or past a leaf
      if (word >> 16) {
        found = word;
        break;
      }
    }
    const int start = (found >> 8) & 0xff;
    const int count = found >> 16;
    for (int j = 0; j < count; ++j) {
      const int s = base + __ldg(sub.order + base + start + j);
      const float ti = kKind == kSphereTree
                           ? sphere_t(tree.geo, s, r, tb)
                           : triangle_t(tree.geo, s, r, tb);
      if (kAnyHit && ti < tb) {  // the first candidate ends the walk
        c_best = ti;
        c_win = s;
        return;
      }
      if (!kAnyHit && (ti < c_best || (ti == c_best && s < c_win))) {
        c_best = ti;
        c_win = s;
      }
    }
  }
}

// The ray's stackless walk of one tree (_traverse_tree for one ray).  A
// leaf's winner is its nearest candidate, the lowest slot among equals; it
// replaces (t_best, win) only when strictly nearer (_merge_leaf_rows).
// kAnyHit: the walk ends at the first candidate nearer than t_best, the
// lowest slot of the first leaf that has one (the shadow-ray test).  `fl`
// is read by a volume tree's walk only.  kSub (the sphere and triangle
// trees of #5 and #8): inside a chunk of more than kSubDense slots the
// small tree's walk (sub_walk) in place of the dense loop over its slots;
// with kAnyHit its any-hit form, whose candidate, the first it finds,
// ends the walk as the dense loop's would.
template <int kKind, bool kAnyHit = false, bool kSub = false>
__device__ __forceinline__ void walk(const Tree& tree, int leaf,
                                     const Ray& r, float& t_best, int& win,
                                     const Flight& fl = Flight{},
                                     const SubTree& sub = SubTree{}) {
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
      int n = __ldg(tree.chunk_len + chunk);
      const float tb = t_best;  // the whole leaf tests against its entry t
      float c_best = INFINITY;
      int c_win = -1;
      if constexpr (kSub) {
        if (n > kSubDense) {
          sub_walk<kKind, kAnyHit>(tree, sub, chunk, leaf, r, tb, c_best,
                                   c_win);
          n = 0;  // no dense loop
        }
      }
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
