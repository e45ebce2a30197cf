"""Chunk-leaf skip-link BVH builder, on the host in numpy
(raytracingrust_tpu/ops/bvh.py: ``primitive_bounds``,
``_build_chunked_topology``, ``build_chunked_bvh``).

The build policy is the reference's (BvhNode::from_list,
lib/core/bvh.rs:59-144): recursive median split on the axis of greatest
centroid spread, stable sort by centroid, split at len/2.  Leaves hold up to
``leaf_size`` primitives (a chunk).  Nodes are in DFS order with skip links,
so a walk needs no stack: a hit goes to ``hit_link``, a miss to
``miss_link``, and every link points forward; the walk ends at node K.
The arrays equal the JAX package's, node for node and slot for slot.

A mesh volume's boundary has a small tree of its own (:func:`build_mv_trees`,
the port's: the JAX package scans the boundary densely), which kernel #5's
crossing scan walks (csrc/bvh_walk.cuh ``mv_walk``).
"""

from __future__ import annotations

import numpy as np

from ..utils import aabb

# triangles a leaf of a mesh volume's tree holds.  A ray's line crosses a
# closed boundary at a few places, and small leaves keep its tests near
# them; a triangle test costs about as much as a node visit.  On an H100,
# #5's forward and record launches took 6-7% less time with leaves of 4
# than of 8 at a fog bounded by a 2,048-triangle icosphere, its views 2%
# (scripts/profile_mv_scan.py --leaf; PERF.md)
MV_LEAF = 4
# a mesh volume's node boxes grow on each side by MV_PAD of the volume's
# largest extent plus MV_PAD_COORD of its largest coordinate
MV_PAD = 2.0 ** -10
MV_PAD_COORD = 2.0 ** -20


def primitive_bounds(spheres, triangles):
    """Global primitive boxes: spheres [0, N) then triangles [N, N + T).
    A sphere's box is center -+ radius (lib/objects.rs:53-60); a triangle's
    is its vertex box grown to at least 0.01 a side
    (lib/core/mesh.rs:200-213)."""
    c = np.asarray(spheres.center, np.float32).reshape(-1, 3)
    r = np.asarray(spheres.radius, np.float32).reshape(-1, 1)
    v0 = np.asarray(triangles.v0, np.float32).reshape(-1, 3)
    e1 = np.asarray(triangles.e1, np.float32).reshape(-1, 3)
    e2 = np.asarray(triangles.e2, np.float32).reshape(-1, 3)
    v1, v2 = v0 + e1, v0 + e2
    tmin, tmax = aabb.epsilon_expand(np.minimum(v0, np.minimum(v1, v2)),
                                     np.maximum(v0, np.maximum(v1, v2)), 0.01)
    return (np.concatenate([c - r, tmin], axis=0),
            np.concatenate([c + r, tmax], axis=0))


def build_chunked_topology(mins: np.ndarray, maxs: np.ndarray,
                           leaf_size: int):
    """Median-split build with leaves of at most ``leaf_size`` primitives.

    Returns (nodes_f (K, 6) float32 [min xyz | max xyz],
             nodes_i (K, 3) int32 [hit_link, miss_link, chunk (-1 = inner)],
             perm (n_chunks * leaf_size,) int64 primitive ids, -1 = padding
             after each chunk's primitives)."""
    cent = aabb.centroid(mins, maxs)
    nodes_f: list[np.ndarray] = []
    hit: list[int] = []
    miss: list[int] = []
    chunk: list[int] = []
    chunks: list[np.ndarray] = []

    def split(ids):
        c = cent[ids]
        spread = c.max(axis=0) - c.min(axis=0)
        sx, sy, sz = float(spread[0]), float(spread[1]), float(spread[2])
        # the reference's tie-breaking (lib/core/bvh.rs:81-88)
        if sx > sy and sx > sz:
            axis = 0
        elif sy > sx and sy > sz:
            axis = 1
        else:
            axis = 2
        ids = ids[np.argsort(c[:, axis], kind="stable")]
        half = ids.shape[0] // 2
        return ids[:half], ids[half:]

    def emit(ids: np.ndarray) -> None:
        me = len(hit)
        nodes_f.append(np.concatenate([mins[ids].min(axis=0),
                                       maxs[ids].max(axis=0)]))
        if ids.shape[0] <= leaf_size:
            chunks.append(ids)
            hit.append(me + 1)  # a leaf goes on to its skip link either way
            miss.append(me + 1)
            chunk.append(len(chunks) - 1)
            return
        hit.append(me + 1)      # descend: the first child is next in DFS
        miss.append(-1)
        chunk.append(-1)
        left, right = split(ids)
        emit(left)
        emit(right)
        miss[me] = len(hit)     # skip: one past the whole subtree

    emit(np.arange(mins.shape[0], dtype=np.int64))
    perm = np.full((len(chunks), leaf_size), -1, np.int64)
    for i, ids in enumerate(chunks):
        perm[i, :ids.shape[0]] = ids
    return (np.stack(nodes_f).astype(np.float32),
            np.stack([hit, miss, chunk], axis=1).astype(np.int32),
            perm.reshape(-1))


def build_mv_trees(triangles, leaf_size: int = MV_LEAF) -> tuple:
    """One tree per mesh volume over its boundary triangles (the rows whose
    ``volume`` is its ordinal), in ordinal order: ChunkTrees whose ``perm``
    holds global triangle rows.  A leaf's box is its triangles' vertex box
    (v0, v0 + e1, v0 + e2 as the rows hold them); every node's box is then
    grown on each side by MV_PAD of the volume's largest extent plus
    MV_PAD_COORD of its largest coordinate, so a face of zero thickness
    gets a slab, and the line of a ray that the Moller-Trumbore test puts
    inside a triangle passes through its leaf's box despite rounding.  A
    volume without triangles gets a tree of no node."""
    from ..models.scene import ChunkTree

    v0 = np.asarray(triangles.v0, np.float32).reshape(-1, 3)
    v1 = v0 + np.asarray(triangles.e1, np.float32).reshape(-1, 3)
    v2 = v0 + np.asarray(triangles.e2, np.float32).reshape(-1, 3)
    lo = np.minimum(v0, np.minimum(v1, v2))
    hi = np.maximum(v0, np.maximum(v1, v2))
    vol = np.asarray(triangles.volume).reshape(-1)
    trees = []
    for v in range(int(vol.max()) + 1 if vol.size else 0):
        ids = np.nonzero(vol == v)[0].astype(np.int64)
        if ids.size == 0:
            trees.append(ChunkTree(np.zeros((0, 6), np.float32),
                                   np.zeros((0, 3), np.int32),
                                   np.zeros(0, np.int32), leaf_size))
            continue
        nf, ni, perm = build_chunked_topology(lo[ids], hi[ids], leaf_size)
        pad = np.float32(MV_PAD * float((nf[0, 3:] - nf[0, :3]).max())
                         + MV_PAD_COORD * float(np.abs(nf[0]).max()))
        nf = np.concatenate([nf[:, :3] - pad, nf[:, 3:] + pad], axis=1)
        live = perm >= 0
        perm = np.where(live, ids[np.maximum(perm, 0)], -1)
        trees.append(ChunkTree(nf.astype(np.float32), ni,
                               perm.astype(np.int32), leaf_size))
    return tuple(trees)


def build_chunked_bvh(spheres, triangles, leaf_size: int = 128):
    """-> ChunkedBVH: one tree over the solid spheres, one over the volume
    spheres (which sort last in the sphere arrays; its slots hold global
    sphere rows), one over the surface triangles (each None when it has no
    primitives), the mesh volumes' dense slots (``mv_perm``,
    ``mv_spans``): each volume's boundary triangles, in row order, padded
    to a whole number of chunks, and their trees (``mv_trees``,
    :func:`build_mv_trees`).  None for an empty scene."""
    from ..models.scene import ChunkedBVH, ChunkTree

    mins, maxs = primitive_bounds(spheres, triangles)
    ns = len(spheres)
    n_solid = ns - spheres.num_volumes
    if mins.shape[0] == 0:
        return None

    def tree(lo, hi, ids):
        if lo.shape[0] == 0:
            return None
        nf, ni, perm = build_chunked_topology(lo, hi, leaf_size)
        pad = perm < 0
        perm = ids[np.maximum(perm, 0)]
        perm[pad] = -1
        return ChunkTree(nf, ni, perm.astype(np.int32), leaf_size)

    # the boundary triangles of mesh volumes stay out of the surface tree
    tri_vol = triangles.volume.cpu().numpy()
    surf = np.nonzero(tri_vol < 0)[0].astype(np.int64)
    mv_parts, mv_spans, start = [], [], 0
    for v in range(int(tri_vol.max()) + 1 if tri_vol.size else 0):
        ids = np.nonzero(tri_vol == v)[0]
        n_chunks = -(-ids.shape[0] // leaf_size)
        part = np.full(n_chunks * leaf_size, -1, np.int32)
        part[:ids.shape[0]] = ids
        mv_parts.append(part)
        mv_spans.append((start, n_chunks))
        start += n_chunks
    return ChunkedBVH(
        spheres=tree(mins[:n_solid], maxs[:n_solid],
                     np.arange(n_solid, dtype=np.int64)),
        triangles=tree(mins[ns:][surf], maxs[ns:][surf], surf),
        volumes=tree(mins[n_solid:ns], maxs[n_solid:ns],
                     np.arange(n_solid, ns, dtype=np.int64)),
        mv_perm=(np.concatenate(mv_parts) if mv_parts
                 else np.zeros(0, np.int32)),
        mv_spans=tuple(mv_spans), mv_trees=build_mv_trees(triangles),
        leaf_size=leaf_size)
