"""Stackless walk of the flat skip-link BVH over a wavefront of rays
(raytracingrust_tpu/ops/traverse.py).

Every ray carries one node cursor into the DFS-ordered node array.  An
iteration advances every walking ray one node: a hit box goes on to
``hit_link`` (a leaf first tests its primitive), a missed box skips its
subtree by ``miss_link``; a ray is done when its cursor passes the last
node.  The slab test takes the ray's best t so far as its far bound
(ordered pruning) and one reciprocal of the direction a ray.

The boxes are those of the rows the scene holds when the walk runs
(:func:`node_boxes`), not the build's: a fit that moves a primitive moves
every box that holds it, so the walk finds what the dense scan finds.

The walk only decides which primitive wins, with no gradient: it runs on
detached rays, and after each iteration keeps only the rays still walking,
which changes no ray's winner (each ray's steps depend on its own state
alone).  The winner is intersected again outside the walk, with gradient,
in the direct form (``intersect.prim_t``), as the dense scan's winner is,
so both routes give the same hit bit for bit.  Volumes draw the same
uniform column a ray on either route.
"""

from __future__ import annotations

import torch

from ..utils import aabb
from ..utils.types import INF, T_MIN
from .intersect import Hit, make_hit, prim_t


def node_boxes(scene, nodes) -> tuple:
    """(K, 3) min and max corners of every node of the flat BVH ``nodes``
    from the rows ``scene`` holds now, with no gradient: a leaf's box is
    its primitive's, as ops/bvh.primitive_bounds gives it at the build (a
    sphere's centre -+ radius, a triangle's vertex box grown to 0.01 a
    side), an inner node's the union of its children's.  Until a row
    moves they equal the build's boxes bit for bit."""
    with torch.no_grad():
        sph, tri = scene.spheres, scene.triangles
        c, r = sph.center.detach(), sph.radius.detach()[:, None]
        v0 = tri.v0.detach()
        v1, v2 = v0 + tri.e1.detach(), v0 + tri.e2.detach()
        lo = torch.minimum(v0, torch.minimum(v1, v2))
        hi = torch.maximum(v0, torch.maximum(v1, v2))
        mid, thin = (lo + hi) * 0.5, hi - lo < 0.01
        lo = torch.where(thin, mid - 0.01, lo)
        hi = torch.where(thin, mid + 0.01, hi)
        leaf = nodes.prim.clamp(min=0)
        node_min = torch.cat([c - r, lo])[leaf]
        node_max = torch.cat([c + r, hi])[leaf]
        for at, first, second in nodes.levels:
            node_min[at] = torch.minimum(node_min[first], node_min[second])
            node_max[at] = torch.maximum(node_max[first], node_max[second])
    return node_min, node_max


def intersect_bvh(scene, o, d, u_vol, tmin=T_MIN) -> Hit:
    """Closest hit through ``scene.bvh`` -> Hit."""
    nodes = scene.bvh.nodes(scene)
    node_min, node_max = node_boxes(scene, nodes)
    k = nodes.prim.shape[0]
    r = o.shape[0]
    dev = o.device
    t_best = torch.full((r,), INF, device=dev)
    best = torch.full((r,), -1, dtype=torch.long, device=dev)
    with torch.no_grad():
        o_, d_, u_ = o.detach(), d.detach(), u_vol.detach()
        inv_d = 1.0 / d_
        node = torch.zeros(r, dtype=torch.long, device=dev)
        at = torch.arange(r, device=dev)  # the rays still walking
        hit_link, miss_link = nodes.hit_link, nodes.miss_link
        prim_of = nodes.prim
        while at.numel():
            ni = node[at]
            oa, tb = o_[at], t_best[at]
            box_hit, _ = aabb.slab_hit(node_min[ni], node_max[ni], oa,
                                       inv_d[at], tmin, tb)
            prim = prim_of[ni]
            test = (box_hit & (prim >= 0)).nonzero().squeeze(1)
            if test.numel():
                rays = at[test]
                t_p = prim_t(scene, prim[test], o_[rays], d_[rays], u_[rays],
                             tmin, tb[test])
                better = t_p < tb[test]
                t_best[rays] = torch.where(better, t_p, tb[test])
                best[rays] = torch.where(better, prim[test], best[rays])
            nxt = torch.where(box_hit, hit_link[ni], miss_link[ni])
            node[at] = nxt
            at = at[nxt < k]
    # the winner again, outside the walk and with gradient (tmax inf picks
    # the same root of the winning primitive)
    winner = torch.clamp(best, min=0)
    t = prim_t(scene, winner, o, d, u_vol, tmin, INF)
    t = torch.where(best >= 0, t, INF)
    return make_hit(scene, o, d, t, winner)
