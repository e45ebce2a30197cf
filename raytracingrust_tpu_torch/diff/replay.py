"""Differentiable shading replay over the BVH kernel's recorded hits
(raytracingrust_tpu/diff/replay.py, ``replay_rows_radiance``).

The traversal is control flow with no derivative, but the gradient
estimator holds every discrete decision fixed (diff/grad.py), so the
gradient needs only the shading chain re-run over the hits the record walk
found.  Per bounce this reads the winner's fetched rows (ops/fetch.py: one
contiguous view a field, no gather), recomputes the hit distance and
normal with kernel #5's arithmetic (the direct quadratic with true
division, the direct Moller-Trumbore form, the flat normal of the row) and
shades through ops/megakernel.bounce_tail with the record's front-face,
metal and dielectric decisions in place of its comparisons.  Elementwise
PyTorch only; autograd differentiates it.
"""

from __future__ import annotations

import torch

from ..ops import megakernel as K
from ..ops.bvh_kernel import (REC_FRONT, REC_METAL_OK, REC_REFLECT, REC_SLOT,
                              TRI_DET_EPS)
from ..ops.fetch import MAT_FIELDS
from ..utils.rng import ray_uniforms
from ..utils.types import T_MIN

_dot3 = K._dot3


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def replay_rows_radiance(head, rows, kind, codes, key, ray_ids, px, py, *,
                         tri_base: int, has_spheres: bool,
                         has_triangles: bool, max_depth: int, bg_kind: int,
                         clay: bool) -> torch.Tensor:
    """Per-ray radiance (R, 3) over recorded hits, differentiable in the
    packed ``head`` and the fetched ``rows``.

    ``rows`` (G + 8, max_depth, R) and ``kind`` (max_depth, R) are
    ops/fetch.FetchRows' output for ``codes`` (max_depth, R), the record
    codes of the rays ``ray_ids``/``px``/``py``; ``tri_base`` is the code of
    triangle slot 0.  A miss row is all zeros: its normal and index of
    refraction are replaced by finite stand-ins, so no discarded lane puts a
    NaN into a gradient."""
    g_fields = rows.shape[0] - MAT_FIELDS
    o, d = K.camera_ray(head, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    for b in range(max_depth):
        raw = codes[b]
        hit = alive & (raw >= 0)
        slot = raw & REC_SLOT
        is_sph = hit & (slot < tri_base)
        is_tri = hit & (slot >= tri_base)
        f = rows[:, b]
        dx, dy, dz = d
        a = _dot3(dx, dy, dz, dx, dy, dz)
        t_hit = torch.ones_like(a)
        g3 = [f[0], f[1], f[2]]
        if has_spheres:  # the winner's root: the near one if past T_MIN
            r_s = f[3]
            oc = [o[c] - g3[c] for c in range(3)]
            hb = _dot3(*oc, dx, dy, dz)
            cq = _dot3(*oc, *oc) - r_s * r_s
            disc = hb * hb - a * cq
            sq = torch.sqrt(torch.where(is_sph, torch.clamp(disc, min=1e-24),
                                        1.0))
            t1 = (-hb - sq) / a
            t2 = (-hb + sq) / a
            t_hit = torch.where(is_sph, torch.where(t1 >= T_MIN, t1, t2),
                                t_hit)
        if has_triangles:
            v0, e1, e2 = ([f[k + c] for c in range(3)] for k in (0, 3, 6))
            h = _cross(d, e2)
            det = _dot3(*e1, *h)
            inv = 1.0 / torch.where(det.abs() > TRI_DET_EPS, det, 1.0)
            q = _cross([o[c] - v0[c] for c in range(3)], e1)
            t_hit = torch.where(is_tri, inv * _dot3(*e2, *q), t_hit)
        safe_t = torch.where(hit, t_hit, 1.0)
        pt = [o[c] + safe_t * d[c] for c in range(3)]
        if has_triangles:
            n = [f[9 + c] for c in range(3)]
        else:
            n = [torch.zeros_like(a)] * 3
        if has_spheres:
            r_div = torch.where(is_sph & (r_s > 0.0), r_s, 1.0)
            n = [torch.where(is_sph, (pt[c] - g3[c]) / r_div, n[c])
                 for c in range(3)]
        n = [torch.where(hit, n[c], float(c == 2)) for c in range(3)]
        mat = f[g_fields:].unbind(0)
        ir = mat[4]
        mat = mat[:4] + (torch.where(ir > 0.0, ir, 1.0),) + mat[5:]
        forced = {"front": ~hit | ((raw & REC_FRONT) != 0),
                  "metal_ok": (raw & REC_METAL_OK) != 0,
                  "reflect": (raw & REC_REFLECT) != 0}
        u = ray_uniforms(key, ray_ids, 1 + b, 3).unbind(-1)
        o, d, thr, rad, alive = K.bounce_tail(
            head, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n, mat,
            kind[b], u, forced=forced)
    return torch.stack(rad, dim=-1)
