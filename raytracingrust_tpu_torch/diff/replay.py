"""Differentiable shading replay over the BVH kernel's recorded hits
(raytracingrust_tpu/diff/replay.py, ``replay_rows_radiance`` and the
volume, mesh-volume and mix branches of ``replay_radiance``).

The traversal is control flow with no derivative, but the gradient
estimator holds every discrete decision fixed (diff/grad.py), so the
gradient needs only the shading chain re-run over the hits the record walk
found.  Per bounce this reads the winner's fetched rows (ops/fetch.py: one
contiguous view a field, no gather), recomputes the hit distance and
normal with kernel #5's arithmetic (the direct quadratic with true
division; for a volume the entry of the boundary window plus the free
flight of the volume's own uniform, with the dummy normal (1, 0, 0); the
direct Moller-Trumbore form and the flat normal of the row; for a mesh
volume the crossing scan of its boundary over detached rays, chunk by
chunk, and its free flight, with no gradient in the boundary's vertices,
as in the JAX package), resolves a
mix with the bounce's coins (ops/shade.resolve_mix) and shades through
ops/megakernel.bounce_tail with the record's front-face, metal and
dielectric decisions in place of its comparisons.  In a scene with mixes
the fetch is raw (the winner's raw material id, no material rows) and the
resolved leaf's material row is read from the table by ``index_select``,
whose backward (``index_add_``) gives the table's gradient.  Elementwise PyTorch only; autograd
differentiates it.

With a sky map (``sky``) a miss adds the sky's texel times the
throughput.  With the shadow-ray test ``occlude`` as well it assembles the
one-sample MIS estimator of the HDRI importance-sampling path instead (the
JAX ``replay_radiance(env=...)``,
op for op render/integrator.py's env blocks): a miss adds the sky's
radiance times the balance weight against the sky sampler's pdf when the
last scatter was diffuse; after a Lambertian hit it also draws one sky
direction from the NEE stream, asks ``occlude`` (kernel #8) whether the
shadow ray is blocked, and adds the weighted sky radiance if not.  The
record walk's path is the estimator's path: next-event estimation adds
terms and changes no bounce.
"""

from __future__ import annotations

import torch

from ..ops import megakernel as K
from ..ops.bvh_kernel import (REC_FRONT, REC_METAL_OK, REC_REFLECT, REC_SLOT,
                              TRI_DET_EPS, _mv_min_t, bounce_uniforms)
from ..models import materials as M
from ..models.backgrounds import sample_skymap_direction
from ..ops.fetch import MAT_FIELDS
from ..ops.shade import resolve_mix
from ..utils import vec
from ..utils.rng import ray_uniforms
from ..utils.types import PI, T_MIN

_dot3 = K._dot3


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _mesh_volume_t(sc, o, d, u_vol, code, is_mv):
    """(R,) the recorded mesh-volume winners' hit distance, 1 elsewhere
    (the JAX replay's mesh-volume branch): the volume's crossing scan over
    detached rays, chunk by chunk (``_mv_min_t``, no (R, T) matrix), and
    the free flight of its own uniform column from the window's entry.  A
    winner whose recomputed t is not finite falls back to 1.  Detached:
    the boundary's vertices and the density get no gradient."""
    mv = sc.mesh_vols
    t = torch.ones_like(d[0])
    with torch.no_grad():
        for v, (start, count) in enumerate(mv.spans):
            at = (is_mv & (code == sc.mv_base + v)).nonzero().squeeze(1)
            if at.numel() == 0:
                continue
            o_a, d_a = [x[at] for x in o], [x[at] for x in d]
            t1 = _mv_min_t(mv, start, count, o_a, d_a,
                           torch.full((at.numel(),), float("-inf"),
                                      device=t.device), None)
            h1 = torch.clamp(torch.clamp(t1, min=T_MIN), min=0.0)
            ray_len = torch.sqrt(_dot3(*d_a, *d_a))
            hit_dist = mv.nid[v] * torch.log(
                torch.clamp(u_vol[at, sc.n_vol + v], min=1e-37))
            t_v = h1 + hit_dist / ray_len
            t[at] = torch.where(torch.isfinite(t_v), t_v, 1.0)
    return t


def replay_rows_radiance(sc, rows, kind, codes, key, ray_ids, px, py, *,
                         max_depth: int, bg_kind: int, clay: bool, sky=None,
                         occlude=None) -> torch.Tensor:
    """Per-ray radiance (R, 3) over recorded hits, differentiable in the
    packed head ``sc.head`` and the fetched ``rows`` (and, with mixes, in
    the material table ``sc.mats``).

    ``sc`` is the packed scene (ops/bvh_kernel.BvhScene): the head, the
    code bases of its trees, the volumes' densities and ordinals, the mix
    table.  ``rows`` (F, max_depth, R) and ``kind`` (max_depth, R) are
    ops/fetch.FetchRows' output for ``codes`` (max_depth, R), the record
    codes of the rays ``ray_ids``/``px``/``py``: F = G + 8 fields, or G in
    raw mode (``sc.mixes`` set), where ``kind`` holds the raw material id.
    A miss row is all zeros: its normal and index of refraction are replaced
    by finite stand-ins, so no discarded lane puts a NaN into a gradient.

    ``sky``, a SKYMAP Background on the rays' device (``bg_kind``
    SKYMAP), adds its texel on a miss; it is differentiable in the sky's
    texels.  With ``occlude`` it switches on the MIS estimator (Full mode):
    ``occlude(points (3, R'), directions (3, R'), ray ids (R',), stream)``
    -> (R',) bool answers the shadow rays of one bounce, those of its
    Lambertian hits that go on.  The sampled directions, their pdfs, the
    shadow rays and the MIS pdfs are detached, as in the JAX package.
    Without ``occlude`` a miss adds the texel at weight 1 and no pdf is
    computed: a sky map without importance sampling."""
    head = sc.head
    raw = sc.mixes is not None
    g_fields = rows.shape[0] - (0 if raw else MAT_FIELDS)
    has_sph_rows = sc.spheres is not None or sc.volumes is not None
    vol_base, tri_base, mv_base = sc.vol_base, sc.tri_base, sc.mv_base
    vols, mvs = sc.volumes, sc.mesh_vols
    o, d = K.camera_ray(head, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    mis_pdf = torch.zeros_like(one)  # 0: no MIS for primary rays
    for b in range(max_depth):
        raw_code = codes[b]
        hit = alive & (raw_code >= 0)
        slot = raw_code & REC_SLOT
        is_sph = hit & (slot < vol_base)
        is_vol = None if vols is None else hit & (slot >= vol_base) & (
            slot < tri_base)
        is_mv = hit & (slot >= mv_base) if mvs is not None else None
        is_tri = hit & (slot >= tri_base) & (slot < mv_base)
        f = rows[:, b]
        dx, dy, dz = d
        a = _dot3(dx, dy, dz, dx, dy, dz)
        coins, u, u_vol = bounce_uniforms(sc, key, ray_ids, b)
        t_hit = torch.ones_like(a)
        g3 = [f[0], f[1], f[2]]
        if has_sph_rows:  # a sphere's or a volume's boundary quadratic
            is_q = is_sph if vols is None else is_sph | is_vol
            r_s = f[3]
            oc = [o[c] - g3[c] for c in range(3)]
            hb = _dot3(*oc, dx, dy, dz)
            cq = _dot3(*oc, *oc) - r_s * r_s
            disc = hb * hb - a * cq
            sq = torch.sqrt(torch.where(is_q, torch.clamp(disc, min=1e-24),
                                        1.0))
            t1 = (-hb - sq) / a
            t2 = (-hb + sq) / a
            # the winner's root: the near one if past T_MIN
            t_hit = torch.where(is_sph, torch.where(t1 >= T_MIN, t1, t2),
                                t_hit)
        if vols is not None:
            # the window's entry plus the free flight of the winner's own
            # uniform column (_vol_chunk_hit's arithmetic)
            v = torch.where(is_vol, slot - vol_base, 0).long()
            uu = u_vol.gather(1, vols.ordinal[v].long()[:, None])[:, 0]
            ray_len = torch.sqrt(a)
            h1 = torch.clamp(torch.clamp(t1, min=T_MIN), min=0.0)
            hit_dist = vols.nid[v] * torch.log(torch.clamp(uu, min=1e-37))
            t_hit = torch.where(is_vol, h1 + hit_dist / ray_len, t_hit)
        if sc.triangles is not None:
            v0, e1, e2 = ([f[k + c] for c in range(3)] for k in (0, 3, 6))
            h = _cross(d, e2)
            det = _dot3(*e1, *h)
            inv = 1.0 / torch.where(det.abs() > TRI_DET_EPS, det, 1.0)
            q = _cross([o[c] - v0[c] for c in range(3)], e1)
            t_hit = torch.where(is_tri, inv * _dot3(*e2, *q), t_hit)
        if mvs is not None:
            t_hit = torch.where(is_mv, _mesh_volume_t(sc, o, d, u_vol, slot,
                                                      is_mv), t_hit)
        safe_t = torch.where(hit, t_hit, 1.0)
        pt = [o[c] + safe_t * d[c] for c in range(3)]
        if sc.triangles is not None:
            n = [f[9 + c] for c in range(3)]
        else:
            n = [torch.zeros_like(a)] * 3
        if has_sph_rows:
            r_div = torch.where(is_sph & (r_s > 0.0), r_s, 1.0)
            n = [torch.where(is_sph, (pt[c] - g3[c]) / r_div, n[c])
                 for c in range(3)]
        for is_fog in (is_vol, is_mv):  # the dummy normal (1, 0, 0)
            if is_fog is not None:
                n = [torch.where(is_fog, float(c == 0), n[c])
                     for c in range(3)]
        n = [torch.where(hit, n[c], float(c == 2)) for c in range(3)]
        if raw:  # resolve the winner's mix, then read its leaf's row
            mid = resolve_mix(sc.mixes, kind[b].clamp(min=0), coins)
            # index_select: its backward is index_add_, whose atomics take
            # the millions of rows a few materials share; the backward of
            # mats[mid] sorts them and sums each material's run serially
            mat = sc.mats.index_select(0, mid).unbind(-1)
            kind_b = torch.where(hit, sc.kinds[mid], -1)
        else:
            mat = f[g_fields:].unbind(0)
            kind_b = kind[b]
        ir = mat[4]
        mat = mat[:4] + (torch.where(ir > 0.0, ir, 1.0),) + mat[5:]
        forced = {"front": ~hit | ((raw_code & REC_FRONT) != 0),
                  "metal_ok": (raw_code & REC_METAL_OK) != 0,
                  "reflect": (raw_code & REC_REFLECT) != 0}
        if sky is not None:
            rad = _env_miss(sky, d, thr, rad, alive & ~hit,
                            None if occlude is None else mis_pdf)
            thr_in = thr
        o, d, thr, rad, alive = K.bounce_tail(
            head, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n, mat,
            kind_b, u, forced=forced)
        if occlude is not None:
            sgn = torch.where(forced["front"], 1.0, -1.0)
            rad, mis_pdf = _env_nee(
                sky, occlude, key, ray_ids, b, max_depth, thr_in, rad,
                alive & (kind_b == M.LAMBERTIAN), pt, [v * sgn for v in n],
                mat[0:3], d)
    return torch.stack(rad, dim=-1)


def _env_miss(sky, d, thr, rad, missed, mis_pdf):
    """``rad`` plus, on a miss, the sky's radiance times the balance weight
    of the BSDF-sampled direction (1 after a primary or specular bounce,
    and everywhere without MIS: ``mis_pdf`` None)."""
    dv = torch.stack(d, dim=-1)
    bg = sky.sample(dv)
    if mis_pdf is not None:
        p_env = sky.pdf(vec.normalize(dv.detach()))
        w_b = torch.where(mis_pdf > 0.0, mis_pdf / (mis_pdf + p_env), 1.0)
        bg = bg * w_b[:, None]
    return [rad[c] + torch.where(missed, thr[c] * bg[:, c], 0.0)
            for c in range(3)]


def _env_nee(sky, occlude, key, ray_ids, b, max_depth, thr, rad, diffuse,
             pt, n, albedo, new_dir):
    """Next-event estimation toward the sky at bounce ``b``: -> (rad plus
    the NEE terms of the ``diffuse`` rays, the MIS pdf of each ray's next
    direction).  ``thr`` is the throughput entering the bounce, ``n`` the
    front-facing normal, ``new_dir`` the scattered direction."""
    stream = 1 + max_depth + b  # the NEE stream
    un = ray_uniforms(key, ray_ids, stream, 2)
    d_l, p_l = sample_skymap_direction(sky, un[:, 0], un[:, 1])
    nv = torch.stack(n, dim=-1)
    cos_l = torch.clamp(vec.dot(nv, d_l), min=0.0)
    blocked = torch.ones_like(diffuse)
    at = diffuse.nonzero().squeeze(1)
    if at.numel():
        p = torch.stack(pt).detach()
        blocked[at] = occlude(p[:, at].contiguous(),
                              d_l.T[:, at].contiguous(),
                              ray_ids[at].contiguous(), stream)
    w_l = p_l / (p_l + cos_l / PI)
    light = sky.sample(d_l)
    scale = cos_l / PI / torch.clamp(p_l, min=1e-12) * w_l
    take = diffuse & ~blocked & (cos_l > 0.0)
    rad = [rad[c] + torch.where(take, thr[c] * albedo[c] * light[:, c]
                                * scale, 0.0) for c in range(3)]
    nd = torch.stack(new_dir, dim=-1).detach()
    cos_n = torch.clamp(vec.dot(nv.detach(), vec.normalize(nd)), min=0.0)
    return rad, torch.where(diffuse, cos_n / PI, 0.0)
