"""Ray/primitive intersection of the generic engine
(raytracingrust_tpu/ops/intersect.py), eager PyTorch on (R, 3) rays.

A wavefront of R rays tests all N primitives at once.  The all-pairs terms
of both tests are 3-term dot products over every (ray, primitive) pair:

  * sphere:    d.c and o.c for the expanded quadratic;
  * triangle:  every Moller-Trumbore determinant is a scalar triple
               product, bilinear in the ray's (o, d, w = o x d) and a
               constant vector of the triangle (:func:`triangle_constants`).

They are written elementwise, x + y + z in float32 (:func:`_dot_t`), which
is how the JAX package's ``jnp.dot`` at ``Precision.HIGHEST`` computes them
on the CPU at XLA's backend optimisation level 0, and on the card no
TF32 or fused multiply-add enters (each product and sum is its own
kernel).  Those all-pairs distances only choose each ray's winner: the
winner's distance is computed again in the direct single-primitive form
(:func:`prim_t`), with gradient.  So the all-pairs pass runs without
autograd, and only a mesh volume's winner, which has no single-primitive
form, runs its boundary's crossing scan again with gradient on the rays it
won.

Quirks as in the JAX package: ``tmax`` is honoured and the triangle test
has a determinant epsilon (Q5); normals are the flat face normals (Q6).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import vec
from ..utils.types import INF, T_MIN

# determinant epsilon of the triangle test (the reference used tmin, Q5)
TRI_DET_EPS = 1e-8


@dataclasses.dataclass
class Hit:
    """Batched HitRecord (lib/utils/ray.rs:29-55).  ``prim`` is the global
    primitive id ([0, N) spheres, [N, N + T) triangles, then the mesh
    volumes), -1 on a miss."""

    t: torch.Tensor           # (R,)
    prim: torch.Tensor        # (R,) int64
    material: torch.Tensor    # (R,) int64
    point: torch.Tensor       # (R, 3)
    normal: torch.Tensor      # (R, 3) front-face flipped, as HitRecord::new
    front_face: torch.Tensor  # (R,) bool

    @property
    def hit(self) -> torch.Tensor:
        return self.prim >= 0


def _dot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 3) x (N, 3) -> (R, N) dot products, x + y + z in float32."""
    return (a[:, 0:1] * b[None, :, 0] + a[:, 1:2] * b[None, :, 1]
            + a[:, 2:3] * b[None, :, 2])


# --- compensated float32 (Dekker/Veltkamp, no fma) ---------------------------
#
# The expanded quadratic needs the per-sphere constant |c|^2 - r^2.  Plain
# float32 rounds |c|^2 at |c|^2 * eps (~6e-4 for the RTiOW ground sphere), a
# constant bias at the scale of the t ~ T_MIN self-intersection decision of a
# ray leaving that sphere.  Exact two-products and two-sums remove it.  The
# operations are kept one for one: a compiler that fused them would contract
# the error terms away, so nothing here runs under torch.compile.

def _split_f32(x):
    """Veltkamp split: x == hi + lo with 12-bit-mantissa halves (exact)."""
    c = x * 4097.0  # 2^12 + 1
    hi = c - (c - x)
    return hi, x - hi


def _two_prod(x, y):
    """(p, e) with p = fl(x * y) and p + e == x * y exactly."""
    p = x * y
    xh, xl = _split_f32(x)
    yh, yl = _split_f32(y)
    e = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, e


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _cc_rr_compensated(center, radius):
    """|c|^2 - r^2 as a (hi, lo) float32 pair, accurate to ~|result| eps."""
    s0, e0 = _two_prod(center[:, 0], center[:, 0])
    s1, e1 = _two_prod(center[:, 1], center[:, 1])
    s2, e2 = _two_prod(center[:, 2], center[:, 2])
    rr, er = _two_prod(radius, radius)
    t01, g01 = _two_sum(s0, s1)
    t012, g012 = _two_sum(t01, s2)
    hi, g_r = _two_sum(t012, -rr)
    lo = ((e0 + e1 + e2) - er) + ((g01 + g012) + g_r)
    return hi, lo


# ------------------------------------------------------------------ spheres

def sphere_ts(spheres, o, d, u_vol, tmin, tmax):
    """All-pairs sphere hit distances -> (R, N), +inf for a miss.

    A solid sphere takes Sphere::hit (lib/objects.rs:22-51): the near root
    in [tmin, tmax], else the far one.  A volume's boundary sphere (the
    last ``num_volumes`` rows) takes Volume::hit (lib/volume.rs:35-73):
    the exponential free flight between the two boundary roots, from its
    own column of ``u_vol`` (R, num_volumes).
    """
    r_ = spheres.radius
    a = vec.length_squared(d)[:, None]
    od = vec.dot(o, d)[:, None]
    cd = _dot_t(d, spheres.center)
    oc = _dot_t(o, spheres.center)
    oo = vec.length_squared(o)[:, None]
    cc_hi, cc_lo = _cc_rr_compensated(spheres.center, r_)

    half_b = od - cd
    c_quad = (oo - 2.0 * oc + cc_hi[None, :]) + cc_lo[None, :]
    disc = half_b * half_b - a * c_quad
    ok = disc >= 0.0
    # double-where: sqrt'(0) = inf would give 0 * inf = nan in the rejected
    # lanes' gradient
    sqrtd = torch.sqrt(torch.where(ok, disc, 1.0))
    sqrtd = torch.where(ok, sqrtd, 0.0)
    inv_a = 1.0 / a
    t1 = (-half_b - sqrtd) * inv_a
    t2 = (-half_b + sqrtd) * inv_a

    in1 = (t1 >= tmin) & (t1 <= tmax)
    in2 = (t2 >= tmin) & (t2 <= tmax)
    t_solid = torch.where(in1, t1, torch.where(in2, t2, INF))
    t_solid = torch.where(ok, t_solid, INF)

    nv = spheres.num_volumes
    if nv == 0:
        return t_solid
    ns = len(spheres) - nv
    t1v, t2v, okv = t1[:, ns:], t2[:, ns:], ok[:, ns:]
    # the boundary's near root on (-inf, inf), its far root past it
    h2 = torch.where(t2v >= t1v + tmin, t2v, INF)
    h1 = torch.clamp(t1v, min=tmin)
    h2 = torch.clamp(h2, max=tmax)
    valid = okv & (h1 < h2)
    h1 = torch.clamp(h1, min=0.0)
    ray_len = torch.sqrt(a)
    dist_inside = (h2 - h1) * ray_len
    hit_dist = spheres.neg_inv_density[None, ns:] * torch.log(
        torch.clamp(u_vol, min=1e-37))
    t_vol = h1 + hit_dist / ray_len
    t_vol = torch.where(valid & (hit_dist <= dist_inside), t_vol, INF)
    return torch.cat([t_solid[:, :ns], t_vol], dim=1)


def sphere_normal(spheres, prim, point):
    """Outward normal (p - c) / r of each ray's sphere ``prim``
    (lib/objects.rs:48), or a volume's dummy (1, 0, 0)
    (lib/volume.rs:66-72)."""
    outward = (point - spheres.center[prim]) / spheres.radius[prim][:, None]
    is_vol = spheres.neg_inv_density[prim] != 0.0
    dummy = outward.new_tensor([1.0, 0.0, 0.0])
    return torch.where(is_vol[:, None], dummy, outward)


# ---------------------------------------------------------------- triangles

def triangle_constants(triangles):
    """Per-triangle constant vectors of the all-pairs test: n = e1 x e2,
    v0 x e2, v0 x e1 and v0 . n."""
    n = vec.cross(triangles.e1, triangles.e2)
    v0xe2 = vec.cross(triangles.v0, triangles.e2)
    v0xe1 = vec.cross(triangles.v0, triangles.e1)
    return n, v0xe2, v0xe1, vec.dot(triangles.v0, n)


def triangle_ts_raw(triangles, o, d):
    """All-pairs Moller-Trumbore with no t range -> (t (R, T), geometric
    hit (R, T)).  A volume's boundary crossings need hits at any t: the
    ray may start inside the medium (lib/volume.rs: boundary.hit over
    (-inf, inf))."""
    n, v0xe2, v0xe1, v0n = triangle_constants(triangles)
    w = vec.cross(o, d)
    a = -_dot_t(d, n)
    num_u = _dot_t(w, triangles.e2) + _dot_t(d, v0xe2)
    num_v = -(_dot_t(w, triangles.e1) + _dot_t(d, v0xe1))
    num_t = _dot_t(o, n) - v0n[None, :]
    f = 1.0 / a
    u = f * num_u
    v = f * num_v
    t = f * num_t
    geo = ((a.abs() > TRI_DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0))
    return t, geo


def triangle_ts(triangles, o, d, tmin, tmax):
    """All-pairs Moller-Trumbore -> (R, T) hit distances, +inf for a
    miss."""
    t, geo = triangle_ts_raw(triangles, o, d)
    return torch.where(geo & (t > tmin) & (t <= tmax), t, INF)


def _rows(triangles, at):
    return dataclasses.replace(triangles, **{
        f.name: getattr(triangles, f.name)[at]
        for f in dataclasses.fields(triangles)})


def mesh_volume_ts(scene, o, d, u_mesh, tmin, tmax):
    """Free-flight hit distances of the mesh-bounded media -> (R, V), +inf
    for a miss.  Per volume: the first crossing of its boundary at any t
    and the next one strictly past it (the reference's two nested
    ``boundary.hit`` calls, lib/volume.rs:35-53), then the sphere volume's
    free flight from the volume's own column of ``u_mesh``.  Each volume
    tests its own triangles only: the others' distances are +inf in the
    JAX package's scan, so the minima are the same."""
    tris = scene.triangles
    ray_len = torch.sqrt(vec.length_squared(d))
    cols = []
    for v in range(scene.num_mesh_volumes):
        tv, geo = triangle_ts_raw(
            _rows(tris, (tris.volume == v).nonzero().squeeze(1)), o, d)
        tv = torch.where(geo, tv, INF)
        t1 = tv.amin(dim=1)
        t2 = torch.where(tv >= t1[:, None] + tmin, tv, INF).amin(dim=1)
        h1 = torch.clamp(t1, min=tmin)
        h2 = torch.clamp(t2, max=tmax)
        valid = torch.isfinite(t1) & torch.isfinite(t2) & (h1 < h2)
        h1 = torch.clamp(h1, min=0.0)
        dist_inside = (h2 - h1) * ray_len
        nid = scene.mesh_volumes.neg_inv_density[v]
        hit_dist = nid * torch.log(torch.clamp(u_mesh[:, v], min=1e-37))
        t_v = h1 + hit_dist / ray_len
        cols.append(torch.where(valid & (hit_dist <= dist_inside), t_v, INF))
    return torch.stack(cols, dim=1)


# ------------------------------------------------- single primitive a ray

def gather_sphere_t(spheres, sidx, o, d, u_vol, tmin, tmax):
    """Each ray's distance to its own sphere ``sidx`` in the direct
    (o - c) form, the canonical one: the expanded form only finds the
    winner."""
    c = spheres.center[sidx]
    r = spheres.radius[sidx]
    oc = o - c
    a = vec.length_squared(d)
    half_b = vec.dot(oc, d)
    cq = vec.length_squared(oc) - r * r
    disc = half_b * half_b - a * cq
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))  # double-where, as above
    sq = torch.where(ok, sq, 0.0)
    t1 = (-half_b - sq) / a
    t2 = (-half_b + sq) / a
    in1 = (t1 >= tmin) & (t1 <= tmax)
    in2 = (t2 >= tmin) & (t2 <= tmax)
    t_solid = torch.where(ok & in1, t1, torch.where(ok & in2, t2, INF))

    nv = spheres.num_volumes
    if nv == 0:
        return t_solid
    ordinal = torch.clamp(sidx - (len(spheres) - nv), 0, nv - 1)
    uu = u_vol.gather(1, ordinal[:, None])[:, 0]
    h1 = torch.clamp(t1, min=tmin)
    h2 = torch.where(t2 >= t1 + tmin, t2, INF)
    h2 = torch.clamp(h2, max=tmax)
    valid = ok & (h1 < h2)
    h1 = torch.clamp(h1, min=0.0)
    ray_len = torch.sqrt(a)
    dist_inside = (h2 - h1) * ray_len
    nid = spheres.neg_inv_density[sidx]
    hit_dist = nid * torch.log(torch.clamp(uu, min=1e-37))
    t_vol = h1 + hit_dist / ray_len
    t_vol = torch.where(valid & (hit_dist <= dist_inside), t_vol, INF)
    return torch.where(nid != 0.0, t_vol, t_solid)


def gather_triangle_t(triangles, tidx, o, d, tmin, tmax):
    """Each ray's distance to its own triangle ``tidx``: Moller-Trumbore
    in its classic cross-product form."""
    v0, e1, e2 = triangles.v0[tidx], triangles.e1[tidx], triangles.e2[tidx]
    h = vec.cross(d, e2)
    a = vec.dot(e1, h)
    f = 1.0 / a
    s = o - v0
    u = f * vec.dot(s, h)
    q = vec.cross(s, e1)
    v = f * vec.dot(d, q)
    t = f * vec.dot(e2, q)
    valid = ((a.abs() > TRI_DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > tmin) & (t <= tmax))
    return torch.where(valid, t, INF)


def prim_t(scene, prim, o, d, u_vol, tmin, tmax):
    """Each ray's distance to its own candidate primitive ``prim`` (ids
    clamped into range for the gathers; callers mask)."""
    ns, nt = len(scene.spheres), len(scene.triangles)
    t = torch.full(prim.shape, INF, device=o.device)
    if ns > 0:
        t_s = gather_sphere_t(scene.spheres, torch.clamp(prim, 0, ns - 1),
                              o, d, u_vol, tmin, tmax)
        t = torch.where(prim < ns, t_s, t)
    if nt > 0:
        t_t = gather_triangle_t(scene.triangles,
                                torch.clamp(prim - ns, 0, nt - 1), o, d,
                                tmin, tmax)
        t = torch.where(prim >= ns, t_t, t)
    return t


# ------------------------------------------------------------------- merge

def make_hit(scene, o, d, t, best) -> Hit:
    """The winning Hit from each ray's (t, global primitive id).  A miss
    gets safe placeholder geometry (t = 1, normal +z) rather than inf: a
    non-finite value in a branch that ``where`` discards still gives nan in
    the gradient (0 * nan)."""
    ns, nt = len(scene.spheres), len(scene.triangles)
    missed = ~torch.isfinite(t)
    prim = torch.where(missed, -1, best)
    safe_t = torch.where(missed, 1.0, t)
    point = o + safe_t[:, None] * d

    is_sphere = best < ns
    if ns > 0:
        sidx = torch.clamp(best, 0, ns - 1)
        outward = sphere_normal(scene.spheres, sidx, point)
        mat = scene.spheres.material[sidx].long()
    else:
        outward = torch.zeros_like(o)
        mat = torch.zeros(o.shape[:-1], dtype=torch.long, device=o.device)
    if nt > 0:
        tidx = torch.clamp(best - ns, 0, nt - 1)
        outward = torch.where(is_sphere[:, None], outward,
                              scene.triangles.normal[tidx])
        mat = torch.where(is_sphere, mat,
                          scene.triangles.material[tidx].long())
    n_mv = scene.num_mesh_volumes
    if n_mv:
        # a mesh volume's winner: its phase material and the dummy normal
        # (1, 0, 0) (lib/volume.rs:66-72)
        is_mv = best >= ns + nt
        vidx = torch.clamp(best - ns - nt, 0, n_mv - 1)
        mat = torch.where(is_mv, scene.mesh_volumes.material[vidx].long(),
                          mat)
        outward = torch.where(is_mv[:, None],
                              outward.new_tensor([1.0, 0.0, 0.0]), outward)
    outward = torch.where(missed[:, None], outward.new_tensor([0.0, 0.0, 1.0]),
                          outward)
    # HitRecord::new's front-face flip (lib/utils/ray.rs:39-54)
    front_face = vec.dot(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    t = torch.where(missed, INF, t)
    return Hit(t=t, prim=prim, material=mat, point=point, normal=normal,
               front_face=front_face)


def empty_hit(o) -> Hit:
    """Every ray missing: the Hit of a scene with no primitive."""
    r = o.shape[0]
    return Hit(t=torch.full((r,), INF, device=o.device),
               prim=torch.full((r,), -1, dtype=torch.long, device=o.device),
               material=torch.zeros(r, dtype=torch.long, device=o.device),
               point=o, normal=torch.zeros_like(o),
               front_face=torch.zeros(r, dtype=torch.bool, device=o.device))


def intersect_brute(scene, o, d, u_vol, tmin=T_MIN, tmax=INF) -> Hit:
    """Closest hit over every primitive, the linear scan
    (lib/core/scene.rs:141-157) over all (ray, primitive) pairs.

    ``u_vol``: (R, sphere volumes + mesh volumes) free-flight uniforms,
    the sphere volumes' columns first.  Columns of the all-pairs matrix
    are [0, N) spheres, [N, N + T) triangles, then the mesh volumes, so a
    column's index is the global primitive id; ``argmin`` takes the first
    of equal minima, as ``jnp.argmin`` does.
    """
    n_sv = scene.spheres.num_volumes
    n_mv = scene.num_mesh_volumes
    ns, nt = len(scene.spheres), len(scene.triangles)
    if ns + nt + n_mv == 0:
        return empty_hit(o)
    with torch.no_grad():  # the winner only; its t again below
        od, dd, ud = o.detach(), d.detach(), u_vol.detach()
        parts = []
        if ns:
            parts.append(sphere_ts(scene.spheres, od, dd, ud[:, :n_sv], tmin,
                                   tmax))
        if nt:
            t_tri = triangle_ts(scene.triangles, od, dd, tmin, tmax)
            if n_mv:  # a boundary triangle never shades as a surface
                t_tri = torch.where(scene.triangles.volume[None, :] >= 0,
                                    INF, t_tri)
            parts.append(t_tri)
        if n_mv:
            parts.append(mesh_volume_ts(scene, od, dd, ud[:, n_sv:], tmin,
                                        tmax))
        t_all = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        best = t_all.argmin(dim=1)
        t_min = t_all.gather(1, best[:, None])[:, 0]
        del parts, t_all
    missed = ~torch.isfinite(t_min)
    # the winner again in the direct single-primitive form: the canonical
    # float32 distance (the flat BVH walk's too) and its gradient
    n_st = ns + nt
    t = prim_t(scene, torch.clamp(best, 0, max(n_st - 1, 0)), o, d,
               u_vol[:, :n_sv], tmin, INF)
    if n_mv:
        mv = best >= n_st
        t = torch.where(mv, t_min, t)
        at = mv.nonzero().squeeze(1)
        if at.numel() and torch.is_grad_enabled() and (o.requires_grad
                                                       or d.requires_grad):
            # a mesh volume's t has no single-primitive form: its rays scan
            # the boundaries again, with gradient
            t_mv = mesh_volume_ts(scene, o[at], d[at], u_vol[at, n_sv:],
                                  tmin, tmax)
            t = t.index_put((at,), t_mv.gather(
                1, (best[at] - n_st)[:, None])[:, 0])
    t = torch.where(missed, INF, t)
    return make_hit(scene, o, d, t, best)
