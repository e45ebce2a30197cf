"""BVH forward kernel (#5) for scenes beyond the brute kernel: its wrapper,
its plain PyTorch version, the scene packing and the capability gate.

Replaces the forward of raytracingrust_tpu/ops/pallas_megakernel.py's
packet-traversal kernel (``_make_bvh_kernel`` with ``record=False``, over
``_radiance_math``'s BVH branch, ``_traverse_tree``, ``_sphere_chunk_hit``,
``_tri_chunk_hit``/``_row_mt`` and ``_merge_leaf_rows``).  Per ray and
bounce: a stackless walk of the solid-sphere chunk tree, then of the
triangle chunk tree starting from the sphere pass's nearest hit, then the
bounce tail the brute kernel shares (ops/megakernel.bounce_tail).

The walk is per ray, not per packet: a ray tests a leaf only when its own
slab test hits the leaf's box.  The TPU kernel moves one cursor for 2,048
rays and tests a leaf when any of them hits it; the nearest hit is the same
except where a ray's box test and its primitive test disagree at rounding.

The envelope (:func:`unsupported_bvh`): solid spheres and surface
triangles with Lambertian, Metal, Dielectric or Emission materials; a
uniform or gradient background; Full or Clay mode; any depth; forward only.

Layout (:func:`pack`): the 20-float head of ``megakernel.pack_fparams``;
the material table as (M, 8) float32 [albedo rgb, fuzz, ir, emission rgb]
with (M,) int32 kinds; per tree the nodes as (K, 6) float32 and (K, 3)
int32, each chunk's primitive count, and the primitives in permuted slot
order with their material ids: spheres as (S, 4) [center, radius],
triangles as (S, 12) [v0, e1, e2, flat normal].  On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import backgrounds as B
from ..models import materials as M
from ..models.scene import MODE_CLAY, MODE_FULL, ChunkTree, Scene
from ..utils.rng import ray_uniforms
from ..utils.types import T_MIN
from . import megakernel as K

# pallas_megakernel.TRI_DET_EPS: a triangle whose determinant is at most
# this is parallel to the ray
TRI_DET_EPS = 1e-8
# rays per step of the plain version: a leaf test holds (rays, leaf) floats
TILE_RAYS = 1 << 18

LAUNCHES = 0
NO_GRAD = ("gradients through the BVH kernel (its record mode and the "
           "replay gradient) are not ported yet (ROADMAP B5)")


# ------------------------------------------------------------- the envelope

def unsupported_bvh(scene: Scene) -> str | None:
    """Why the BVH kernel cannot take the scene, or None (the JAX
    ``supports_bvh``, for what the port renders so far)."""
    if scene.cbvh is None:
        return ("the scene was built without its BVH: build it with "
                "with_bvh=True (or enable_bvh_tree)")
    if scene.num_primitives == 0:
        return "the scene has no primitive"
    if scene.spheres.num_volumes:
        return ("constant-density volumes on the BVH path are not ported "
                "yet (ROADMAP B4)")
    if scene.materials.has_mix:
        return "mix materials on the BVH path are not ported yet (ROADMAP B4)"
    mids = torch.cat([scene.spheres.material, scene.triangles.material])
    if bool((scene.materials.kind[mids.long()] == M.ISOTROPIC).any()):
        return ("isotropic materials on the BVH path are not ported yet "
                "(ROADMAP B4)")
    if scene.background.kind not in (B.UNIFORM, B.GRADIENT):
        return "SkyMap backgrounds on the BVH path are not ported yet " \
               "(ROADMAP B4)"
    if scene.settings.mode not in (MODE_FULL, MODE_CLAY):
        return (f"{scene.settings.mode} mode on the BVH path is not ported "
                "yet (ROADMAP B4)")
    return None


# ------------------------------------------------------------- packing

class Tree(NamedTuple):
    nodes_f: torch.Tensor  # (K, 6) float32
    nodes_i: torch.Tensor  # (K, 3) int32 [hit_link, miss_link, chunk]
    chunk_len: torch.Tensor  # (n_chunks,) int32
    geo: torch.Tensor      # (n_chunks * leaf, 4 or 12) float32
    mat: torch.Tensor      # (n_chunks * leaf,) int32 material id
    links: np.ndarray      # nodes_i on the host: the plain version's walk
    leaf_size: int


class BvhScene(NamedTuple):
    head: torch.Tensor     # (20,) float32 camera, background, pixel scale
    mats: torch.Tensor     # (M, 8) float32 albedo rgb, fuzz, ir, emission
    kinds: torch.Tensor    # (M,) int32
    spheres: Optional[Tree]
    triangles: Optional[Tree]

    @property
    def device(self) -> torch.device:
        return self.head.device


def _tree(t: Optional[ChunkTree], rows: torch.Tensor, mat: torch.Tensor,
          device) -> Optional[Tree]:
    if t is None:
        return None
    perm = torch.as_tensor(t.perm, device=rows.device).long()
    pad = perm < 0
    idx = perm.clamp(min=0)
    geo = torch.where(pad[:, None], 0.0, rows[idx])
    return Tree(torch.as_tensor(t.nodes_f).to(device),
                torch.as_tensor(t.nodes_i).to(device),
                torch.as_tensor(t.chunk_len).to(device),
                geo.to(torch.float32).contiguous().to(device),
                torch.where(pad, 0, mat[idx]).to(torch.int32).to(device),
                t.nodes_i, t.leaf_size)


def pack(scene: Scene, width: int, height: int, device) -> BvhScene:
    """The scene's constants for the kernel and its plain version, on
    ``device``.  Gathering each winner's shading constants from the
    material table gives the floats the TPU kernel's chunk matrices
    carry."""
    mats = scene.materials
    table = torch.cat([mats.albedo, mats.fuzz[:, None], mats.ir[:, None],
                       mats.emission], dim=1).to(torch.float32)
    sph, tri, cb = scene.spheres, scene.triangles, scene.cbvh
    return BvhScene(
        K.pack_head(scene, width, height).detach().contiguous().to(device),
        table.detach().contiguous().to(device),
        mats.kind.to(torch.int32).contiguous().to(device),
        _tree(cb.spheres, torch.cat([sph.center, sph.radius[:, None]], 1)
              .detach(), sph.material, device),
        _tree(cb.triangles, torch.cat([tri.v0, tri.e1, tri.e2, tri.normal],
                                      1).detach(), tri.material, device))


# ------------------------------------------------------------- plain version

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _sphere_leaf(geo, o, d, a, t_best):
    """Candidate distances (R, L) of one leaf's spheres (``_sphere_chunk_hit``
    op for op: the direct (o - c) quadratic with true division; the near
    root if in [T_MIN, t_best], else the far root; radius 0 never hits)."""
    cx, cy, cz, r = (v[None, :] for v in geo.unbind(-1))
    ox, oy, oz = (v[:, None] for v in o)
    dx, dy, dz = (v[:, None] for v in d)
    a, tb = a[:, None], t_best[:, None]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = hb * hb - a * cq
    ok = (disc >= 0.0) & (r > 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-hb - sq) / a
    t2 = (-hb + sq) / a
    t1ok = (t1 >= T_MIN) & (t1 <= tb)
    t2ok = (t2 >= T_MIN) & (t2 <= tb)
    return torch.where(ok & t1ok, t1,
                       torch.where(ok & t2ok, t2, float("inf")))


def _triangle_leaf(geo, o, d, a, t_best):
    """Candidate distances (R, L) of one leaf's triangles (``_row_mt``, the
    direct cross-product Moller-Trumbore, with t in (T_MIN, t_best])."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        v[None, :] for v in geo[:, :9].unbind(-1))
    ox, oy, oz = (v[:, None] for v in o)
    dx, dy, dz = (v[:, None] for v in d)
    hx = dy * e2z - dz * e2y  # h = d x e2
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok = det.abs() > TRI_DET_EPS
    f = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z  # s = o - v0
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y  # q = s x e1
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    tt = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (tt > T_MIN) & (tt <= t_best[:, None]))
    return torch.where(valid, tt, float("inf"))


def _walk(tree: Tree, leaf, o, d, inv_d, a, alive, t_best, win, tally,
          name):
    """Each alive ray's stackless walk of one tree, vectorized: the rays
    whose cursor is at node k take its slab test (``_traverse_tree``'s:
    NaN-propagating min/max, so an axis-parallel NaN reads as a miss), test
    the leaf's primitives if the box is hit, and move to the hit or miss
    link.  Links only go forward, so one sweep over k in order is every
    ray's walk.  A leaf's winner is its nearest candidate, the lowest slot
    among equals; it replaces the ray's winner only when strictly nearer
    (``_merge_leaf_rows``).  ``t_best`` and ``win`` (the winning slot)
    change in place."""
    k_nodes = tree.links.shape[0]
    cursor = torch.where(alive, 0, k_nodes)
    nf = tree.nodes_f
    for k in range(k_nodes):
        at = (cursor == k).nonzero().squeeze(1)
        if at.numel() == 0:
            continue
        tb = t_best[at]
        o_k = [v[at] for v in o]
        t = [((nf[k, c + h] - o_k[c]) * inv_d[c][at]) for h in (0, 3)
             for c in range(3)]
        t0x, t0y, t0z, t1x, t1y, t1z = t
        entry = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.clamp(torch.minimum(t0z, t1z), min=T_MIN))
        exit_ = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), tb))
        box = exit_ > entry
        hit_l, miss_l, chunk = (int(v) for v in tree.links[k])
        if tally is not None:
            tally["nodes"] += at.numel()
        if chunk >= 0:
            rays = at[box]
            n = int(tree.chunk_len[chunk])
            if rays.numel() and n:
                base = chunk * tree.leaf_size
                ti = leaf(tree.geo[base:base + n], [v[rays] for v in o],
                          [v[rays] for v in d], a[rays], t_best[rays])
                t_min = ti.min(dim=1).values
                lane = torch.arange(n, device=ti.device)
                first = torch.where(ti == t_min[:, None], lane, n).min(
                    dim=1).values
                better = t_min < t_best[rays]
                t_best[rays] = torch.where(better, t_min, t_best[rays])
                win[rays] = torch.where(better, base + first, win[rays])
                if tally is not None:
                    tally[name] += rays.numel() * n
        cursor[at] = torch.where(box, hit_l, miss_l)


def _bvh_tile(sc: BvhScene, key, ray_ids, px, py, max_depth, bg_kind, clay,
              tally):
    """One tile of :func:`radiance_bvh_plain`."""
    o, d = K.camera_ray(sc.head, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    sph, tri = sc.spheres, sc.triangles
    for b in range(max_depth):
        if not bool(alive.any()):
            break  # dead rays never change: stopping early is exact
        u = ray_uniforms(key, ray_ids, 1 + b, 3).unbind(-1)
        dx, dy, dz = d
        a = _dot3(dx, dy, dz, dx, dy, dz)
        inv_d = [1.0 / dx, 1.0 / dy, 1.0 / dz]
        t_best = torch.full_like(a, float("inf"))
        w_sph = torch.full_like(ray_ids, -1, dtype=torch.long)
        w_tri = w_sph.clone()
        if sph is not None:
            _walk(sph, _sphere_leaf, o, d, inv_d, a, alive, t_best, w_sph,
                  tally, "sphere_tests")
        if tri is not None:
            _walk(tri, _triangle_leaf, o, d, inv_d, a, alive, t_best, w_tri,
                  tally, "triangle_tests")
        hit = t_best < float("inf")
        is_tri = w_tri >= 0
        safe_t = torch.where(hit, t_best, 1.0)
        pt = [o[c] + safe_t * d[c] for c in range(3)]
        if sph is not None:
            g = sph.geo[w_sph.clamp(min=0)]
            r = g[:, 3]
            g_rad = torch.where(r > 0.0, r, 1.0)
            n = [(pt[c] - g[:, c]) / g_rad for c in range(3)]
            mid = sph.mat[w_sph.clamp(min=0)]
        else:
            n = [torch.zeros_like(a)] * 3
            mid = torch.zeros_like(ray_ids)
        if tri is not None:
            g = tri.geo[w_tri.clamp(min=0)]
            n = [torch.where(is_tri, g[:, 9 + c], n[c]) for c in range(3)]
            mid = torch.where(is_tri, tri.mat[w_tri.clamp(min=0)], mid)
        mid = mid.long()
        kind = sc.kinds[mid]
        if tally is not None:
            tally["bounces"] += int(alive.sum())
            tally["misses"] += int((alive & ~hit).sum())
            for k in range(4):
                tally[f"hits_{k}"] += int((alive & hit & (kind == k)).sum())
        o, d, thr, rad, alive = K.bounce_tail(
            sc.head, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n,
            sc.mats[mid].unbind(-1), kind, u)
    return torch.stack(rad, dim=-1)


def radiance_bvh_plain(sc: BvhScene, key: tuple[int, int],
                       ray_ids: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor, *, max_depth: int, bg_kind: int,
                       clay: bool, tally=None) -> torch.Tensor:
    """Per-ray radiance (R, 3) float32 of the rays ``prep_rays`` gives, in
    tensor ops on ``sc``'s device: what the CUDA kernel computes, operation
    for operation (per-ray walks, true division in the sphere root and
    normal, ``1 / sqrt`` where the JAX kernel has rsqrt).  Forward only.
    ``tally``, for measurement only, is a ``collections.Counter`` that
    receives the work the rays did: node visits, sphere and triangle tests,
    rays entering a bounce, misses, hits by kind."""
    return torch.cat([
        _bvh_tile(sc, key, ray_ids[i:i + TILE_RAYS], px[i:i + TILE_RAYS],
                  py[i:i + TILE_RAYS], max_depth, bg_kind, clay, tally)
        for i in range(0, ray_ids.shape[0], TILE_RAYS)
    ]) if ray_ids.shape[0] else torch.zeros((0, 3), device=px.device)


# ------------------------------------------------------------- the kernel

def _tree_args(t: Optional[Tree], cols: int):
    """(nodes_f, nodes_i, chunk_len, geo, mat pointers, node count) of one
    tree, after checking it; null pointers and 0 for an absent tree."""
    if t is None:
        return [ctypes.c_void_p(0)] * 5 + [0]
    dev = t.nodes_f.device
    k, n_chunks = t.nodes_f.shape[0], t.chunk_len.shape[0]
    K._check(t.nodes_f, "nodes_f", torch.float32, (k, 6), dev)
    K._check(t.nodes_i, "nodes_i", torch.int32, (k, 3), dev)
    K._check(t.chunk_len, "chunk_len", torch.int32, (n_chunks,), dev)
    slots = n_chunks * t.leaf_size
    K._check(t.geo, "geo", torch.float32, (slots, cols), dev)
    K._check(t.mat, "mat", torch.int32, (slots,), dev)
    if t.geo.data_ptr() % 16:
        raise ValueError("geo must be 16-byte aligned (float4 loads)")
    return [ctypes.c_void_p(v.data_ptr()) for v in
            (t.nodes_f, t.nodes_i, t.chunk_len, t.geo, t.mat)] + [k]


def radiance_bvh_cuda(sc: BvhScene, key: tuple[int, int], n_rays: int,
                      spp: int, width: int, *, max_depth: int, bg_kind: int,
                      clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_rays, 3) from the CUDA kernel for rays
    0 .. n_rays - 1, where ray id = pixel * spp + sample and pixels run
    row-major over ``width``."""
    global LAUNCHES
    from . import _build

    dev = sc.device
    if dev.type != "cuda":
        raise ValueError(f"radiance_bvh_cuda needs CUDA tensors, got {dev}")
    if sc.spheres is None and sc.triangles is None:
        raise ValueError("radiance_bvh_cuda: the scene has no tree")
    if not 0 <= n_rays < 2 ** 31 or spp < 1 or width < 1 or max_depth < 0:
        raise ValueError(f"bad launch: n_rays={n_rays} spp={spp} "
                         f"width={width} max_depth={max_depth}")
    m = sc.kinds.shape[0]
    K._check(sc.head, "head", torch.float32, (K._SPHERES,), dev)
    K._check(sc.mats, "mats", torch.float32, (m, 8), dev)
    K._check(sc.kinds, "kinds", torch.int32, (m,), dev)
    K._check_key(key)
    leaf = (sc.spheres or sc.triangles).leaf_size
    if sc.spheres and sc.triangles and sc.triangles.leaf_size != leaf:
        raise ValueError("the two trees have different leaf sizes")
    args = _tree_args(sc.spheres, 4) + _tree_args(sc.triangles, 12)
    out = torch.empty((n_rays, 3), dtype=torch.float32, device=dev)
    if n_rays == 0:
        return out
    lib = _build.load("bvh_forward")
    with torch.cuda.device(dev):
        err = lib.rtrt_bvh_radiance(
            ctypes.c_void_p(sc.head.data_ptr()),
            ctypes.c_void_p(sc.mats.data_ptr()),
            ctypes.c_void_p(sc.kinds.data_ptr()), m, *args, leaf, key[0],
            key[1],
            n_rays, spp, width, max_depth, int(bg_kind), int(bool(clay)),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_bvh_radiance launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    LAUNCHES += 1
    return out


# ------------------------------------------------------------- per pixel

def radiance(sc: BvhScene, key: tuple[int, int], n_pixels: int, spp: int,
             width: int, *, max_depth: int, bg_kind: int,
             clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) of pixels 0 .. n_pixels - 1:
    the kernel for a scene on a CUDA device, the plain version on the
    CPU."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay)
    if K.select_engine(sc.device) == "cuda":
        return radiance_bvh_cuda(sc, key, n_pixels * spp, spp, width, **opts)
    ray_ids, px, py = K.prep_rays(torch.arange(n_pixels), spp, width)
    return radiance_bvh_plain(sc, key, ray_ids, px, py, **opts)
