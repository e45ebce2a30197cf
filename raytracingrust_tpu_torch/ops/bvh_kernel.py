"""BVH kernel (#5) for scenes beyond the brute kernel: its wrapper, its
plain PyTorch version, the scene packing, the capability gate and the
autograd Function of its record-and-replay gradient.

Replaces raytracingrust_tpu/ops/pallas_megakernel.py's packet-traversal
kernel (``_make_bvh_kernel``, over ``_radiance_math``'s BVH branch,
``_traverse_tree``, ``_sphere_chunk_hit``, ``_tri_chunk_hit``/``_row_mt``
and ``_merge_leaf_rows``) and its ``_bvh_cvjp``.  Per ray and bounce: a
stackless walk of the solid-sphere chunk tree, then of the triangle chunk
tree starting from the sphere pass's nearest hit, then the bounce tail the
brute kernel shares (ops/megakernel.bounce_tail).

Record mode (``record=True``) also returns each bounce's winner code,
(max_depth, R) int32 in the JAX record layout: the winner's slot in bits
0-26 (sphere slots first, triangle slots after the sphere tree's
``n_chunks * leaf``), the front face at bit 27, the metal lobe's
above-the-surface test at bit 28 and the dielectric's reflect choice at bit
29 (those two for every hit, whatever its kind, when the scene holds a
metal or a dielectric, and never in Clay mode); -1 on a miss and for every
bounce after the path ended.  Under autograd :class:`BvhRadiance` runs the
record walk forward and, backward, the differentiable replay over those
codes (diff/replay.py) on winner rows fetched by ops/fetch.FetchRows: the
detached-hit gradient of the JAX package.

The walk is per ray, not per packet: a ray tests a leaf only when its own
slab test hits the leaf's box.  The TPU kernel moves one cursor for 2,048
rays and tests a leaf when any of them hits it; the nearest hit is the same
except where a ray's box test and its primitive test disagree at rounding.

The envelope (:func:`unsupported_bvh`): solid spheres and surface
triangles with Lambertian, Metal, Dielectric or Emission materials; a
uniform or gradient background; Full or Clay mode; any depth.

Layout (:func:`pack`): the 20-float head of ``megakernel.pack_fparams``;
the material table as (M, 8) float32 [albedo rgb, fuzz, ir, emission rgb]
with (M,) int32 kinds; per tree the nodes as (K, 6) float32 and (K, 3)
int32, each chunk's primitive count, and the primitives in permuted slot
order with their material ids: spheres as (S, 4) [center, radius],
triangles as (S, 12) [v0, e1, e2, flat normal].  Under autograd the
packing keeps the graph from the scene's leaves to the head, the material
table and each tree's rows.  On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts launches of the kernel, ``RECORD_LAUNCHES`` of its record variant.
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

# the record code: winner slot, then the bounce's decisions
REC_SLOT = (1 << 27) - 1
REC_FRONT = 1 << 27
REC_METAL_OK = 1 << 28
REC_REFLECT = 1 << 29

LAUNCHES = 0
RECORD_LAUNCHES = 0


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
    # the decision bits a record holds: REC_METAL_OK and REC_REFLECT when
    # a primitive has a metal or a dielectric material
    rec_mask: int = 0

    @property
    def device(self) -> torch.device:
        return self.head.device

    @property
    def tri_base(self) -> int:
        """The code of triangle slot 0: the sphere tree's slot count."""
        return self.spheres.geo.shape[0] if self.spheres else 0

    def with_rows(self, head, mats, sph_geo, tri_geo) -> "BvhScene":
        """The same scene over other head, table and primitive rows."""
        return self._replace(
            head=head, mats=mats,
            spheres=None if self.spheres is None
            else self.spheres._replace(geo=sph_geo),
            triangles=None if self.triangles is None
            else self.triangles._replace(geo=tri_geo))


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
    ``device``, differentiable in the scene's leaves (the graph of
    ``jax.vjp`` of the JAX packing).  Gathering each winner's shading
    constants from the material table gives the floats the TPU kernel's
    chunk matrices carry."""
    mats = scene.materials
    table = torch.cat([mats.albedo, mats.fuzz[:, None], mats.ir[:, None],
                       mats.emission], dim=1).to(torch.float32)
    sph, tri, cb = scene.spheres, scene.triangles, scene.cbvh
    used = mats.kind[torch.cat([sph.material, tri.material]).long()]
    rec_mask = ((REC_METAL_OK if bool((used == M.METAL).any()) else 0)
                | (REC_REFLECT if bool((used == M.DIELECTRIC).any()) else 0))
    return BvhScene(
        K.pack_head(scene, width, height).contiguous().to(device),
        table.contiguous().to(device),
        mats.kind.to(torch.int32).contiguous().to(device),
        _tree(cb.spheres, torch.cat([sph.center, sph.radius[:, None]], 1),
              sph.material, device),
        _tree(cb.triangles, torch.cat([tri.v0, tri.e1, tri.e2, tri.normal],
                                      1), tri.material, device),
        rec_mask)


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
              tally, rec):
    """One tile of :func:`radiance_bvh_plain`; ``rec``, when not None, is
    the tile's (max_depth, R) int32 record, filled with -1, to write the
    codes into."""
    o, d = K.camera_ray(sc.head, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    sph, tri = sc.spheres, sc.triangles
    rec_mask = 0 if clay else sc.rec_mask
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
        decided = None if rec is None else {}
        entering = alive
        o, d, thr, rad, alive = K.bounce_tail(
            sc.head, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n,
            sc.mats[mid].unbind(-1), kind, u, decisions=decided)
        if rec is not None:
            code = torch.where(is_tri, w_tri + sc.tri_base, w_sph)
            code = code | torch.where(decided["front"], REC_FRONT, 0)
            for bit, name in ((REC_METAL_OK, "metal_ok"),
                              (REC_REFLECT, "reflect")):
                if rec_mask & bit:
                    code = code | torch.where(decided[name], bit, 0)
            rec[b] = torch.where(entering & hit, code, -1)
    return torch.stack(rad, dim=-1)


def radiance_bvh_plain(sc: BvhScene, key: tuple[int, int],
                       ray_ids: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor, *, max_depth: int, bg_kind: int,
                       clay: bool, tally=None, record: bool = False):
    """Per-ray radiance (R, 3) float32 of the rays ``prep_rays`` gives, in
    tensor ops on ``sc``'s device: what the CUDA kernel computes, operation
    for operation (per-ray walks, true division in the sphere root and
    normal, ``1 / sqrt`` where the JAX kernel has rsqrt).  With ``record``,
    -> (radiance, codes (max_depth, R) int32), the radiance unchanged.
    ``tally``, for measurement only, is a ``collections.Counter`` that
    receives the work the rays did: node visits, sphere and triangle tests,
    rays entering a bounce, misses, hits by kind."""
    n = ray_ids.shape[0]
    codes = (torch.full((max_depth, n), -1, dtype=torch.int32,
                        device=px.device) if record else None)
    rad = torch.cat([
        _bvh_tile(sc, key, ray_ids[i:i + TILE_RAYS], px[i:i + TILE_RAYS],
                  py[i:i + TILE_RAYS], max_depth, bg_kind, clay, tally,
                  None if codes is None else codes[:, i:i + TILE_RAYS])
        for i in range(0, n, TILE_RAYS)
    ]) if n else torch.zeros((0, 3), device=px.device)
    return (rad, codes) if record else rad


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
                      clay: bool, record: bool = False):
    """Per-ray radiance (n_rays, 3) from the CUDA kernel for rays
    0 .. n_rays - 1, where ray id = pixel * spp + sample and pixels run
    row-major over ``width``.  With ``record``, the record variant:
    -> (radiance, codes (max_depth, n_rays) int32)."""
    global LAUNCHES, RECORD_LAUNCHES
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
    codes = (torch.empty((max_depth, n_rays), dtype=torch.int32, device=dev)
             if record else None)
    if n_rays == 0:
        return (out, codes) if record else out
    lib = _build.load("bvh_forward")
    with torch.cuda.device(dev):
        err = lib.rtrt_bvh_radiance(
            ctypes.c_void_p(sc.head.data_ptr()),
            ctypes.c_void_p(sc.mats.data_ptr()),
            ctypes.c_void_p(sc.kinds.data_ptr()), m, *args, leaf, key[0],
            key[1],
            n_rays, spp, width, max_depth, int(bg_kind), int(bool(clay)),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(codes.data_ptr() if record else 0),
            0 if clay else sc.rec_mask, sc.tri_base,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_bvh_radiance launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    if record:
        RECORD_LAUNCHES += 1
        return out, codes
    LAUNCHES += 1
    return out


# ------------------------------------------------------------- autograd

def _rows(sc: BvhScene) -> tuple:
    """The differentiable tensors: head, material table, the two trees'
    primitive rows (None for an absent tree)."""
    return (sc.head, sc.mats,
            *(None if t is None else t.geo for t in (sc.spheres,
                                                     sc.triangles)))


def requires_grad(sc: BvhScene) -> bool:
    """Whether autograd is on and a packed tensor needs a gradient."""
    return torch.is_grad_enabled() and any(
        v is not None and v.requires_grad for v in _rows(sc))


def _record(sc: BvhScene, key, n_pixels: int, spp: int, width: int, **opts):
    """(radiance, codes) of pixels 0 .. n_pixels - 1: the record variant on
    a CUDA device, the plain record walk on the CPU."""
    if K.select_engine(sc.device) == "cuda":
        return radiance_bvh_cuda(sc, key, n_pixels * spp, spp, width,
                                 record=True, **opts)
    ray_ids, px, py = K.prep_rays(torch.arange(n_pixels), spp, width)
    return radiance_bvh_plain(sc, key, ray_ids, px, py, record=True, **opts)


def replay(sc: BvhScene, codes: torch.Tensor, key, n_pixels: int, spp: int,
           width: int, *, max_depth: int, bg_kind: int, clay: bool,
           plain: bool = False) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) replayed over recorded codes,
    differentiable in ``sc``'s head, material table and primitive rows: the
    winners' rows through ops/fetch.FetchRows (#6 forward, #7 backward on
    the card), then diff/replay.py's shading chain.  ``plain`` fetches by
    the fetch's plain version under autograd instead, on any device: the
    route the kernels are held to."""
    from ..diff.replay import replay_rows_radiance
    from .fetch import FetchRows, fetch_rows_plain

    sph, tri = sc.spheres, sc.triangles
    rows, kind = (fetch_rows_plain if plain else FetchRows.apply)(
        codes, sc.kinds, sc.tri_base,
        None if sph is None else sph.mat, None if tri is None else tri.mat,
        *_rows(sc)[1:])
    ray_ids, px, py = K.prep_rays(
        torch.arange(n_pixels, device=codes.device), spp, width)
    return replay_rows_radiance(
        sc.head, rows, kind, codes, key, ray_ids, px, py,
        tri_base=sc.tri_base, has_spheres=sph is not None,
        has_triangles=tri is not None, max_depth=max_depth, bg_kind=bg_kind,
        clay=clay)


def _replay_grad(sc: BvhScene, codes, cts, *args, **kwargs) -> tuple:
    """The gradient of sum(cts * :func:`replay`) in ``sc``'s differentiable
    tensors, None for an absent tree.  The two ranges name the replay's
    halves in a torch.profiler trace."""
    rows = [None if v is None else v.detach().requires_grad_(True)
            for v in _rows(sc)]
    live = [v for v in rows if v is not None]
    with torch.enable_grad():
        with torch.profiler.record_function("bvh_replay_forward"):
            rad = replay(sc.with_rows(*rows), codes, *args, **kwargs)
        with torch.profiler.record_function("bvh_replay_backward"):
            got = iter(torch.autograd.grad(rad, live, cts,
                                           allow_unused=True))
    return tuple(None if v is None else next(got) for v in rows)


def radiance_grad_plain(sc: BvhScene, key, cts: torch.Tensor, n_pixels: int,
                        spp: int, width: int, **opts) -> tuple:
    """The gradient of sum(cts * radiance) by the plain route on ``sc``'s
    device: the plain record walk, then autograd through the plain fetch
    and the replay.  -> (d head, d material table, d sphere rows, d triangle
    rows), None for an absent tree."""
    ray_ids, px, py = K.prep_rays(
        torch.arange(n_pixels, device=cts.device), spp, width)
    with torch.no_grad():
        _, codes = radiance_bvh_plain(sc, key, ray_ids, px, py, record=True,
                                      **opts)
    return _replay_grad(sc, codes, cts, key, n_pixels, spp, width,
                        plain=True, **opts)


class BvhRadiance(torch.autograd.Function):
    """Per-ray radiance over the BVH, differentiable in the packed head,
    material table and primitive rows (the port of ``_bvh_cvjp``): forward,
    the record walk (#5's record variant on the card); backward, autograd
    through :func:`replay` over its codes, whose gradient holds every
    winner, root, face and lobe choice fixed."""

    @staticmethod
    def forward(ctx, sc, key, n_pixels, spp, width, opts, head, mats,
                sph_geo, tri_geo):
        sc = sc.with_rows(head, mats, sph_geo, tri_geo)
        rad, codes = _record(sc, key, n_pixels, spp, width, **opts)
        ctx.save_for_backward(codes, head, mats, sph_geo, tri_geo)
        ctx.args = (sc, key, n_pixels, spp, width, opts)
        return rad

    @staticmethod
    def backward(ctx, grad):
        codes, *rows = ctx.saved_tensors
        sc, key, n_pixels, spp, width, opts = ctx.args
        return (None,) * 6 + _replay_grad(sc.with_rows(*rows), codes, grad,
                                          key, n_pixels, spp, width, **opts)


# ------------------------------------------------------------- per pixel

def radiance(sc: BvhScene, key: tuple[int, int], n_pixels: int, spp: int,
             width: int, *, max_depth: int, bg_kind: int,
             clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) of pixels 0 .. n_pixels - 1:
    the kernel for a scene on a CUDA device, the plain version on the CPU.
    When a packed tensor requires grad, :class:`BvhRadiance` (the record
    walk, then the replay as its backward) on either device."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay)
    if requires_grad(sc):
        return BvhRadiance.apply(sc, key, n_pixels, spp, width, opts,
                                 *_rows(sc))
    if K.select_engine(sc.device) == "cuda":
        return radiance_bvh_cuda(sc, key, n_pixels * spp, spp, width, **opts)
    ray_ids, px, py = K.prep_rays(torch.arange(n_pixels), spp, width)
    return radiance_bvh_plain(sc, key, ray_ids, px, py, **opts)
