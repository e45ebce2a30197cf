"""BVH kernel (#5) for scenes beyond the brute kernel: its wrapper, its
plain PyTorch version, the scene packing, the capability gate and the
autograd Function of its record-and-replay gradient.

Replaces raytracingrust_tpu/ops/pallas_megakernel.py's packet-traversal
kernel (``_make_bvh_kernel``, over ``_radiance_math``'s BVH branch,
``_traverse_tree``, ``_sphere_chunk_hit``, ``_vol_chunk_hit``,
``_tri_chunk_hit``/``_row_mt``, ``_mv_min_t``, ``_merge_leaf_rows`` and
``_mixn_resolve``) and its ``_bvh_cvjp``.  Per ray and bounce: a stackless
walk of the solid-sphere chunk tree, then of the volume-sphere tree, then
of the surface-triangle tree, each starting from the nearest hit of the
walks before it, then the crossing scan of each mesh volume in index
order; the winner's mix resolved to a leaf material
(ops/shade.resolve_mix); then the bounce tail the brute kernel shares
(ops/megakernel.bounce_tail).  A volume is a constant-density medium: its
candidate is the boundary window's entry plus an exponential free flight
drawn from the volume's own uniform column (lib/volume.rs:35-73), and its
hit shades with a dummy normal (1, 0, 0).  A volume sphere's window comes
from its quadratic; a mesh volume's from its boundary triangles
(pallas_megakernel.py:1620-1671): the entry t1 is the least raw
Moller-Trumbore t at any sign (a ray may start inside), the exit the least
t at or past t1 + T_MIN.  The JAX kernel scans every boundary triangle for
each (``_mv_min_t``); here a walk of the volume's own small tree
(:func:`_mv_walk`, ops/bvh.build_mv_trees) tests only the leaves whose
padded box the ray's line crosses within bounds fixed before it, and its
first crossings give the exit unless a second walk is needed.  Wherever
they can change the hit, t1 and t2 are the dense scan's bit for bit: a
minimum over the same candidates, each t from the same arithmetic.

The bounce's uniform columns (stream 1 + b) are the JAX layout: with any
mix in the table, the four mix coins first, ``off = MAX_MIX_DEPTH``; then
u1, u2, the coin and u_r at ``off + 0 .. 3``; then volume sphere v's
free-flight uniform at ``off + 4 + v``, v its ordinal among the volume
spheres, and mesh volume v's at ``off + 4 + n_vol + v``.

Record mode (``record=True``) also returns each bounce's winner code,
(max_depth, R) int32 in the JAX record layout: the winner's slot in bits
0-26 (solid-sphere slots first, volume slots from ``vol_base``, triangle
slots from ``tri_base``, each base the slot count of the trees before it,
then mesh volume v as ``mv_base + v``),
the front face at bit 27, the metal lobe's above-the-surface test at bit 28
and the dielectric's reflect choice at bit 29 (those two for every hit,
whatever its kind, when a metal or a dielectric is reachable from a
primitive, and never in Clay mode); -1 on a miss and for every bounce after
the path ended.  Under autograd :class:`BvhRadiance` runs the record walk
forward and, backward, the differentiable replay over those codes
(diff/replay.py) on winner rows fetched by ops/fetch.FetchRows: the
detached-hit gradient of the JAX package.

The walk is per ray, not per packet: a ray tests a leaf only when its own
slab test hits the leaf's box.  The TPU kernel moves one cursor for 2,048
rays and tests a leaf when any of them hits it; the nearest hit is the same
except where a ray's box test and its primitive test disagree at rounding.

A sky map (``sky``, bg_kind SKYMAP) adds, on a miss, the throughput
times the sky's nearest texel (``Background.sample``; the JAX
``_env_finish`` applied at the bounce where the path escaped).  The
inspection views (``debug`` "normal" or "random", the JAX kernel's
``debug``) trace one intersection with bounce stream 1's volume uniforms and
no scatter chain: a hit gives 0.5 * (its normalized front-facing normal +
1), or black; a miss the background, a sky map's included.

The envelope (:func:`unsupported_bvh`), what the JAX ``supports_bvh``
admits, and the views on a sky map too: solid spheres, up to
``MAX_BVH_VOLUMES`` sphere volumes, surface triangles and up to
``MAX_BVH_MESH_VOLUMES`` mesh volumes (not under importance sampling);
Lambertian, Metal, Dielectric, Emission and Isotropic materials and mixes
of them nested up to ``MAX_MIX_DEPTH``; a uniform, gradient or sky-map
background; Full, Clay, Normal or Random mode; any depth.

Layout (:func:`pack`): the 20-float head of ``megakernel.pack_fparams``;
the material table as (M, 8) float32 [albedo rgb, fuzz, ir, emission rgb]
with (M,) int32 kinds and, with mixes, the mix table; per tree the nodes
as (K, 6) float32 and (K, 3) int32, each chunk's primitive count, and the
primitives in permuted slot order with their raw material ids: spheres and
volumes as (S, 4) [center, radius], volumes also with their -1/density and
ordinal, triangles as (S, 12) [v0, e1, e2, flat normal]; the mesh volumes'
trees one after another as one tree (each volume's first node and end),
their boundary triangles as (S, 12) rows in leaf order, and per volume its
-1/density and raw material id (the replay also gets the rows in
``mv_perm`` order, each volume's first slot and triangle count).  Under
autograd the packing keeps the graph from the scene's leaves to the head,
the material table and each tree's rows; the boundary triangles and the
densities are constants, as in the JAX replay.  On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts launches of the kernel under a uniform or gradient
background, ``SKY_LAUNCHES`` of its sky-map variant, ``VIEW_LAUNCHES`` of
the inspection views and ``RECORD_LAUNCHES`` of its record variant; the
launches of a scene with mesh volumes (the variants with the crossing
scan) count under those names and again under ``MV_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import backgrounds as B
from ..models import materials as M
from ..models.scene import (MODE_CLAY, MODE_FULL, MODE_NORMAL, MODE_RANDOM,
                            ChunkTree, Scene)
from ..utils.rng import ray_uniforms
from ..utils.types import T_MIN
from . import megakernel as K
from .shade import mix_depth, reachable_kinds, resolve_mix

# pallas_megakernel.TRI_DET_EPS: a triangle whose determinant is at most
# this is parallel to the ray
TRI_DET_EPS = 1e-8
# pallas_megakernel.MAX_BVH_VOLUMES: each volume draws a uniform column of
# its own a bounce
MAX_BVH_VOLUMES = 8
# pallas_megakernel.MAX_BVH_MESH_VOLUMES: each draws a uniform column of
# its own a bounce
MAX_BVH_MESH_VOLUMES = 4
# the share of the larger of a node's |entry| and |exit| by which the
# mesh volumes' walk widens its box's interval before comparing it with
# its bounds in t (bvh_walk.cuh kMvSlack): a grazing ray's Moller-Trumbore
# t may lie outside its box's interval by a relative error that grows as
# the ray turns parallel to the triangle
MV_SLACK = 2.0 ** -5
# rays per step of the plain version: a leaf test holds (rays, leaf) floats
TILE_RAYS = 1 << 18
# (ray, leaf) pairs per step of the plain mesh-volume walk's leaf tests
MV_PAIRS = 1 << 20
# crossings the mesh volumes' entry walk keeps for the exit (bvh_walk.cuh
# kMvKeep): a line crosses a convex boundary twice and a concave one a few
# times more; one through an edge or a vertex crosses every triangle there
MV_KEEP = 4

# the record code: winner slot, then the bounce's decisions
REC_SLOT = (1 << 27) - 1
REC_FRONT = 1 << 27
REC_METAL_OK = 1 << 28
REC_REFLECT = 1 << 29

# the inspection views, by render mode
VIEWS = {MODE_NORMAL: "normal", MODE_RANDOM: "random"}

LAUNCHES = 0
SKY_LAUNCHES = 0
VIEW_LAUNCHES = 0
RECORD_LAUNCHES = 0
MV_LAUNCHES = 0


# ------------------------------------------------------------- the envelope

def env_is_active(scene: Scene) -> bool:
    """Whether the scene uses the one-sample MIS environment sampler: the
    flag, a sky map and Full mode (the JAX ``_env_is_active``)."""
    return (scene.settings.env_importance_sampling
            and scene.background.kind == B.SKYMAP
            and scene.settings.mode == MODE_FULL)


def unsupported_bvh(scene: Scene) -> str | None:
    """Why the BVH kernel cannot take the scene, or None (the JAX
    ``supports_bvh``).  A sky map passes in every mode: with importance
    sampling its path is :func:`env_radiance`; the JAX gate keeps the views
    of a sky map on its XLA integrator, which the port lacks, so #5 serves
    them.  Mesh volumes pass up to MAX_BVH_MESH_VOLUMES, but not under
    importance sampling, whose shadow rays (#8) do not model their
    stochastic occlusion: the JAX package renders those with its XLA
    integrator (ROADMAP A6)."""
    n_mv = scene.num_mesh_volumes
    if scene.cbvh is None:
        if n_mv:
            return (f"{n_mv} mesh volumes without the scene's BVH need the "
                    "XLA integrator, not ported yet (ROADMAP A6): build the "
                    "scene with with_bvh=True (or enable_bvh_tree)")
        return ("the scene was built without its BVH: build it with "
                "with_bvh=True (or enable_bvh_tree)")
    if scene.num_primitives == 0:
        return "the scene has no primitive"
    if scene.spheres.num_volumes > MAX_BVH_VOLUMES:
        return (f"{scene.spheres.num_volumes} volumes: the BVH kernel takes "
                f"at most {MAX_BVH_VOLUMES}, each drawing a uniform of its "
                "own a bounce (as the JAX package)")
    if n_mv > MAX_BVH_MESH_VOLUMES:
        return (f"{n_mv} mesh volumes: the BVH kernel takes at most "
                f"{MAX_BVH_MESH_VOLUMES}, each drawing a uniform of its own "
                "a bounce (as the JAX package); more need the XLA "
                "integrator, not ported yet (ROADMAP A6)")
    if n_mv and len(scene.cbvh.mv_spans) != n_mv:
        return "the scene's BVH lacks its mesh volumes' slots (mv_spans)"
    if n_mv and env_is_active(scene):
        return ("HDRI importance sampling with mesh volumes needs the XLA "
                "integrator, not ported yet (ROADMAP A6): the shadow-ray "
                "kernel does not model a mesh volume's stochastic "
                "occlusion, as in the JAX package")
    if scene.materials.has_mix and (mix_depth(scene.materials)
                                    > M.MAX_MIX_DEPTH):
        return (f"mixes nested deeper than {M.MAX_MIX_DEPTH} levels (or a "
                "cycle): a hit resolves one level a coin, as the JAX "
                "package")
    if scene.settings.mode not in (MODE_FULL, MODE_CLAY, *VIEWS):
        return f"unknown render mode {scene.settings.mode!r}"
    return None


# ------------------------------------------------------------- packing

class Tree(NamedTuple):
    nodes_f: torch.Tensor  # (K, 6) float32
    nodes_i: torch.Tensor  # (K, 3) int32 [hit_link, miss_link, chunk]
    chunk_len: torch.Tensor  # (n_chunks,) int32
    geo: torch.Tensor      # (n_chunks * leaf, 4 or 12) float32
    mat: torch.Tensor      # (n_chunks * leaf,) int32 raw material id
    links: np.ndarray      # nodes_i on the host: the plain version's walk
    leaf_size: int
    # volume trees: each slot's -1/density and its volume's ordinal (its
    # sphere row minus the solid spheres), which picks its uniform column
    nid: Optional[torch.Tensor] = None      # (n_chunks * leaf,) float32
    ordinal: Optional[torch.Tensor] = None  # (n_chunks * leaf,) int32


class MeshVols(NamedTuple):
    """The mesh volumes' boundary triangles, constants (no gradient): their
    trees, which the crossing scan walks, and the rows of
    ``ChunkedBVH.mv_perm``, which the replay's rescan and the tests' dense
    ``_mv_min_t`` read."""
    geo: torch.Tensor    # (S, 12) float32 [v0, e1, e2, normal], 0 padding
    start: torch.Tensor  # (V,) int32 each volume's first slot
    count: torch.Tensor  # (V,) int32 its triangles
    nid: torch.Tensor    # (V,) float32 -1/density
    mat: torch.Tensor    # (V,) int32 raw phase material id
    spans: tuple         # ((first slot, triangles), ...) on the host
    leaf_size: int
    # every volume's tree, one after another: links and chunks global
    tree: Tree
    bounds: torch.Tensor  # (V, 2) int32 [first node, end]
    walks: tuple          # ((first node, end), ...) on the host


class Mixes(NamedTuple):
    """The material table's mix columns, for the resolution rounds
    (ops/shade.resolve_mix reads them by these names)."""
    kind: torch.Tensor        # (M,) int32
    mix_first: torch.Tensor   # (M,) int32, self for a non-mix row
    mix_second: torch.Tensor  # (M,) int32
    mix_factor: torch.Tensor  # (M,) float32


class BvhScene(NamedTuple):
    head: torch.Tensor     # (20,) float32 camera, background, pixel scale
    mats: torch.Tensor     # (M, 8) float32 albedo rgb, fuzz, ir, emission
    kinds: torch.Tensor    # (M,) int32
    spheres: Optional[Tree]
    triangles: Optional[Tree]
    # the decision bits a record holds: REC_METAL_OK and REC_REFLECT when
    # a metal or a dielectric is reachable from a primitive
    rec_mask: int = 0
    volumes: Optional[Tree] = None
    n_vol: int = 0         # volume spheres: their uniform columns
    mixes: Optional[Mixes] = None  # with any mix in the table
    iso: bool = False      # an isotropic material is reachable: column u_r
    mesh_vols: Optional[MeshVols] = None

    @property
    def device(self) -> torch.device:
        return self.head.device

    @property
    def vol_base(self) -> int:
        """The code of volume slot 0: the sphere tree's slot count."""
        return self.spheres.geo.shape[0] if self.spheres else 0

    @property
    def tri_base(self) -> int:
        """The code of triangle slot 0: the slot count of the sphere and
        volume trees."""
        return self.vol_base + (self.volumes.geo.shape[0] if self.volumes
                                else 0)

    @property
    def mv_base(self) -> int:
        """The code of mesh volume 0: the slot count of the three trees."""
        return self.tri_base + (self.triangles.geo.shape[0]
                                if self.triangles else 0)

    @property
    def n_mv(self) -> int:
        return 0 if self.mesh_vols is None else len(self.mesh_vols.spans)

    def shade_cols(self) -> tuple[int, int]:
        """(off, n): the first lobe column of a bounce's uniforms and how
        many columns a bounce draws."""
        off = M.MAX_MIX_DEPTH if self.mixes is not None else 0
        if self.n_vol or self.n_mv or self.iso:
            return off, off + 4 + self.n_vol + self.n_mv
        return off, off + 3

    def with_rows(self, head, mats, sph_geo, tri_geo,
                  vol_geo=None) -> "BvhScene":
        """The same scene over other head, table and primitive rows."""
        def swap(tree, geo):
            return None if tree is None else tree._replace(geo=geo)

        return self._replace(
            head=head, mats=mats, spheres=swap(self.spheres, sph_geo),
            triangles=swap(self.triangles, tri_geo),
            volumes=swap(self.volumes, vol_geo))


def _tree(t: Optional[ChunkTree], rows: torch.Tensor, mat: torch.Tensor,
          device, nid=None, n_solid=0) -> Optional[Tree]:
    if t is None:
        return None
    perm = torch.as_tensor(t.perm, device=rows.device).long()
    pad = perm < 0
    idx = perm.clamp(min=0)
    geo = torch.where(pad[:, None], 0.0, rows[idx])
    extra = {}
    if nid is not None:  # a volume tree's slots hold global sphere rows
        extra = dict(
            nid=torch.where(pad, 0.0, nid[idx].detach()).to(
                torch.float32).contiguous().to(device),
            ordinal=torch.where(pad, 0, idx - n_solid).to(
                torch.int32).to(device))
    return Tree(torch.as_tensor(t.nodes_f).to(device),
                torch.as_tensor(t.nodes_i).to(device),
                torch.as_tensor(t.chunk_len).to(device),
                geo.to(torch.float32).contiguous().to(device),
                torch.where(pad, 0, mat[idx]).to(torch.int32).to(device),
                t.nodes_i, t.leaf_size, **extra)


def _joined(trees: tuple) -> tuple:
    """(one ChunkTree of every tree of ``trees`` one after another, their
    (first node, end) pairs): each tree's links and chunks offset by the
    nodes and chunks before it, so each walk ends at its own end."""
    nodes_f, nodes_i, perms, walks = [], [], [], []
    node0 = chunk0 = 0
    for t in trees:
        links = t.nodes_i.astype(np.int64)
        links = np.stack([links[:, 0] + node0, links[:, 1] + node0,
                          np.where(links[:, 2] >= 0, links[:, 2] + chunk0,
                                   -1)], axis=1)
        nodes_f.append(t.nodes_f)
        nodes_i.append(links.astype(np.int32))
        perms.append(t.perm)
        walks.append((node0, node0 + t.n_nodes))
        node0 += t.n_nodes
        chunk0 += t.n_chunks
    return ChunkTree(np.concatenate(nodes_f).reshape(-1, 6),
                     np.concatenate(nodes_i).reshape(-1, 3),
                     np.concatenate(perms), trees[0].leaf_size), tuple(walks)


def _mesh_vols(scene: Scene, device) -> Optional[MeshVols]:
    """The mesh volumes' scan constants, None without mesh volumes.  A
    scene whose BVH lacks the volumes' trees gets them built here, once:
    they are kept in ``scene.cbvh``."""
    n_mv, cb = scene.num_mesh_volumes, scene.cbvh
    if not n_mv:
        return None
    if len(cb.mv_spans) != n_mv:
        raise ValueError("the scene's BVH lacks its mesh volumes' slots")
    tri = scene.triangles
    if len(cb.mv_trees) != n_mv:
        from .bvh import build_mv_trees

        cb = scene.cbvh = dataclasses.replace(
            cb, mv_trees=build_mv_trees(tri))
        if len(cb.mv_trees) != n_mv:
            raise ValueError(f"{n_mv} mesh volumes, but the triangles bound "
                             f"{len(cb.mv_trees)}")
    perm = torch.as_tensor(cb.mv_perm, device=tri.v0.device).long()
    pad = perm < 0
    rows = torch.cat([tri.v0, tri.e1, tri.e2, tri.normal], 1).detach()
    geo = torch.where(pad[:, None], 0.0, rows[perm.clamp(min=0)])
    joined, walks = _joined(cb.mv_trees)
    live = (cb.mv_perm >= 0).reshape(-1, cb.leaf_size).sum(axis=1)
    spans = tuple((c0 * cb.leaf_size, int(live[c0:c0 + nc].sum()))
                  for c0, nc in cb.mv_spans)
    mv = scene.mesh_volumes
    return MeshVols(
        geo.to(torch.float32).contiguous().to(device),
        torch.tensor([s for s, _ in spans], dtype=torch.int32, device=device),
        torch.tensor([n for _, n in spans], dtype=torch.int32, device=device),
        mv.neg_inv_density.detach().to(torch.float32).contiguous().to(device),
        mv.material.to(torch.int32).contiguous().to(device), spans,
        cb.leaf_size, _tree(joined, rows, tri.material, device),
        torch.tensor(walks, dtype=torch.int32, device=device).reshape(-1, 2),
        walks)


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
    used = reachable_kinds(mats, torch.cat([sph.material, tri.material]))
    rec_mask = ((REC_METAL_OK if M.METAL in used else 0)
                | (REC_REFLECT if M.DIELECTRIC in used else 0))
    mixes = None
    if mats.has_mix:
        mixes = Mixes(*(v.detach().contiguous().to(device) for v in (
            mats.kind.to(torch.int32), mats.mix_first.to(torch.int32),
            mats.mix_second.to(torch.int32),
            mats.mix_factor.to(torch.float32))))
    n_vol = sph.num_volumes
    centers = torch.cat([sph.center, sph.radius[:, None]], 1)
    return BvhScene(
        K.pack_head(scene, width, height).contiguous().to(device),
        table.contiguous().to(device),
        mats.kind.to(torch.int32).contiguous().to(device),
        _tree(cb.spheres, centers, sph.material, device),
        _tree(cb.triangles, torch.cat([tri.v0, tri.e1, tri.e2, tri.normal],
                                      1), tri.material, device),
        rec_mask,
        _tree(cb.volumes, centers, sph.material, device,
              nid=sph.neg_inv_density, n_solid=len(sph) - n_vol),
        n_vol, mixes, M.ISOTROPIC in used, _mesh_vols(scene, device))


# ------------------------------------------------------------- plain version

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _quadratic(geo, o, d, a):
    """The direct (o - c) quadratic of (R, L) rays and spheres: (disc >= 0,
    near root, far root, radius row), with true division."""
    cx, cy, cz, r = (v[None, :] for v in geo.unbind(-1))
    ox, oy, oz = (v[:, None] for v in o)
    dx, dy, dz = (v[:, None] for v in d)
    a = a[:, None]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = hb * hb - a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return disc >= 0.0, (-hb - sq) / a, (-hb + sq) / a, r


def _sphere_leaf(tree, s, o, d, a, t_best):
    """Candidate distances (R, L) of the spheres of slots ``s``
    (``_sphere_chunk_hit`` op for op: the near root if in [T_MIN, t_best],
    else the far root; radius 0 never hits)."""
    ok, t1, t2, r = _quadratic(tree.geo[s], o, d, a)
    ok = ok & (r > 0.0)
    tb = t_best[:, None]
    t1ok = (t1 >= T_MIN) & (t1 <= tb)
    t2ok = (t2 >= T_MIN) & (t2 <= tb)
    return torch.where(ok & t1ok, t1,
                       torch.where(ok & t2ok, t2, float("inf")))


def _volume_window(tree, s, o, d, a):
    """(valid, h1, h2) of (R, L) rays and the volume spheres of slots
    ``s``: the boundary window from the quadratic, the far root only when
    at least T_MIN past the near one, the entry clamped to T_MIN, then to
    0."""
    ok, t1, t2, r = _quadratic(tree.geo[s], o, d, a)
    h1 = torch.clamp(t1, min=T_MIN)
    h2 = torch.where(t2 >= t1 + T_MIN, t2, float("inf"))
    valid = ok & (r > 0.0) & (h1 < h2)
    return valid, torch.clamp(h1, min=0.0), h2


def _volume_leaf(tree, s, o, d, a, t_best, ray_len, u_vol):
    """Candidate distances (R, L) of the volume spheres of slots ``s``
    (``_vol_chunk_hit`` op for op): the boundary window [h1, h2], then the
    free flight ``-1/density * log(u)`` along the ray from its entry, with
    the volume's own uniform (column ``ordinal`` of ``u_vol``), accepted
    when it ends inside the window and nearer than t_best."""
    valid, h1, h2 = _volume_window(tree, s, o, d, a)
    u = u_vol[:, tree.ordinal[s].long()]
    ray_len = ray_len[:, None]
    dist_inside = (h2 - h1) * ray_len
    hit_dist = tree.nid[s][None, :] * torch.log(torch.clamp(u, min=1e-37))
    ti = h1 + hit_dist / ray_len
    return torch.where(valid & (hit_dist <= dist_inside)
                       & (ti < t_best[:, None]), ti, float("inf"))


def _moller_trumbore(geo, o, d):
    """(t, inside) of (R, L) rays and the triangles of rows ``geo``, (L, 12)
    for every ray or (R, L, 12) a ray: ``_row_mt``, the direct
    cross-product Moller-Trumbore, t at any sign; ``inside``: the
    determinant away from 0 and the barycentrics in the triangle."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        v if geo.dim() == 3 else v[None, :]
        for v in geo[..., :9].unbind(-1))
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
    return tt, ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)


def _triangle_leaf(tree, s, o, d, a, t_best):
    """Candidate distances (R, L) of the triangles of slots ``s``, with t
    in (T_MIN, t_best]."""
    tt, inside = _moller_trumbore(tree.geo[s], o, d)
    valid = inside & (tt > T_MIN) & (tt <= t_best[:, None])
    return torch.where(valid, tt, float("inf"))


def _walk(tree: Tree, leaf, o, d, inv_d, a, alive, t_best, win, tally,
          name, any_hit=False, extra=()):
    """Each alive ray's stackless walk of one tree, vectorized: the rays
    whose cursor is at node k take its slab test (``_traverse_tree``'s:
    NaN-propagating min/max, so an axis-parallel NaN reads as a miss), test
    the leaf's primitives if the box is hit, and move to the hit or miss
    link.  Links only go forward, so one sweep over k in order is every
    ray's walk.  A leaf's winner is its nearest candidate, the lowest slot
    among equals; it replaces the ray's winner only when strictly nearer
    (``_merge_leaf_rows``).  ``t_best`` and ``win`` (the winning slot)
    change in place.  ``extra``: per-ray tensors the leaf takes after
    ``t_best`` (a volume leaf's ray lengths and uniforms).  ``any_hit``: a
    ray leaves the walk at the first leaf that has a candidate nearer than
    its ``t_best``, and the tally counts its tests up to the first such
    slot (the occlusion kernel's walk)."""
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
        cursor[at] = torch.where(box, hit_l, miss_l)
        if chunk < 0:
            continue
        rays = at[box]
        n = int(tree.chunk_len[chunk])
        if rays.numel() == 0 or n == 0:
            continue
        base = chunk * tree.leaf_size
        tb = t_best[rays]
        ti = leaf(tree, slice(base, base + n), [v[rays] for v in o],
                  [v[rays] for v in d], a[rays], tb,
                  *(e[rays] for e in extra))
        t_min = ti.min(dim=1).values
        lane = torch.arange(n, device=ti.device)
        first = torch.where(ti == t_min[:, None], lane, n).min(dim=1).values
        better = t_min < tb
        t_best[rays] = torch.where(better, t_min, tb)
        win[rays] = torch.where(better, base + first, win[rays])
        if tally is not None:  # any-hit: tests up to its first candidate
            tested = torch.full_like(t_min, n, dtype=torch.long)
            if any_hit:
                tested = torch.where(ti < tb[:, None], lane + 1, n).min(
                    dim=1).values
            tally[name] += int(tested.sum())
            if tree.nid is not None:  # the windows a ray crosses: draws
                window = _volume_window(tree, slice(base, base + n),
                                        [v[rays] for v in o],
                                        [v[rays] for v in d], a[rays])[0]
                tally["volume_draws"] += int(
                    (window & (lane[None, :] < tested[:, None])).sum())
        if any_hit:
            cursor[rays[better]] = k_nodes


def _walk_all(sc: BvhScene, o, d, a, alive, u_vol, tally, any_hit=False):
    """Every tree's walk in the JAX order (spheres, volumes, triangles),
    each from the nearest hit of the walks before it; -> (t_best, winning
    slot of each tree, -1 where it has none).  ``any_hit``: the occlusion
    test's walk, where a ray occluded by one tree walks no other."""
    inv_d = [1.0 / v for v in d]
    t_best = torch.full_like(a, float("inf"))
    wins = []
    for tree, leaf, name, extra in (
            (sc.spheres, _sphere_leaf, "sphere_tests", ()),
            (sc.volumes, _volume_leaf, "volume_tests",
             () if sc.volumes is None else (torch.sqrt(a), u_vol)),
            (sc.triangles, _triangle_leaf, "triangle_tests", ())):
        win = torch.full(a.shape, -1, dtype=torch.long, device=a.device)
        if tree is not None:
            live = alive & ~(t_best < float("inf")) if any_hit else alive
            _walk(tree, leaf, o, d, inv_d, a, live, t_best, win, tally,
                  name, any_hit=any_hit, extra=extra)
        wins.append(win)
    return t_best, wins


def _mv_min_t(mv: MeshVols, start: int, count: int, o, d, floor, tally):
    """(R,) the least raw Moller-Trumbore t at or above ``floor`` (R,) of
    the triangles of slots [start, start + count), else inf
    (``_mv_min_t``, the JAX kernel's dense scan), a chunk of leaf_size
    triangles at a time: no (R, T) matrix.  The replay's rescan reads it,
    and the tests hold :func:`_mv_walk` to it."""
    best = torch.full_like(floor, float("inf"))
    for c in range(start, start + count, mv.leaf_size):
        tt, inside = _moller_trumbore(
            mv.geo[c:min(c + mv.leaf_size, start + count)], o, d)
        ti = torch.where(inside & (tt >= floor[:, None]), tt, float("inf"))
        best = torch.minimum(best, ti.min(dim=1).values)
    if tally is not None:
        tally["mv_tests"] += floor.numel() * count
    return best


def _mv_walk(mv: MeshVols, v: int, o, d, inv_d, floor, root_floor, bound,
             tally, keep: bool = False):
    """(R,) the least raw Moller-Trumbore t at or above ``floor`` (R,) of
    mesh volume ``v``'s boundary triangles in the leaves its tree's walk
    reaches (bvh_walk.cuh ``mv_walk``), else inf.  A node's box gives the
    interval [entry, exit] of the ray's line inside it, all three slabs at
    any t, a slab whose end is NaN (a line in one of its planes) the whole
    line; the walk goes into the node when entry <= exit and neither
    entry - s > ``bound`` nor exit + s < ``floor`` (``root_floor`` at the
    root), s = MV_SLACK * max(|entry|, |exit|), and tests a leaf's
    triangles.  Those decisions do not depend on what was found, so the
    walk here goes a level of the tree at a time, over every (ray, node)
    pair: the nodes and leaves the kernel's stackless walk visits, in
    another order.  With ``bound`` inf and ``root_floor`` equal to
    ``floor``: :func:`_mv_min_t`'s answer.  ``keep`` (the entry walk):
    -> (that, t2), t2 the least crossing found at or past it + T_MIN when
    the walk found at most MV_KEEP crossings and no box it skipped for
    ``bound`` begins (entry - s) below t2, else NaN: the kernel's kept
    crossings.  The tally counts node visits ("mv_nodes") and triangle
    tests ("mv_tests")."""
    tree = mv.tree
    first, end = mv.walks[v]
    inf = float("inf")
    best = torch.full_like(floor, inf)
    if end <= first or floor.numel() == 0:
        return (best, best.clone()) if keep else best
    o3, d3, inv3 = (torch.stack(x, 1) for x in (o, d, inv_d))
    links = tree.nodes_i.long()
    n_len = tree.chunk_len.long()
    lane = torch.arange(tree.leaf_size, device=floor.device)
    ray = torch.arange(floor.numel(), device=floor.device)
    node = torch.full_like(ray, first)
    lo = root_floor
    cut, kept_ray, kept_t = torch.full_like(floor, inf), [], []
    while ray.numel():
        box = tree.nodes_f[node]
        o_r, inv_r = o3[ray], inv3[ray]
        a = (box[:, :3] - o_r) * inv_r
        b = (box[:, 3:] - o_r) * inv_r
        nan = torch.isnan(a) | torch.isnan(b)
        entry = torch.where(nan, -inf, torch.minimum(a, b)).amax(1)
        exit_ = torch.where(nan, inf, torch.maximum(a, b)).amin(1)
        slack = MV_SLACK * torch.maximum(entry.abs(), exit_.abs())
        near = entry - slack
        past = near > bound[ray]
        overlap = entry <= exit_
        go_in = overlap & ~past & ~(exit_ + slack < lo[ray])
        if keep:  # a skipped box holds no crossing below its near end
            at = (overlap & past).nonzero().squeeze(1)
            cut.scatter_reduce_(0, ray[at], near[at], "amin")
        chunk = links[node, 2]
        if tally is not None:
            tally["mv_nodes"] += ray.numel()
        leaf = (go_in & (chunk >= 0)).nonzero().squeeze(1)
        for i in range(0, leaf.numel(), MV_PAIRS):  # bounded temporaries
            c, r = chunk[leaf[i:i + MV_PAIRS]], ray[leaf[i:i + MV_PAIRS]]
            n = n_len[c]
            tt, inside = _moller_trumbore(
                tree.geo[c[:, None] * tree.leaf_size + lane],
                o3[r].unbind(1), d3[r].unbind(1))
            ok = (lane < n[:, None]) & inside & (tt >= floor[r, None])
            best.scatter_reduce_(0, r, torch.where(ok, tt, inf).amin(1),
                                 "amin")
            if keep:
                kept_ray.append(r[:, None].expand_as(ok)[ok])
                kept_t.append(tt[ok])
            if tally is not None:
                tally["mv_tests"] += int(n.sum())
        inner = (go_in & (chunk < 0)).nonzero().squeeze(1)
        kids = links[node[inner], 0]  # the first child; then its skip link
        ray = torch.cat([ray[inner], ray[inner]])
        node = torch.cat([kids, links[kids, 1]])
        lo = floor
    if not keep:
        return best
    k_ray = torch.cat(kept_ray) if kept_ray else ray
    k_t = torch.cat(kept_t) if kept_t else floor[:0]
    count = torch.bincount(k_ray, minlength=floor.numel())
    at = k_t >= (best + T_MIN)[k_ray]
    t2 = torch.full_like(floor, inf).scatter_reduce_(0, k_ray[at], k_t[at],
                                                     "amin")
    return best, torch.where((count <= MV_KEEP) & (t2 <= cut), t2,
                             float("nan"))


def _mesh_volume_scan(sc: BvhScene, o, d, a, alive, u_vol, t_best, tally):
    """Each alive ray's crossing scan of every mesh volume in index order
    (pallas_megakernel.py:1620-1671): the entry t1, the least t at any sign
    of the volume's triangles, the exit t2 at or past t1 + T_MIN, both by
    :func:`_mv_walk`: the entry walk's kept crossings give t2, else a
    second walk (none without an entry); the window [max(t1, T_MIN, 0),
    t2], and the free flight of column ``n_vol + v`` of ``u_vol``, which
    wins when it ends inside the window and nearer than ``t_best``.  The
    entry walk skips, as the kernel's, a line that crosses the root box
    only before T_MIN (no window) and, with -1/density <= 0, boxes that
    begin past ``t_best`` (a window that opens there cannot win).
    ``t_best`` changes in place; -> (R,) the winning volume, -1 where
    none."""
    mv = sc.mesh_vols
    win = torch.full(a.shape, -1, dtype=torch.long, device=a.device)
    at = alive.nonzero().squeeze(1)
    if at.numel() == 0:
        return win
    o_a, d_a = [v[at] for v in o], [v[at] for v in d]
    inv_a = [1.0 / v for v in d_a]
    ray_len = torch.sqrt(a[at])
    tb, w = t_best[at], win[at]
    inf = float("inf")
    nid = mv.nid.tolist()
    for v in range(len(mv.spans)):
        t1, t2 = _mv_walk(mv, v, o_a, d_a, inv_a, torch.full_like(tb, -inf),
                          torch.full_like(tb, T_MIN),
                          tb if nid[v] <= 0.0 else torch.full_like(tb, inf),
                          tally, keep=True)
        again = ((t1 < inf) & torch.isnan(t2)).nonzero().squeeze(1)
        if again.numel():
            floor = t1[again] + T_MIN
            t2[again] = _mv_walk(mv, v, *([x[again] for x in y]
                                           for y in (o_a, d_a, inv_a)),
                                 floor, floor, torch.full_like(floor, inf),
                                 tally)
        h1 = torch.clamp(t1, min=T_MIN)
        valid = (t1 < inf) & (t2 < inf) & (h1 < t2)
        h1 = torch.clamp(h1, min=0.0)
        dist_inside = (t2 - h1) * ray_len
        hit_dist = mv.nid[v] * torch.log(
            torch.clamp(u_vol[at, sc.n_vol + v], min=1e-37))
        ti = h1 + hit_dist / ray_len
        won = valid & (hit_dist <= dist_inside) & (ti < tb)
        tb = torch.where(won, ti, tb)
        w = torch.where(won, v, w)
        if tally is not None:
            tally["mv_draws"] += int(valid.sum())
    t_best[at] = tb
    win[at] = w
    return win


def _intersect(sc: BvhScene, o, d, a, alive, u_vol, tally):
    """The nearest hit of each alive ray: the three trees' walks
    (:func:`_walk_all`), then the mesh volumes' scan; -> (t_best, the
    winning slot of each tree and the winning mesh volume, -1 where
    none)."""
    t_best, wins = _walk_all(sc, o, d, a, alive, u_vol, tally)
    if sc.mesh_vols is None:
        return t_best, wins + [torch.full_like(wins[0], -1)]
    return t_best, wins + [_mesh_volume_scan(sc, o, d, a, alive, u_vol,
                                             t_best, tally)]


def _winner(sc: BvhScene, pt, wins):
    """(outward normal, raw material id) of each ray's winner: a sphere's
    (p - c) / r by true division, a volume's dummy (1, 0, 0), a
    triangle's flat normal.  A ray that missed holds any value."""
    w_sph, w_vol, w_tri, w_mv = wins
    n = [torch.zeros_like(pt[0])] * 3
    mid = torch.zeros_like(w_sph)
    if sc.spheres is not None:
        g = sc.spheres.geo[w_sph.clamp(min=0)]
        r = g[:, 3]
        g_rad = torch.where(r > 0.0, r, 1.0)
        n = [(pt[c] - g[:, c]) / g_rad for c in range(3)]
        mid = sc.spheres.mat[w_sph.clamp(min=0)].long()
    if sc.volumes is not None:
        is_vol = w_vol >= 0
        n = [torch.where(is_vol, float(c == 0), n[c]) for c in range(3)]
        mid = torch.where(is_vol, sc.volumes.mat[w_vol.clamp(min=0)].long(),
                          mid)
    if sc.triangles is not None:
        is_tri = w_tri >= 0
        g = sc.triangles.geo[w_tri.clamp(min=0)]
        n = [torch.where(is_tri, g[:, 9 + c], n[c]) for c in range(3)]
        mid = torch.where(is_tri, sc.triangles.mat[w_tri.clamp(min=0)].long(),
                          mid)
    if sc.mesh_vols is not None:
        is_mv = w_mv >= 0
        n = [torch.where(is_mv, float(c == 0), n[c]) for c in range(3)]
        mid = torch.where(is_mv, sc.mesh_vols.mat[w_mv.clamp(min=0)].long(),
                          mid)
    return n, mid


def bounce_uniforms(sc: BvhScene, key, ray_ids, b):
    """(mix coins or None, the lobe's uniforms [u1, u2, coin] and u_r with
    an isotropic material, the volumes' (R, n_vol + n_mv) free-flight
    uniforms, the sphere volumes' then the mesh volumes') of bounce ``b``,
    in the JAX column layout."""
    off, n = sc.shade_cols()
    u = ray_uniforms(key, ray_ids, 1 + b, n)
    coins = u[:, :off].unbind(-1) if off else None
    lobe = u[:, off:off + (4 if sc.iso else 3)].unbind(-1)
    return coins, lobe, u[:, off + 4:]


def _view_tile(sc: BvhScene, key, ray_ids, px, py, max_depth, bg_kind, sky,
               debug, tally):
    """One tile of :func:`radiance_bvh_plain`'s inspection views (the JAX
    kernel's ``debug`` branch): one intersection, its volume candidates
    drawing from bounce stream 1; a hit gives ``0.5 * (n / |n| + 1)`` of
    the front-facing normal n ("normal") or black ("random"), a miss the
    background."""
    o, d = K.camera_ray(sc.head, key, ray_ids, px, py)
    zero = torch.zeros_like(d[0])
    if max_depth <= 0:
        return torch.stack([zero] * 3, dim=-1)
    _, _, u_vol = bounce_uniforms(sc, key, ray_ids, 0)
    a = _dot3(*d, *d)
    alive = torch.ones_like(a, dtype=torch.bool)
    t_best, wins = _intersect(sc, o, d, a, alive, u_vol, tally)
    hit = t_best < float("inf")
    if tally is not None:
        tally["bounces"] += a.numel()
        tally["misses"] += int((~hit).sum())
        tally["view_hits"] += int(hit.sum())
    bg = (K.sky_where(sky, d, ~hit, tally).unbind(-1) if sky is not None
          else K.background(sc.head, bg_kind, d))
    col = [zero] * 3
    if debug == "normal":
        safe_t = torch.where(hit, t_best, 1.0)
        n, _ = _winner(sc, [o[c] + safe_t * d[c] for c in range(3)], wins)
        sgn = torch.where(_dot3(*d, *n) < 0.0, 1.0, -1.0)
        n = [v * sgn for v in n]
        inv_n = 1.0 / torch.sqrt(torch.clamp(_dot3(*n, *n), min=1e-30))
        col = [0.5 * (v * inv_n + 1.0) for v in n]
    return torch.stack([torch.where(hit, col[c], bg[c]) for c in range(3)],
                       dim=-1)


def _bvh_tile(sc: BvhScene, key, ray_ids, px, py, max_depth, bg_kind, clay,
              tally, rec, sky):
    """One tile of :func:`radiance_bvh_plain`; ``rec``, when not None, is
    the tile's (max_depth, R) int32 record, filled with -1, to write the
    codes into."""
    o, d = K.camera_ray(sc.head, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    rec_mask = 0 if clay else sc.rec_mask
    for b in range(max_depth):
        if not bool(alive.any()):
            break  # dead rays never change: stopping early is exact
        coins, u, u_vol = bounce_uniforms(sc, key, ray_ids, b)
        dx, dy, dz = d
        a = _dot3(dx, dy, dz, dx, dy, dz)
        t_best, wins = _intersect(sc, o, d, a, alive, u_vol, tally)
        hit = t_best < float("inf")
        safe_t = torch.where(hit, t_best, 1.0)
        pt = [o[c] + safe_t * d[c] for c in range(3)]
        n, mid = _winner(sc, pt, wins)
        if coins is not None:
            mid = resolve_mix(sc.mixes, mid, coins)
        kind = sc.kinds[mid]
        if tally is not None:
            tally["bounces"] += int(alive.sum())
            tally["misses"] += int((alive & ~hit).sum())
            for k in range(5):
                tally[f"hits_{k}"] += int((alive & hit & (kind == k)).sum())
        decided = None if rec is None else {}
        entering = alive
        if sky is not None:  # an escaping ray adds the sky's texel
            missed = alive & ~hit
            bg = K.sky_where(sky, d, missed, tally)
            rad = [rad[c] + torch.where(missed, thr[c] * bg[:, c], 0.0)
                   for c in range(3)]
        o, d, thr, rad, alive = K.bounce_tail(
            sc.head, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n,
            sc.mats[mid].unbind(-1), kind, u, decisions=decided)
        if rec is not None:
            w_sph, w_vol, w_tri, w_mv = wins
            code = torch.where(w_tri >= 0, w_tri + sc.tri_base,
                               torch.where(w_vol >= 0, w_vol + sc.vol_base,
                                           w_sph))
            code = torch.where(w_mv >= 0, w_mv + sc.mv_base, code)
            code = code | torch.where(decided["front"], REC_FRONT, 0)
            for bit, name in ((REC_METAL_OK, "metal_ok"),
                              (REC_REFLECT, "reflect")):
                if rec_mask & bit:
                    code = code | torch.where(decided[name], bit, 0)
            rec[b] = torch.where(entering & hit, code, -1)
    return torch.stack(rad, dim=-1)


def _check_background(bg_kind: int, sky, record: bool, debug) -> None:
    """A sky map's lookup needs the sky; the record walk takes none, nor a
    view."""
    if (bg_kind == B.SKYMAP) != (sky is not None):
        raise ValueError("a sky map background (bg_kind SKYMAP) is looked "
                         "up in `sky`, and only then")
    if debug not in (None, "normal", "random"):
        raise ValueError(f"unknown view {debug!r}")
    if record and (sky is not None or debug is not None):
        raise ValueError("the record walk runs under a uniform or gradient "
                         "background (the codes do not depend on it), and "
                         "in Full or Clay mode")


def radiance_bvh_plain(sc: BvhScene, key: tuple[int, int],
                       ray_ids: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor, *, max_depth: int, bg_kind: int,
                       clay: bool, tally=None, record: bool = False,
                       sky: Optional[B.Background] = None,
                       debug: Optional[str] = None):
    """Per-ray radiance (R, 3) float32 of the rays ``prep_rays`` gives, in
    tensor ops on ``sc``'s device: what the CUDA kernel computes, operation
    for operation (per-ray walks, true division in the sphere root and
    normal, ``1 / sqrt`` where the JAX kernel has rsqrt).  With ``record``,
    -> (radiance, codes (max_depth, R) int32), the radiance unchanged.
    ``sky``: the SKYMAP background, on ``sc``'s device.  ``debug``:
    "normal" or "random", the inspection view instead.  ``tally``, for
    measurement only, is a ``collections.Counter`` that receives the work
    the rays did: node visits, sphere, volume and triangle tests, the mesh
    volumes' Moller-Trumbore tests ("mv_tests") and the windows whose free
    flight they drew ("mv_draws"), rays entering a bounce, misses, hits by
    resolved kind (a view's hits as "view_hits"), and under a sky map a mask
    of the texels looked up ("sky_texels")."""
    _check_background(bg_kind, sky, record, debug)
    n = ray_ids.shape[0]
    codes = (torch.full((max_depth, n), -1, dtype=torch.int32,
                        device=px.device) if record else None)

    def tile(i):
        at = slice(i, i + TILE_RAYS)
        if debug is not None:
            return _view_tile(sc, key, ray_ids[at], px[at], py[at],
                              max_depth, bg_kind, sky, debug, tally)
        return _bvh_tile(sc, key, ray_ids[at], px[at], py[at], max_depth,
                         bg_kind, clay, tally,
                         None if codes is None else codes[:, at], sky)

    rad = torch.cat([tile(i) for i in range(0, n, TILE_RAYS)]) if n else \
        torch.zeros((0, 3), device=px.device)
    return (rad, codes) if record else rad


# ------------------------------------------------------------- the kernel

def _tree_args(t: Optional[Tree], cols: int, volume: bool = False):
    """(nodes_f, nodes_i, chunk_len, geo, mat pointers, for a volume tree
    also -1/density and ordinal, node count) of one tree, after checking
    it; null pointers and 0 for an absent tree."""
    n_ptr = 7 if volume else 5
    if t is None:
        return [ctypes.c_void_p(0)] * n_ptr + [0]
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
    ptrs = [t.nodes_f, t.nodes_i, t.chunk_len, t.geo, t.mat]
    if volume:
        K._check(t.nid, "nid", torch.float32, (slots,), dev)
        K._check(t.ordinal, "ordinal", torch.int32, (slots,), dev)
        ptrs += [t.nid, t.ordinal]
    return [ctypes.c_void_p(v.data_ptr()) for v in ptrs] + [k]


def _mix_args(sc: BvhScene):
    """The mix table's (first, second, factor) pointers, null without
    mixes, after checking it."""
    if sc.mixes is None:
        return [ctypes.c_void_p(0)] * 3
    m = sc.kinds.shape[0]
    for name, v, dtype in (("mix_first", sc.mixes.mix_first, torch.int32),
                           ("mix_second", sc.mixes.mix_second, torch.int32),
                           ("mix_factor", sc.mixes.mix_factor,
                            torch.float32)):
        K._check(v, name, dtype, (m,), sc.device)
    return [ctypes.c_void_p(v.data_ptr()) for v in sc.mixes[1:]]


def _leaf_size(sc: BvhScene) -> int:
    trees = [t for t in (sc.spheres, sc.volumes, sc.triangles, sc.mesh_vols)
             if t is not None]
    if not trees:
        raise ValueError("the scene has no tree")
    if len({t.leaf_size for t in trees}) > 1:
        raise ValueError("the trees have different leaf sizes")
    return trees[0].leaf_size


def _mv_args(sc: BvhScene) -> list:
    """The mesh volumes' tree (nodes, links, leaf counts, rows), each
    volume's (first node, end), -1/densities and material ids as pointers,
    then their count and the tree's leaf size, after checking them; null
    pointers and 0 without mesh volumes."""
    mv = sc.mesh_vols
    if mv is None:
        return [ctypes.c_void_p(0)] * 7 + [0, 0]
    n = len(mv.spans)
    if not 0 < n <= MAX_BVH_MESH_VOLUMES:
        raise ValueError(f"{n} mesh volumes; the kernel takes at most "
                         f"{MAX_BVH_MESH_VOLUMES}")
    dev = sc.device
    ptrs = _tree_args(mv.tree, 12)[:4]
    k = mv.tree.nodes_f.shape[0]
    if len(mv.walks) != n or any(not 0 <= a <= b <= k for a, b in mv.walks):
        raise ValueError(f"mesh volume walks {mv.walks} outside the {k} "
                         "nodes")
    K._check(mv.bounds, "mesh volume bounds", torch.int32, (n, 2), dev)
    for name, v, dtype in (("nid", mv.nid, torch.float32),
                           ("mat", mv.mat, torch.int32)):
        K._check(v, f"mesh volume {name}", dtype, (n,), dev)
    return ptrs + [ctypes.c_void_p(v.data_ptr()) for v in (
        mv.bounds, mv.nid, mv.mat)] + [n, mv.tree.leaf_size]


def _sky_args(sky: Optional[B.Background], dev) -> list:
    """The sky map's (texels pointer, height, width), after checking them;
    a null pointer without one."""
    if sky is None:
        return [ctypes.c_void_p(0), 0, 0]
    h, w = sky.image.shape[0], sky.image.shape[1]
    K._check(sky.image, "sky image", torch.float32, (h, w, 3), dev)
    return [ctypes.c_void_p(sky.image.data_ptr()), h, w]


def radiance_bvh_cuda(sc: BvhScene, key: tuple[int, int], n_rays: int,
                      spp: int, width: int, *, max_depth: int, bg_kind: int,
                      clay: bool, record: bool = False,
                      sky: Optional[B.Background] = None,
                      debug: Optional[str] = None):
    """Per-ray radiance (n_rays, 3) from the CUDA kernel for rays
    0 .. n_rays - 1, where ray id = pixel * spp + sample and pixels run
    row-major over ``width``.  With ``record``, the record variant:
    -> (radiance, codes (max_depth, n_rays) int32).  ``sky``: the SKYMAP
    background on the card, looked up in the kernel (its sky-map
    variant).  ``debug``: "normal" or "random", the inspection view's
    kernel instead."""
    global LAUNCHES, SKY_LAUNCHES, VIEW_LAUNCHES, RECORD_LAUNCHES
    global MV_LAUNCHES
    from . import _build

    dev = sc.device
    if dev.type != "cuda":
        raise ValueError(f"radiance_bvh_cuda needs CUDA tensors, got {dev}")
    if not 0 <= n_rays < 2 ** 31 or spp < 1 or width < 1 or max_depth < 0:
        raise ValueError(f"bad launch: n_rays={n_rays} spp={spp} "
                         f"width={width} max_depth={max_depth}")
    if not 0 <= sc.n_vol <= MAX_BVH_VOLUMES:
        raise ValueError(f"{sc.n_vol} volumes; the kernel takes at most "
                         f"{MAX_BVH_VOLUMES}")
    m = sc.kinds.shape[0]
    K._check(sc.head, "head", torch.float32, (K._SPHERES,), dev)
    K._check(sc.mats, "mats", torch.float32, (m, 8), dev)
    K._check(sc.kinds, "kinds", torch.int32, (m,), dev)
    K._check_key(key)
    _check_background(bg_kind, sky, record, debug)
    leaf = _leaf_size(sc)
    args = (_tree_args(sc.spheres, 4) + _tree_args(sc.volumes, 4, True)
            + _tree_args(sc.triangles, 12))
    view = {None: 0, "normal": 1, "random": 2}[debug]
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
            ctypes.c_void_p(sc.kinds.data_ptr()), m, *args, leaf,
            *_mix_args(sc), sc.n_vol, int(sc.iso), key[0], key[1],
            n_rays, spp, width, max_depth, int(bg_kind), int(bool(clay)),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(codes.data_ptr() if record else 0),
            0 if clay else sc.rec_mask, sc.vol_base, sc.tri_base,
            *_sky_args(sky, dev), view, *_mv_args(sc), sc.mv_base,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_bvh_radiance launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    if sc.mesh_vols is not None:
        MV_LAUNCHES += 1
    if record:
        RECORD_LAUNCHES += 1
        return out, codes
    if view:
        VIEW_LAUNCHES += 1
    elif sky is not None:
        SKY_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


# ------------------------------------------------------------- autograd

def _rows(sc: BvhScene) -> tuple:
    """The differentiable tensors: head, material table, the primitive rows
    of the sphere, triangle and volume trees (None for an absent tree)."""
    return (sc.head, sc.mats,
            *(None if t is None else t.geo for t in (sc.spheres,
                                                     sc.triangles,
                                                     sc.volumes)))


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


def fetch_inputs(sc: BvhScene) -> tuple:
    """The fetch pair's arguments after the codes: kinds, tri_base, the
    sphere-like slots' and the triangle slots' material ids, the material
    table, the sphere-like and the triangle rows, raw, and with mesh
    volumes mv_base and their material ids (else None, None).  The sphere
    and volume trees are one table of sphere-like rows to the fetch, slots
    ``sph | vol`` as in the codes (a differentiable concatenation); a mesh
    volume's code fetches its material and no geometry.  With a mix in the
    table the fetch is raw: it gives the winner's raw material id and no
    material rows, and the replay resolves the mix and indexes the table
    itself."""
    sphl = [t for t in (sc.spheres, sc.volumes) if t is not None]

    def cat(vs):
        return None if not vs else vs[0] if len(vs) == 1 else torch.cat(vs)

    tri = sc.triangles
    return (sc.kinds, sc.tri_base, cat([t.mat for t in sphl]),
            None if tri is None else tri.mat, sc.mats,
            cat([t.geo for t in sphl]), None if tri is None else tri.geo,
            sc.mixes is not None,
            *((None, None) if sc.mesh_vols is None
              else (sc.mv_base, sc.mesh_vols.mat)))


def replay(sc: BvhScene, codes: torch.Tensor, key, n_pixels: int, spp: int,
           width: int, *, max_depth: int, bg_kind: int, clay: bool,
           plain: bool = False, sky=None, occlude=None) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) replayed over recorded codes,
    differentiable in ``sc``'s head, material table and primitive rows: the
    winners' rows through ops/fetch.FetchRows (#6 forward, #7 backward on
    the card), then diff/replay.py's shading chain (with ``sky`` and
    ``occlude``, its MIS estimator).  ``plain`` fetches by the fetch's plain
    version under autograd instead, on any device: the route the kernels
    are held to."""
    from ..diff.replay import replay_rows_radiance
    from .fetch import FetchRows, fetch_rows_plain

    rows, kind = (fetch_rows_plain if plain else FetchRows.apply)(
        codes, *fetch_inputs(sc))
    ray_ids, px, py = K.prep_rays(
        torch.arange(n_pixels, device=codes.device), spp, width)
    return replay_rows_radiance(
        sc, rows, kind, codes, key, ray_ids, px, py, max_depth=max_depth,
        bg_kind=bg_kind, clay=clay, sky=sky, occlude=occlude)


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
    rows, d volume rows), None for an absent tree."""
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
                sph_geo, tri_geo, vol_geo):
        sc = sc.with_rows(head, mats, sph_geo, tri_geo, vol_geo)
        rad, codes = _record(sc, key, n_pixels, spp, width, **opts)
        ctx.save_for_backward(codes, head, mats, sph_geo, tri_geo, vol_geo)
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
             width: int, *, max_depth: int, bg_kind: int, clay: bool,
             sky: Optional[B.Background] = None,
             debug: Optional[str] = None) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) of pixels 0 .. n_pixels - 1:
    the kernel for a scene on a CUDA device, the plain version on the CPU.
    When a packed tensor or the sky's texels require grad, on either
    device: :class:`BvhRadiance` (the record walk, then the replay as its
    backward); with a sky map :func:`env_radiance` without its shadow rays
    (the record walk under a black background, then the replay with the
    sky as the result).  ``sky``: the SKYMAP background on ``sc``'s
    device.  ``debug``: "normal" or "random", the inspection view, which
    has no gradient (the JAX package gives its views no custom_vjp)."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay)
    grad = requires_grad(sc) or (sky is not None and torch.is_grad_enabled()
                                 and sky.image.requires_grad)
    if grad and debug is not None:
        raise ValueError(f"the {debug} view is an inspection view, not a "
                         "loss surface: it has no gradient")
    if grad and sky is not None:
        return env_radiance(sc, sky, key, n_pixels, spp, width,
                            max_depth=max_depth, clay=clay, mis=False)
    if grad:
        return BvhRadiance.apply(sc, key, n_pixels, spp, width, opts,
                                 *_rows(sc))
    if K.select_engine(sc.device) == "cuda":
        return radiance_bvh_cuda(sc, key, n_pixels * spp, spp, width,
                                 sky=sky, debug=debug, **opts)
    ray_ids, px, py = K.prep_rays(torch.arange(n_pixels), spp, width)
    return radiance_bvh_plain(sc, key, ray_ids, px, py, sky=sky, debug=debug,
                              **opts)


def env_radiance(sc: BvhScene, sky: B.Background, key: tuple[int, int],
                 n_pixels: int, spp: int, width: int, *, max_depth: int,
                 plain: bool = False, clay: bool = False,
                 mis: bool = True) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) under a sky map, replayed over
    the record walk: the record walk (#5's record variant on the card)
    under a black uniform background, since the codes do not depend on it;
    then :func:`replay` with the sky on a miss.  ``mis``: the HDRI
    importance-sampling path (the JAX ``_bvh_env_radiance``), whose replay
    adds the shadow rays of kernel #8 (ops/occlusion.py), once a bounce,
    which fly through the volumes with the NEE stream's uniforms, and
    weighs both samples by the balance heuristic; without it, the sky on a
    miss at weight 1 (the fit of a sky map without importance sampling).
    The replay is the result, differentiable in ``sc``'s head, material
    table and primitive rows (#6, #7 under autograd) and in ``sky``'s
    texels; the walk and the shadow rays are discrete.  ``plain``: the
    plain walk, fetch and occlusion test on ``sc``'s device, the route the
    kernels are held to."""
    from .occlusion import occluded, occluded_plain

    opts = dict(max_depth=max_depth, bg_kind=B.UNIFORM, clay=clay)
    with torch.no_grad():
        if plain:
            ray_ids, px, py = K.prep_rays(
                torch.arange(n_pixels, device=sc.device), spp, width)
            _, codes = radiance_bvh_plain(sc, key, ray_ids, px, py,
                                          record=True, **opts)
        else:
            _, codes = _record(sc, key, n_pixels, spp, width, **opts)
    test = occluded_plain if plain else occluded
    return replay(sc, codes, key, n_pixels, spp, width, max_depth=max_depth,
                  bg_kind=B.SKYMAP, clay=clay, plain=plain, sky=sky,
                  occlude=(lambda o, d, ids, stream: test(
                      sc, o, d, ray_ids=ids, key=key, stream=stream))
                  if mis else None)
