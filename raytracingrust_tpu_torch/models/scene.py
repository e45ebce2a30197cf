"""Scene model: settings, sphere and triangle arrays, the chunk-leaf BVH,
the scene and its builder, with the reference JSON schema
(raytracingrust_tpu/models/scene.py).

A ``Volume`` loads as in the JAX package: over a sphere its row sorts last
and the BVH holds it in a tree of its own; over a mesh its triangles carry
the volume's ordinal (``TriangleArray.volume``), stay out of the surface
triangle tree, and the volume's density and phase material go to a
:class:`MeshVolumeTable`.  ``build(with_bvh=None)`` builds the
chunk-leaf BVH and the flat BVH when ``settings.enable_bvh_tree`` asks for
them; the render path sends a scene to the BVH kernel only when the brute
kernel cannot take it, and to the generic engine when neither can
(render/render.select_engine).
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from .backgrounds import Background
from .camera import Camera
from .materials import (AnyMaterial, MaterialTable, build_table,
                        material_from_json, material_to_json)
from .mesh import Mesh

MODE_FULL = "Full"
MODE_CLAY = "Clay"
# the inspection views (lib/core/render.rs:42-49): one intersection, a
# hit shaded by its normal (Normal) or black (Random), a miss by the
# background
MODE_RANDOM = "Random"
MODE_NORMAL = "Normal"


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    samples_per_pixel: int = 5
    max_ray_depth: int = 6
    clamp_indirect: float = 10.0
    enable_multithreading: bool = True
    enable_bvh_tree: bool = True
    mode: str = MODE_FULL
    env_importance_sampling: bool = False

    def to_json(self) -> dict:
        d = {
            "samples_per_pixel": self.samples_per_pixel,
            "max_ray_depth": self.max_ray_depth,
            "clamp_indirect": self.clamp_indirect,
            "enable_multithreading": self.enable_multithreading,
            "enable_bvh_tree": self.enable_bvh_tree,
            "mode": self.mode,
        }
        if self.env_importance_sampling:
            d["env_importance_sampling"] = True
        return d

    @staticmethod
    def from_json(d: dict) -> "RenderSettings":
        return RenderSettings(
            samples_per_pixel=int(d["samples_per_pixel"]),
            max_ray_depth=int(d["max_ray_depth"]),
            clamp_indirect=float(d.get("clamp_indirect", 10.0)),
            enable_multithreading=bool(d.get("enable_multithreading", True)),
            enable_bvh_tree=bool(d.get("enable_bvh_tree", True)),
            mode=str(d.get("mode", MODE_FULL)),
            env_importance_sampling=bool(
                d.get("env_importance_sampling", False)),
        )


@dataclasses.dataclass
class SphereArray:
    """All spheres; volume-boundary spheres last."""

    center: torch.Tensor           # (N, 3) float32
    radius: torch.Tensor           # (N,) float32
    material: torch.Tensor         # (N,) int32 material handle
    neg_inv_density: torch.Tensor  # (N,) 0.0 = solid, else -1/density

    @property
    def num_volumes(self) -> int:
        return int((self.neg_inv_density != 0.0).sum())

    def __len__(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class TriangleArray:
    """All mesh triangles, flat-shaded."""

    v0: torch.Tensor        # (T, 3) float32
    e1: torch.Tensor        # (T, 3) v1 - v0 (Moller-Trumbore edge)
    e2: torch.Tensor        # (T, 3) v2 - v0
    normal: torch.Tensor    # (T, 3) the reference's face normal
    material: torch.Tensor  # (T,) int32 material handle
    # (T,) int32: -1 for a surface triangle, else the ordinal of the mesh
    # volume it bounds (it never shades as a surface)
    volume: torch.Tensor

    @staticmethod
    def empty() -> "TriangleArray":
        z = torch.zeros((0, 3), dtype=torch.float32)
        e = torch.zeros(0, dtype=torch.int32)
        return TriangleArray(z, z, z, z, e, e)

    def __len__(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class MeshVolumeTable:
    """Constant-density media bounded by triangle meshes (the reference's
    ``Volume::new`` over a Mesh, lib/volume.rs:25-31): per volume its
    -1/density and its phase material, the boundary mesh's material
    handle."""

    neg_inv_density: torch.Tensor  # (V,) float32
    material: torch.Tensor         # (V,) int32

    def __len__(self) -> int:
        return self.neg_inv_density.shape[0]


class FlatNodes(NamedTuple):
    """The flat BVH's nodes on one device, boxes aside: ``prim[i]`` a
    leaf's global primitive id ([0, N) spheres, [N, N + T) triangles), -1
    for an inner node; a walk whose ray hits node i's box goes on to
    ``hit_link[i]``, one that misses it to ``miss_link[i]``; ``levels``,
    deepest first, the (inner nodes, their first children, their second
    children) of each level, which ops/traverse.node_boxes reduces: one
    fewer than the tree's levels."""

    prim: torch.Tensor       # (K,) int64
    hit_link: torch.Tensor   # (K,) int64
    miss_link: torch.Tensor  # (K,) int64
    levels: tuple


class FlatBVH:
    """The flat skip-link BVH (the JAX ``FlatBVH``; the reference's
    unfinished ``LinearBvhTree``, lib/core/bvh.rs:201-293), one primitive
    a leaf, DFS order, ending at node K.  Only the generic engine's walk
    reads it, so it is built from the scene's rows on its first walk
    (:meth:`nodes`, ops/bvh.build_flat_bvh) and kept per device: a scene
    that a kernel takes never pays for its build.  It keeps no boxes: the
    walk takes them from the rows the scene holds then
    (ops/traverse.node_boxes), so a fit that moves a primitive moves its
    leaf's box and every box above it."""

    def __init__(self):
        self._on: dict = {}

    def nodes(self, scene: "Scene") -> FlatNodes:
        dev = scene.spheres.center.device
        if dev not in self._on:
            if "host" not in self._on:
                from ..ops.bvh import build_flat_bvh
                self._on["host"] = build_flat_bvh(
                    _tensors_to(scene.spheres, "cpu", detach=True),
                    _tensors_to(scene.triangles, "cpu", detach=True))
            host = self._on["host"]
            self._on[dev] = host._replace(
                prim=host.prim.to(dev), hit_link=host.hit_link.to(dev),
                miss_link=host.miss_link.to(dev),
                levels=tuple(tuple(x.to(dev) for x in lv)
                             for lv in host.levels))
        return self._on[dev]


@dataclasses.dataclass(frozen=True)
class ChunkTree:
    """One chunk-leaf skip-link tree (ops/bvh.py), host numpy arrays.  A
    leaf's primitives are slots [chunk * leaf_size, chunk * leaf_size +
    its count) of ``perm``; the rest of its chunk is padding (-1)."""

    nodes_f: np.ndarray  # (K, 6) float32 [min xyz | max xyz]
    nodes_i: np.ndarray  # (K, 3) int32 [hit_link, miss_link, chunk or -1]
    perm: np.ndarray     # (n_chunks * leaf_size,) int32 primitive ids
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return self.nodes_f.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.perm.shape[0] // self.leaf_size

    @property
    def chunk_len(self) -> np.ndarray:
        """(n_chunks,) int32 primitives in each chunk."""
        return (self.perm.reshape(-1, self.leaf_size) >= 0).sum(
            axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ChunkedBVH:
    """The JAX package's ChunkedBVH for the kinds the port renders: a tree
    over the solid spheres, one over the volume spheres and one over the
    surface triangles, traversed in that order (each pass starts from the
    nearest hit of the passes before it).  The volume tree's ``perm`` holds
    global sphere rows, as the JAX ``vol_perm`` does, and the triangle
    tree's global triangle rows.

    Mesh volumes are not in those trees: an entry crossing may lie at a
    negative t (a ray inside the medium), which a walk whose slab test
    floors t at T_MIN cannot find.  ``mv_perm`` holds each volume's global
    triangle rows, each volume padded with -1 to a multiple of
    ``leaf_size``, and ``mv_spans`` each volume's (first chunk, chunks): the
    JAX package's dense slots, which the replay scans.  ``mv_trees`` holds
    one small tree per volume over the same triangles
    (ops/bvh.build_mv_trees, padded boxes, leaves of ops/bvh.MV_LEAF),
    which kernel #5 and its plain version walk at any t.  ``sub_trees``
    holds the small trees inside the chunks of the sphere and the triangle
    tree (ops/bvh.build_sub_trees, each None for an absent tree; () when
    not built), which #5 walks inside a chunk."""

    spheres: Optional[ChunkTree]
    triangles: Optional[ChunkTree]
    volumes: Optional[ChunkTree] = None
    mv_perm: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    mv_spans: tuple = ()
    mv_trees: tuple = ()
    leaf_size: int = 128
    sub_trees: tuple = ()


def _tensors_to(obj, device, detach: bool = False):
    return dataclasses.replace(obj, **{
        f.name: (getattr(obj, f.name).detach() if detach
                 else getattr(obj, f.name)).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass
class Scene:
    camera: Camera
    background: Background
    spheres: SphereArray
    materials: MaterialTable
    settings: RenderSettings = RenderSettings()
    triangles: TriangleArray = dataclasses.field(
        default_factory=TriangleArray.empty)
    cbvh: Optional[ChunkedBVH] = None  # built by SceneBuilder.build
    mesh_volumes: Optional[MeshVolumeTable] = None
    bvh: Optional[FlatBVH] = None  # set beside cbvh, built lazily

    @property
    def num_primitives(self) -> int:
        return len(self.spheres) + len(self.triangles)

    @property
    def num_mesh_volumes(self) -> int:
        return 0 if self.mesh_volumes is None else len(self.mesh_volumes)

    def to(self, device) -> "Scene":
        """The scene with every tensor leaf on ``device`` (differentiable:
        a leaf that requires grad stays in the graph)."""
        return dataclasses.replace(
            self, camera=_tensors_to(self.camera, device),
            background=_tensors_to(self.background, device),
            spheres=_tensors_to(self.spheres, device),
            materials=_tensors_to(self.materials, device),
            triangles=_tensors_to(self.triangles, device),
            mesh_volumes=None if self.mesh_volumes is None else
            _tensors_to(self.mesh_volumes, device))


def with_bvhs(scene: Scene) -> Scene:
    """``scene`` with both its BVHs: the chunk-leaf one (with its small
    trees) that the kernels walk, built from its arrays, and the flat one
    that the generic engine walks, built on that walk's first call."""
    from ..ops.bvh import build_chunked_bvh, with_sub_trees
    sph, tri = scene.spheres, scene.triangles
    return dataclasses.replace(
        scene, cbvh=with_sub_trees(build_chunked_bvh(sph, tri), sph, tri),
        bvh=FlatBVH())


class SceneBuilder:
    """Authoring API of the reference's handle workflow, finalized into a
    :class:`Scene` by :meth:`build`."""

    def __init__(self):
        self.camera = Camera.default()
        self.settings = RenderSettings()
        self.background = Background.uniform((0.8, 0.8, 0.8))
        self.materials: list[AnyMaterial] = []
        self.objects: list[dict] = []

    def add_material(self, material: AnyMaterial) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_sphere(self, center, radius: float, material: int) -> int:
        self.objects.append({"kind": "sphere", "center": tuple(center),
                             "radius": float(radius),
                             "material": int(material)})
        return len(self.objects) - 1

    def add_volume(self, boundary_index: int, density: float) -> int:
        """Make a sphere or a mesh added before the boundary of a
        constant-density medium (``Volume::new`` takes any object,
        lib/volume.rs:25-31): it stops being a solid surface, and its
        material is the medium's phase material."""
        rec = self.objects[boundary_index]
        if rec["kind"] not in ("sphere", "mesh"):
            raise ValueError("a volume's boundary is a sphere or a mesh")
        rec["neg_inv_density"] = -1.0 / float(density)
        return boundary_index

    def add_mesh(self, mesh: Mesh) -> int:
        self.objects.append({"kind": "mesh", "mesh": mesh})
        return len(self.objects) - 1

    def build(self, with_bvh: Optional[bool] = None) -> Scene:
        """The scene, in the JAX package's row order.  ``with_bvh`` None
        means ``settings.enable_bvh_tree``."""
        sph = [o for o in self.objects if o["kind"] == "sphere"]
        centers = np.asarray([o["center"] for o in sph],
                             np.float32).reshape(-1, 3)
        radii = np.asarray([o["radius"] for o in sph], np.float32)
        mats = np.asarray([o["material"] for o in sph], np.int32)
        nids = np.asarray([o.get("neg_inv_density", 0.0) for o in sph],
                          np.float32)
        order = np.argsort(nids != 0.0, kind="stable")  # volumes last
        spheres = SphereArray(
            center=torch.as_tensor(centers[order]),
            radius=torch.as_tensor(radii[order]),
            material=torch.as_tensor(mats[order]),
            neg_inv_density=torch.as_tensor(nids[order]),
        )
        meshes = [o for o in self.objects if o["kind"] == "mesh"]
        triangles = TriangleArray.empty()
        mesh_volumes = None
        if meshes:
            soa = [np.concatenate(a) for a in
                   zip(*(o["mesh"].triangle_soa() for o in meshes))]
            mat = np.concatenate([np.full(o["mesh"].num_triangles,
                                          o["mesh"].material, np.int32)
                                  for o in meshes])
            # a mesh volume's triangles carry its ordinal, in object order
            vols = [o for o in meshes if o.get("neg_inv_density", 0.0)]
            ordinal = {id(o): v for v, o in enumerate(vols)}
            vol = np.concatenate([np.full(o["mesh"].num_triangles,
                                          ordinal.get(id(o), -1), np.int32)
                                  for o in meshes])
            triangles = TriangleArray(*map(torch.as_tensor,
                                           (*soa, mat, vol)))
            if vols:
                mesh_volumes = MeshVolumeTable(
                    torch.tensor([o["neg_inv_density"] for o in vols],
                                 dtype=torch.float32),
                    torch.tensor([o["mesh"].material for o in vols],
                                 dtype=torch.int32))
        if with_bvh is None:
            with_bvh = self.settings.enable_bvh_tree
        scene = Scene(self.camera, self.background, spheres,
                      build_table(self.materials), self.settings, triangles,
                      mesh_volumes=mesh_volumes)
        return with_bvhs(scene) if with_bvh else scene

    def to_json(self) -> dict:
        objs = []
        for o in self.objects:
            if o["kind"] == "mesh":
                entry = {"type": "Mesh", "path": o["mesh"].path,
                         "material": o["mesh"].material}
            else:
                c = o["center"]
                entry = {"type": "Sphere",
                         "center": {"x": c[0], "y": c[1], "z": c[2]},
                         "radius": o["radius"], "material": o["material"]}
            if o.get("neg_inv_density", 0.0) != 0.0:
                objs.append({"type": "Volume", "boundary": entry,
                             "neg_inv_density": o["neg_inv_density"]})
            else:
                objs.append(entry)
        return {
            "camera": self.camera.to_json(),
            "settings": self.settings.to_json(),
            "background": self.background.to_json(),
            "objects": objs,
            "materials": [material_to_json(m) for m in self.materials],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @staticmethod
    def from_json(d: dict) -> "SceneBuilder":
        b = SceneBuilder()
        b.camera = Camera.from_json(d["camera"])
        b.settings = RenderSettings.from_json(d["settings"])
        b.background = Background.from_json(d["background"])
        b.materials = [material_from_json(m) for m in d["materials"]]
        for o in d["objects"]:
            nid = 0.0
            if o["type"] == "Volume":
                nid = float(o["neg_inv_density"])
                o = o["boundary"]
            if o["type"] == "Mesh":
                # ``smooth`` is read by the schema and ignored: the
                # reference shades flat (quirk Q6)
                b.objects.append({"kind": "mesh", "mesh": Mesh.from_file(
                    o["path"], int(o["material"])), "neg_inv_density": nid})
                continue
            if o["type"] != "Sphere":
                raise ValueError(f"unknown object type {o['type']!r}")
            c = o["center"]
            b.objects.append({"kind": "sphere",
                              "center": (c["x"], c["y"], c["z"]),
                              "radius": float(o["radius"]),
                              "material": int(o["material"]),
                              "neg_inv_density": nid})
        return b

    @staticmethod
    def from_file(path: str) -> "SceneBuilder":
        with open(path) as f:
            return SceneBuilder.from_json(json.load(f))

