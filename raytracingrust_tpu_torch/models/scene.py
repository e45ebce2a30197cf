"""Scene model: settings, sphere arrays, the scene and its builder, with the
reference JSON schema (raytracingrust_tpu/models/scene.py).

The port covers sphere scenes.  A ``Mesh`` object, or a ``Volume`` whose
boundary is not a sphere, raises on load (ROADMAP A5).  A sphere-bounded
``Volume`` loads, as in the JAX package (volume rows sort last), and the
render path refuses it.  No BVH is built: the brute kernel needs none, and
``enable_bvh_tree`` is kept in the settings and ignored, as the JAX package
ignores it for sphere scenes on its brute kernel.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from .backgrounds import Background
from .camera import Camera
from .materials import (AnyMaterial, MaterialTable, build_table,
                        material_from_json, material_to_json)

MODE_FULL = "Full"
MODE_CLAY = "Clay"


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


def _tensors_to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass
class Scene:
    camera: Camera
    background: Background
    spheres: SphereArray
    materials: MaterialTable
    settings: RenderSettings = RenderSettings()

    def to(self, device) -> "Scene":
        """The scene with every tensor leaf on ``device`` (differentiable:
        a leaf that requires grad stays in the graph)."""
        return dataclasses.replace(
            self, camera=_tensors_to(self.camera, device),
            background=_tensors_to(self.background, device),
            spheres=_tensors_to(self.spheres, device),
            materials=_tensors_to(self.materials, device))


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

    def build(self, with_bvh: Optional[bool] = None) -> Scene:
        if with_bvh:
            raise NotImplementedError(
                "BVH construction is not ported yet (ROADMAP A7)")
        centers = np.asarray([o["center"] for o in self.objects],
                             np.float32).reshape(-1, 3)
        radii = np.asarray([o["radius"] for o in self.objects], np.float32)
        mats = np.asarray([o["material"] for o in self.objects], np.int32)
        nids = np.asarray([o.get("neg_inv_density", 0.0)
                           for o in self.objects], np.float32)
        order = np.argsort(nids != 0.0, kind="stable")  # volumes last
        spheres = SphereArray(
            center=torch.as_tensor(centers[order]),
            radius=torch.as_tensor(radii[order]),
            material=torch.as_tensor(mats[order]),
            neg_inv_density=torch.as_tensor(nids[order]),
        )
        return Scene(self.camera, self.background, spheres,
                     build_table(self.materials), self.settings)

    def to_json(self) -> dict:
        objs = []
        for o in self.objects:
            c = o["center"]
            sphere = {"type": "Sphere",
                      "center": {"x": c[0], "y": c[1], "z": c[2]},
                      "radius": o["radius"], "material": o["material"]}
            if o.get("neg_inv_density", 0.0) != 0.0:
                objs.append({"type": "Volume", "boundary": sphere,
                             "neg_inv_density": o["neg_inv_density"]})
            else:
                objs.append(sphere)
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
                raise NotImplementedError(
                    "Mesh objects are not ported yet (ROADMAP A5)")
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

