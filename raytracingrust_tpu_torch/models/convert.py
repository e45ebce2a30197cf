"""Build a port :class:`Scene` from plain arrays.

This is how scene parameters cross from the JAX package: take the leaves
of a JAX ``Scene`` with ``np.asarray`` under the names below and hand them
over, so both packages compute on identical float32 numbers.

Keys: ``camera.{lookfrom, lookat, vertical, vertical_fov, aspect_ratio}``,
``background.{color_a, color_b}`` and, for a sky map,
``background.{image, cdf_rows, cdf_cols}``,
``spheres.{center, radius, material, neg_inv_density}``,
``materials.{kind, albedo, fuzz, ir, emission, mix_first, mix_second,
mix_factor}`` and, for a scene with triangles,
``triangles.{v0, e1, e2, normal, material, volume}`` and, with mesh
volumes, ``mesh_volumes.{neg_inv_density, material}``.  The chunk-leaf
BVH is not carried: ``ops.bvh.build_chunked_bvh`` builds it from the
arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .backgrounds import Background
from .camera import Camera
from .materials import MaterialTable
from .scene import (MeshVolumeTable, RenderSettings, Scene, SphereArray,
                    TriangleArray)


def scene_from_arrays(arrays: dict[str, np.ndarray], settings: RenderSettings,
                      background_kind: int) -> Scene:
    def t(name, dtype):
        return torch.as_tensor(np.array(arrays[name], dtype))

    f32, i32 = np.float32, np.int32
    camera = Camera(t("camera.lookfrom", f32), t("camera.lookat", f32),
                    t("camera.vertical", f32), t("camera.vertical_fov", f32),
                    t("camera.aspect_ratio", f32))
    sky = [t(f"background.{k}", f32) if f"background.{k}" in arrays
           else None for k in ("image", "cdf_rows", "cdf_cols")]
    background = Background(background_kind, t("background.color_a", f32),
                            t("background.color_b", f32), *sky)
    spheres = SphereArray(t("spheres.center", f32), t("spheres.radius", f32),
                          t("spheres.material", i32),
                          t("spheres.neg_inv_density", f32))
    materials = MaterialTable(
        kind=t("materials.kind", i32), albedo=t("materials.albedo", f32),
        fuzz=t("materials.fuzz", f32), ir=t("materials.ir", f32),
        emission=t("materials.emission", f32),
        mix_first=t("materials.mix_first", i32),
        mix_second=t("materials.mix_second", i32),
        mix_factor=t("materials.mix_factor", f32),
    )
    triangles = TriangleArray.empty()
    if "triangles.v0" in arrays:
        triangles = TriangleArray(
            *(t(f"triangles.{k}", f32) for k in ("v0", "e1", "e2",
                                                 "normal")),
            t("triangles.material", i32), t("triangles.volume", i32))
    mesh_volumes = None
    if "mesh_volumes.neg_inv_density" in arrays:
        mesh_volumes = MeshVolumeTable(t("mesh_volumes.neg_inv_density", f32),
                                       t("mesh_volumes.material", i32))
    return Scene(camera, background, spheres, materials, settings, triangles,
                 mesh_volumes=mesh_volumes)
