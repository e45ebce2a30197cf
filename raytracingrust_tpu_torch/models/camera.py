"""Pinhole camera (raytracingrust_tpu/models/camera.py).

lookfrom/lookat/up, vertical field of view in degrees and aspect ratio;
rays are ``lower_left + s * horizontal - t * vertical - origin`` (t runs
top-down).  The basis is float32 torch, in the JAX package's op order, so
the packed camera constants agree bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import vec
from ..utils.types import degrees_to_radians


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class Camera:
    lookfrom: torch.Tensor      # (3,)
    lookat: torch.Tensor        # (3,)
    vertical: torch.Tensor      # (3,) world up
    vertical_fov: torch.Tensor  # () degrees
    aspect_ratio: torch.Tensor  # ()

    @staticmethod
    def create(lookfrom, lookat, vertical=(0.0, 1.0, 0.0), vertical_fov=90.0,
               aspect_ratio=1.0) -> "Camera":
        return Camera(_f32(lookfrom), _f32(lookat), _f32(vertical),
                      _f32(vertical_fov), _f32(aspect_ratio))

    @staticmethod
    def default() -> "Camera":
        return Camera.create((0.0, 0.0, 0.0), (0.0, 0.0, -1.0))

    def ray_origin(self):
        """-> (origin, horizontal, vertical, lower_left), each (3,) float32."""
        theta = degrees_to_radians(self.vertical_fov)
        h = torch.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = self.aspect_ratio * viewport_height
        w = vec.normalize(self.lookfrom - self.lookat)
        u = vec.normalize(vec.cross(self.vertical, w))
        v = vec.cross(w, u)
        horizontal = viewport_width * u
        vertical = viewport_height * v
        lower_left = self.lookfrom - horizontal / 2.0 + vertical / 2.0 - w
        return self.lookfrom, horizontal, vertical, lower_left

    def to_json(self) -> dict:
        def v3(a):
            return {"x": float(a[0]), "y": float(a[1]), "z": float(a[2])}
        return {
            "lookfrom": v3(self.lookfrom),
            "lookat": v3(self.lookat),
            "vertical": v3(self.vertical),
            "vertical_fov": float(self.vertical_fov),
            "aspect_ratio": float(self.aspect_ratio),
        }

    @staticmethod
    def from_json(d: dict) -> "Camera":
        def v3(o):
            return (o["x"], o["y"], o["z"])
        return Camera.create(v3(d["lookfrom"]), v3(d["lookat"]),
                             v3(d["vertical"]), d["vertical_fov"],
                             d["aspect_ratio"])
