"""Vector math over (..., 3) float32 tensors: the camera basis, the sky
map's equirect lookup and the generic engine's shading
(raytracingrust_tpu/utils/vec.py).

Sums run x + y + z left to right, the order the JAX package's float32
camera basis produces, so the packed camera constants agree bit for bit.
"""

from __future__ import annotations

import math

import torch

from .types import NEAR_ZERO_EPS


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, without an epsilon guard (as the reference)."""
    return v / torch.sqrt(dot(v, v))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where every coordinate is below 1e-8 in magnitude
    (lib/utils/math.rs:6-9)."""
    return (v.abs() < NEAR_ZERO_EPS).all(dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``v`` mirrored about the normal ``n`` (lib/utils/math.rs:12-14)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat):
    """Snell refraction of the unit ``uv`` by its perpendicular and
    parallel parts (lib/utils/math.rs:16-21).  The radicand is kept at
    1e-12 or above, so the square root's derivative stays finite at
    grazing incidence."""
    cos_theta = torch.clamp(dot(n, -uv), max=1.0)
    out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    rad = torch.clamp((1.0 - length_squared(out_perp)).abs(), min=1e-12)
    return out_perp + (-torch.sqrt(rad))[..., None] * n


def to_spherical_coords(v: torch.Tensor) -> torch.Tensor:
    """Direction -> (..., 2) (theta, phi) in the reference's convention:
    theta = acos(-y), phi = atan2(-z, x) + pi."""
    theta = torch.acos(torch.clamp(-v[..., 1], -1.0, 1.0))
    phi = torch.atan2(-v[..., 2], v[..., 0]) + math.pi
    return torch.stack([theta, phi], dim=-1)
