"""Vector math over (..., 3) float32 tensors: the camera basis and the sky
map's equirect lookup.

Sums run x + y + z left to right, the order the JAX package's float32
camera basis produces, so the packed camera constants agree bit for bit.
"""

from __future__ import annotations

import math

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, without an epsilon guard (as the reference)."""
    return v / torch.sqrt(dot(v, v))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def to_spherical_coords(v: torch.Tensor) -> torch.Tensor:
    """Direction -> (..., 2) (theta, phi) in the reference's convention:
    theta = acos(-y), phi = atan2(-z, x) + pi."""
    theta = torch.acos(torch.clamp(-v[..., 1], -1.0, 1.0))
    phi = torch.atan2(-v[..., 2], v[..., 0]) + math.pi
    return torch.stack([theta, phi], dim=-1)
