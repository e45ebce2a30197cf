"""Vector math over (..., 3) float32 tensors — what the camera basis needs.

Sums run x + y + z left to right, the order the JAX package's float32
camera basis produces, so the packed camera constants agree bit for bit.
"""

from __future__ import annotations

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
