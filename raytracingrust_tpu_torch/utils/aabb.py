"""Axis-aligned boxes on the host, for the BVH builder
(raytracingrust_tpu/utils/aabb.py, its numpy half).

SoA over ``(N, 3)`` min/max arrays: the reference's ``AABB`` methods
(lib/utils/aabb.rs), vectorized.
"""

from __future__ import annotations

import numpy as np


def centroid(mins, maxs):
    """AABB::centroid (lib/utils/aabb.rs:27-29)."""
    return (mins + maxs) * 0.5


def epsilon_expand(mins, maxs, eps):
    """AABB::epsilon_expand (lib/utils/aabb.rs:56-77): per axis, a box
    thinner than ``eps`` grows to ``centroid +- eps``."""
    dims = maxs - mins
    c = centroid(mins, maxs)
    thin = dims < eps
    return np.where(thin, c - eps, mins), np.where(thin, c + eps, maxs)
