"""Axis-aligned boxes (raytracingrust_tpu/utils/aabb.py): on the host,
for the BVH builders, SoA over ``(N, 3)`` min/max numpy arrays (the
reference's ``AABB`` methods, lib/utils/aabb.rs, vectorized); on the
device, the slab test of the flat BVH's walk (ops/traverse.py).
"""

from __future__ import annotations

import numpy as np
import torch


def surround(min_a, max_a, min_b, max_b):
    """AABB::surround (lib/utils/aabb.rs:40-53), SoA."""
    return np.minimum(min_a, min_b), np.maximum(max_a, max_b)


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


def reduce_surround(mins, maxs):
    """Bounds of a whole collection -> ((3,), (3,)); zeros when empty."""
    if len(mins) == 0:
        return np.zeros(3, np.float32), np.zeros(3, np.float32)
    return mins.min(axis=0), maxs.max(axis=0)


def slab_hit(box_min, box_max, origin, inv_dir, tmin, tmax):
    """Batched ray/box slab test (AABB::hit, lib/utils/aabb.rs:81-137, in
    its branchless min/max form): (..., 3) boxes, origins and inverse
    directions, ``tmin``/``tmax`` scalars or (...,) tensors -> (hit mask,
    entry t).  The reference recomputes 1/d per axis; the caller passes it
    once a ray."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    entry = torch.clamp(lo.amax(dim=-1), min=tmin)
    exit_ = torch.clamp(hi.amin(dim=-1), max=tmax)
    return exit_ > entry, entry
