"""Scalar conventions shared by the port (raytracingrust_tpu/utils/types.py).

Everything on the device is float32, as in the reference tracer.
"""

from __future__ import annotations

import math

PI = math.pi
INF = math.inf

# t-interval floor of the render loop (world.hit(ray, 0.00001, INFINITY))
T_MIN = 1e-5

# near_zero's per-coordinate threshold (lib/utils/math.rs:6-9)
NEAR_ZERO_EPS = 1e-8


def degrees_to_radians(deg):
    return deg * (PI / 180.0)
