"""Scalar conventions shared by the port (raytracingrust_tpu/utils/types.py).

Everything on the device is float32, as in the reference tracer.
"""

from __future__ import annotations

import math

PI = math.pi

# t-interval floor of the render loop (world.hit(ray, 0.00001, INFINITY))
T_MIN = 1e-5


def degrees_to_radians(deg):
    return deg * (PI / 180.0)
