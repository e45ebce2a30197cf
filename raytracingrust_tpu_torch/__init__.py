"""raytracingrust_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``raytracingrust_tpu`` (JAX on a TPU) to one NVIDIA H100.  It
reads the same scene JSON and draws the same Threefry random numbers.
It renders sphere scenes and fits their parameters: the radiance, its
gradient and the fit's fused loss come from CUDA kernels written by hand
for Hopper (``csrc/``), each with a plain PyTorch version beside it that
runs on the CPU.  The package imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from .models.backgrounds import Background
from .models.camera import Camera
from .models.materials import (Dielectric, Emission, Isotropic, Lambertian,
                               Metal, MixMaterial)
from .models.scene import (MODE_CLAY, MODE_FULL, RenderSettings, Scene,
                           SceneBuilder)
from .render.render import render, render_linear

__all__ = [
    "Background", "Camera", "Dielectric", "Emission", "Isotropic",
    "Lambertian", "Metal", "MixMaterial", "RenderSettings", "Scene",
    "SceneBuilder", "render", "render_linear",
    "MODE_FULL", "MODE_CLAY",
]
