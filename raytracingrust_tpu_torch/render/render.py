"""Render entry points (raytracingrust_tpu/render/render.py): a full frame
of mean radiance, then gamma and 8-bit RGBA.

Per pixel, as the reference: jittered UV ``(x + U) / (w - 1)``, each sample
clamped to [0, clamp_indirect] before the mean, gamma 2 (the square root
of the mean) at the end, and a saturating 8-bit write.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scene import Scene
from ..ops.megakernel import pixel_radiance
from ..utils import color as color_mod
from ..utils import rng


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card is an error,
    never a silent move to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and none is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch version on the CPU")
    return device


def render_linear(scene: Scene, width: int, height: int, *, seed: int = 0,
                  device=None) -> torch.Tensor:
    """(H, W, 3) float32 mean radiance (clamped, before gamma) on ``device``.
    A scene outside the port's envelope raises NotImplementedError naming
    the ROADMAP item that ports it."""
    mean = pixel_radiance(scene, width, height, rng.base_key(seed),
                          resolve_device(device))
    return mean.view(height, width, 3)


def render(scene: Scene, width: int, height: int, *, seed: int = 0,
           device=None) -> np.ndarray:
    """(H, W, 4) uint8 RGBA, gamma-corrected."""
    mean = render_linear(scene, width, height, seed=seed, device=device)
    gamma = torch.sqrt(torch.clamp(mean, min=0.0))
    return color_mod.to_rgba8(gamma).cpu().numpy()
