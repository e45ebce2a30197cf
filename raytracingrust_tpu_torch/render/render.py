"""Render entry points (raytracingrust_tpu/render/render.py): a full frame
of mean radiance, then gamma and 8-bit RGBA.

Per pixel, as the reference: jittered UV ``(x + U) / (w - 1)``, each sample
clamped to [0, clamp_indirect] before the mean, gamma 2 (the square root
of the mean) at the end, and a saturating 8-bit write.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scene import MODE_CLAY, Scene
from ..ops import bvh_kernel as BK
from ..ops import megakernel as K
from ..ops.radiance_grad import radiance
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


def select_engine(scene: Scene) -> str:
    """"brute" (kernel #1) for 1 to 128 spheres and no triangle, at any
    depth; else "bvh" (kernel #5) for a scene its gate admits; else
    NotImplementedError naming the ROADMAP item that ports the scene.

    The JAX package's ``select_engine`` also sends sphere chains deeper
    than its unroll limit to its BVH kernel; here they stay on #1, which
    runs any depth (ROADMAP A10)."""
    brute = K.unsupported(scene)
    if brute is None:
        return "brute"
    bvh = BK.unsupported_bvh(scene)
    if bvh is None:
        return "bvh"
    small = (0 < len(scene.spheres) <= K.MAX_SPHERES
             and len(scene.triangles) == 0)
    raise NotImplementedError(brute if small else bvh)


def requires_grad(scene: Scene) -> bool:
    """Whether autograd is on and a tensor leaf of the scene needs a
    gradient."""
    parts = (scene.camera, scene.background, scene.spheres, scene.materials,
             scene.triangles)
    return torch.is_grad_enabled() and any(
        v.requires_grad for p in parts for v in vars(p).values()
        if isinstance(v, torch.Tensor))


def pixel_radiance(scene: Scene, width: int, height: int,
                   key: tuple[int, int], device: torch.device) -> torch.Tensor:
    """(width * height, 3) mean radiance per pixel: each sample clamped to
    [0, clamp_indirect], then averaged over the pixel's samples.
    Differentiable in the scene's leaves on the brute path; the BVH path is
    forward only and refuses a scene with a leaf that requires grad."""
    s = scene.settings
    spp = s.samples_per_pixel
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == MODE_CLAY)
    if select_engine(scene) == "bvh":
        if requires_grad(scene):
            raise NotImplementedError(BK.NO_GRAD)
        rad = BK.radiance(BK.pack(scene, width, height, device), key,
                          width * height, spp, width, **opts)
    else:
        fparams = K.pack_fparams(scene, width, height).to(device)
        kinds = K.sphere_kinds(scene).to(device)
        rad = radiance(fparams, kinds, key, width * height, spp, width,
                       **opts)
    rad = K.clip_samples(rad, s.clamp_indirect)
    return rad.view(width * height, spp, 3).mean(dim=1)


def render_linear(scene: Scene, width: int, height: int, *, seed: int = 0,
                  key=None, device=None) -> torch.Tensor:
    """(H, W, 3) float32 mean radiance (clamped, before gamma) on ``device``,
    differentiable in the scene's leaves on the brute path.  ``key``, two
    cipher words as :func:`..utils.rng.base_key` gives them, overrides
    ``seed``.  A scene outside the port's envelope raises
    NotImplementedError naming the ROADMAP item that ports it."""
    key = rng.base_key(seed) if key is None else tuple(int(w) for w in key)
    mean = pixel_radiance(scene, width, height, key, resolve_device(device))
    return mean.view(height, width, 3)


def render(scene: Scene, width: int, height: int, *, seed: int = 0,
           device=None) -> np.ndarray:
    """(H, W, 4) uint8 RGBA, gamma-corrected."""
    mean = render_linear(scene, width, height, seed=seed, device=device)
    gamma = torch.sqrt(torch.clamp(mean, min=0.0))
    return color_mod.to_rgba8(gamma).cpu().numpy()
