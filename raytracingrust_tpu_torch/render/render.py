"""Render entry points (raytracingrust_tpu/render/render.py): a full frame
of mean radiance, then gamma and 8-bit RGBA.

Per pixel, as the reference: jittered UV ``(x + U) / (w - 1)``, each sample
clamped to [0, clamp_indirect] before the mean, gamma 2 (the square root
of the mean) at the end, and a saturating 8-bit write.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.backgrounds import SKYMAP
from ..models.scene import MODE_CLAY, Scene
from ..ops import bvh_kernel as BK
from ..ops import megakernel as K
from ..ops.bvh_kernel import env_is_active
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


def wants_grad(scene: Scene) -> bool:
    """Whether autograd is on and a tensor leaf of the scene requires
    grad: a render that a gradient will be asked of."""
    if not torch.is_grad_enabled():
        return False
    parts = (scene.camera, scene.background, scene.spheres, scene.materials,
             scene.triangles)
    return any(isinstance(v, torch.Tensor) and v.requires_grad
               for part in parts for v in vars(part).values())


def select_engine(scene: Scene, grad: bool = False) -> str:
    """"env" (the record walk of #5, the replay and kernel #8) for a scene
    that uses HDRI importance sampling and the BVH gate admits, at any
    primitive count; else "brute" (kernel #1) for what the JAX package's
    brute kernel takes: 0 to 128 spheres, constant-density sphere volumes
    among them, and up to 8,192 surface triangles when the scene was built
    without its BVH, at least one primitive, single-level mixes, isotropic
    materials, a uniform, gradient or sky-map background, at any depth (a
    sphere scene whether or not it was built with its BVH); else "bvh"
    (kernel #5) for a scene its gate admits, every scene with triangles
    built with its BVH among them; else NotImplementedError naming the
    ROADMAP item that ports the scene (without the BVH: more than 128
    spheres or 8,192 triangles, a mesh volume, nested mixes or a view, the
    XLA integrator, A6; more than 4 mesh volumes, or one under importance
    sampling: A6 too).

    ``grad``: a gradient will be asked of the render.  The brute path's
    gradient kernels record at most ``megakernel.MAX_DEPTH`` bounces a ray,
    so a deeper brute scene then takes "bvh" (the record walk and the
    replay, which have no depth cap) when it was built with its BVH, and
    raises naming ROADMAP A6 (the XLA integrator) when it was not: the JAX
    package's ``resolve_fit_engine`` sends such chains to its BVH kernel
    too.

    Where the routes differ from the JAX package's ``select_engine``: it
    also sends forward renders of sphere chains deeper than its unroll
    limit to its BVH kernel; here they stay on #1, which runs any depth.
    It renders importance-sampled scenes of up to 256 primitives with its
    XLA integrator, which the port lacks; here they take the env path too,
    and without their BVH they raise (ROADMAP A6, A10).  It renders a
    scene of more than 1,024 triangles built without its BVH with its XLA
    integrator (``TPU_MAX_BRUTE_TRIS``: its brute kernel's matmul chunks
    overflow the TPU's scoped memory); the port has no XLA integrator (A6)
    and keeps such a scene on #1 up to ``megakernel.MAX_TRIS``.  Its
    ``resolve_fit_engine`` never sends a triangle fit to the brute kernels
    (Mosaic crashes compiling their VJP) but to its XLA integrator without
    a BVH; here they take #3 and #4 up to depth 12, whose adjoint has no
    such limit.  It renders the Normal and Random views of a sky map with
    its XLA integrator; here #5 renders every view (of a scene without its
    BVH they raise naming ROADMAP A6).  A view has no gradient: with
    ``grad`` it raises ValueError."""
    if grad and scene.settings.mode in BK.VIEWS:
        raise ValueError(f"the {scene.settings.mode} view is an inspection "
                         "view, not a loss surface: it has no gradient (as "
                         "in the JAX package)")
    if env_is_active(scene):
        if scene.cbvh is None:
            raise NotImplementedError(
                "HDRI importance sampling without the scene's BVH needs the "
                "XLA integrator, not ported yet (ROADMAP A6): build the "
                "scene with with_bvh=True (or enable_bvh_tree)")
        why = BK.unsupported_bvh(scene)
        if why is not None:
            raise NotImplementedError(why)
        return "env"
    brute = K.unsupported(scene)
    deep = grad and scene.settings.max_ray_depth > K.MAX_DEPTH
    # triangles take the brute kernels only without the BVH (as in JAX)
    tri_bvh = len(scene.triangles) and scene.cbvh is not None
    if brute is None and not deep and not tri_bvh:
        return "brute"
    bvh = BK.unsupported_bvh(scene)
    if bvh is None:
        return "bvh"
    if brute is None:  # a deep chain for a gradient, without its BVH
        raise NotImplementedError(
            f"gradients of paths deeper than {K.MAX_DEPTH} bounces without "
            "the scene's BVH need the XLA integrator, not ported yet "
            "(ROADMAP A6): build the scene with with_bvh=True (or "
            "enable_bvh_tree)")
    raise NotImplementedError(bvh if scene.cbvh is not None
                              or scene.num_mesh_volumes else brute)


def resolve_engine(scene: Scene, engine=None, grad: bool = False) -> str:
    """``engine`` None: :func:`select_engine`'s route.  "brute" or "bvh":
    that route (the JAX ``engine="pallas"``/``"pallas_bvh"``), for
    measuring one route where the dispatch would take the other; a scene
    outside its gate raises ValueError."""
    if engine is None:
        return select_engine(scene, grad)
    if engine == "brute":
        why = K.unsupported(scene)
        if why is None and grad and scene.settings.max_ray_depth > K.MAX_DEPTH:
            why = f"the gradient kernels record at most {K.MAX_DEPTH} bounces"
    elif engine == "bvh":
        why = ("HDRI importance sampling takes the env path"
               if env_is_active(scene) else BK.unsupported_bvh(scene))
    else:
        raise ValueError(f"unknown engine {engine!r}: None, 'brute' or 'bvh'")
    if why is not None:
        raise ValueError(f"engine {engine!r} cannot take the scene: {why}")
    return engine


def pixel_radiance(scene: Scene, width: int, height: int,
                   key: tuple[int, int], device: torch.device,
                   engine=None) -> torch.Tensor:
    """(width * height, 3) mean radiance per pixel: each sample clamped to
    [0, clamp_indirect], then averaged over the pixel's samples.
    Differentiable in the scene's leaves on every path: the brute path's
    gradient kernel, the BVH path's record walk and replay, or the env
    path's replay (a sky map's texels too, on each of them); a view
    (Normal, Random) has no gradient.  ``engine`` as
    :func:`resolve_engine`."""
    s = scene.settings
    spp = s.samples_per_pixel
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == MODE_CLAY)
    engine = resolve_engine(scene, engine, grad=wants_grad(scene))
    sky = (scene.to(device).background
           if scene.background.kind == SKYMAP else None)
    if engine == "env":
        rad = BK.env_radiance(BK.pack(scene, width, height, device), sky,
                              key, width * height, spp, width,
                              max_depth=s.max_ray_depth)
    elif engine == "bvh":
        rad = BK.radiance(BK.pack(scene, width, height, device), key,
                          width * height, spp, width, sky=sky,
                          debug=BK.VIEWS.get(s.mode), **opts)
    else:
        fparams = K.pack_fparams(scene, width, height).to(device)
        kinds = K.brute_kinds(scene).to(device)
        tri, boxes = K.pack_tri(scene), K.pack_tri_boxes(scene)
        rad = radiance(fparams, kinds, key, width * height, spp, width,
                       tri=None if tri is None else tri.to(device),
                       tri_boxes=None if boxes is None else boxes.to(device),
                       sky=None if sky is None else sky.image,
                       **K.scene_opts(scene))
    rad = K.clip_samples(rad, s.clamp_indirect)
    return rad.view(width * height, spp, 3).mean(dim=1)


def render_linear(scene: Scene, width: int, height: int, *, seed: int = 0,
                  key=None, device=None, engine=None) -> torch.Tensor:
    """(H, W, 3) float32 mean radiance (clamped, before gamma) on ``device``,
    differentiable in the scene's leaves.  ``key``, two
    cipher words as :func:`..utils.rng.base_key` gives them, overrides
    ``seed``; ``engine`` as :func:`resolve_engine`.  A scene outside the
    port's envelope raises NotImplementedError naming the ROADMAP item
    that ports it."""
    key = rng.base_key(seed) if key is None else tuple(int(w) for w in key)
    mean = pixel_radiance(scene, width, height, key, resolve_device(device),
                          engine)
    return mean.view(height, width, 3)


def render(scene: Scene, width: int, height: int, *, seed: int = 0,
           device=None) -> np.ndarray:
    """(H, W, 4) uint8 RGBA, gamma-corrected."""
    mean = render_linear(scene, width, height, seed=seed, device=device)
    gamma = torch.sqrt(torch.clamp(mean, min=0.0))
    return color_mod.to_rgba8(gamma).cpu().numpy()
