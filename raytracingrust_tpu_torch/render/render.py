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
from ..models.scene import MODE_CLAY, MODE_FULL, Scene
from ..ops import bvh_kernel as BK
from ..ops import megakernel as K
from ..ops.bvh_kernel import env_is_active
from ..ops.radiance_grad import radiance
from ..utils import color as color_mod
from ..utils import rng
from .integrator import JITTER_STREAM, trace_paths, uses_flat_bvh

# rays a tile of the generic engine where the flat BVH's walk takes every
# hit: its per-ray state only, a few hundred bytes a ray
XLA_FLAT_TILE_RAYS = 1 << 22
# triangles up to which the JAX package renders a scene its brute kernel
# admits with that kernel (its TPU_MAX_BRUTE_TRIS)
JAX_BRUTE_TRIS = 1024


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


def default_tile_rays(scene: Scene) -> int:
    """Rays a tile of the generic engine's dense scan: as many as keep its
    (rays x primitives) matrices at 2^26 entries, clamped to [2^13, 2^20]
    (the JAX ``default_tile_rays``)."""
    n = max(scene.num_primitives, 1)
    return int(min(max((1 << 26) // n, 8192), 1 << 20))


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
    built with its BVH among them, and "brute" again for a render of what
    #5 refuses and #1 takes (the JAX package's brute fallback); else
    "xla", the generic engine (render/integrator.py, eager PyTorch), which
    takes every scene: without the BVH more than 128 spheres or 8,192
    triangles, a mesh volume, nested mixes, a view, importance sampling or
    a scene with no primitive; with it more than 8 sphere volumes or 4 mesh
    volumes, a mesh volume under importance sampling, or mixes nested
    deeper than 4 (a hit resolves 4 levels, as in the JAX package).

    One scene raises NotImplementedError: a render of up to JAX_BRUTE_TRIS
    triangles whose materials number more than ``megakernel.MAX_TRI_MATS``
    and that #1 would take but for them (and #5 does not take).  The JAX
    package renders it with its brute kernel, whose triangle materials have
    no cap; #1 keeps their rows in shared memory.  ``engine="xla"`` forces
    the generic engine on it, and its fit takes "xla" as in the JAX package.

    ``grad``: a gradient will be asked of the render.  The brute path's
    gradient kernels record at most ``megakernel.MAX_DEPTH`` bounces a ray,
    so a deeper brute scene then takes "bvh" (the record walk and the
    replay, which have no depth cap) when it was built with its BVH, and
    "xla" when it was not: the JAX package's ``resolve_fit_engine`` sends
    such chains to its BVH kernel too.

    Where the routes differ from the JAX package's ``select_engine``: it
    also sends forward renders of sphere chains deeper than its unroll
    limit to its BVH kernel; here they stay on #1, which runs any depth.
    It renders importance-sampled scenes of up to 256 primitives with its
    XLA integrator; here those built with their BVH take the env path too
    (ROADMAP A10's measured dispatch may choose).  It renders a scene of
    more than 1,024 triangles built without its BVH with its XLA
    integrator (``TPU_MAX_BRUTE_TRIS``: its brute kernel's matmul chunks
    overflow the TPU's scoped memory); the port keeps such a scene on #1
    up to ``megakernel.MAX_TRIS``.  Its ``resolve_fit_engine`` never sends
    a triangle fit to the brute kernels (Mosaic crashes compiling their
    VJP) but to its XLA integrator without a BVH; here they take #3 and #4
    up to depth 12, whose adjoint has no such limit.  It renders the Normal
    and Random views of a sky map with its XLA integrator; here #5 renders
    every view of a scene built with its BVH.  A view has no gradient:
    with ``grad`` it raises ValueError, and so does an unknown mode."""
    _check_mode(scene, grad)
    if env_is_active(scene):
        if scene.cbvh is None or BK.unsupported_bvh(scene) is not None:
            return "xla"
        return "env"
    brute = K.unsupported(scene)
    deep = grad and scene.settings.max_ray_depth > K.MAX_DEPTH
    # triangles take the brute kernels only without the BVH (as in JAX)
    tri_bvh = len(scene.triangles) and scene.cbvh is not None
    if brute is None and not deep and not tri_bvh:
        return "brute"
    if BK.unsupported_bvh(scene) is None:
        return "bvh"
    if not grad and K.unsupported(scene, tri_mats=False) is None:
        if brute is None:
            return "brute"
        if len(scene.triangles) <= JAX_BRUTE_TRIS:
            raise NotImplementedError(
                f"{brute}.  The JAX package renders this scene with its "
                "brute kernel, which has no limit on the triangles' "
                "materials, so the port does not send it to the generic "
                "engine by itself: build it with its BVH, or force "
                "engine=\"xla\" (ROADMAP A11: #1 to read such rows from "
                "global memory)")
    return "xla"


def _check_mode(scene: Scene, grad: bool) -> None:
    mode = scene.settings.mode
    if mode not in (MODE_FULL, MODE_CLAY, *BK.VIEWS):
        raise ValueError(f"unknown render mode {mode!r}")
    if grad and mode in BK.VIEWS:
        raise ValueError(f"the {mode} view is an inspection view, not a "
                         "loss surface: it has no gradient (as in the JAX "
                         "package)")


def resolve_engine(scene: Scene, engine=None, grad: bool = False) -> str:
    """``engine`` None: :func:`select_engine`'s route.  "brute", "bvh" or
    "xla": that route (the JAX ``engine="pallas"``/``"pallas_bvh"``/
    ``"xla"``), for measuring one route where the dispatch would take
    another; a scene outside the brute or BVH gate raises ValueError, and
    "xla" takes every scene."""
    if engine is None:
        return select_engine(scene, grad)
    if engine == "brute":
        why = K.unsupported(scene)
        if why is None and grad and scene.settings.max_ray_depth > K.MAX_DEPTH:
            why = f"the gradient kernels record at most {K.MAX_DEPTH} bounces"
    elif engine == "bvh":
        why = ("HDRI importance sampling takes the env path"
               if env_is_active(scene) else BK.unsupported_bvh(scene))
    elif engine == "xla":
        _check_mode(scene, grad)
        why = None
    else:
        raise ValueError(f"unknown engine {engine!r}: None, 'brute', 'bvh' "
                         "or 'xla'")
    if why is not None:
        raise ValueError(f"engine {engine!r} cannot take the scene: {why}")
    return engine


def sample_radiance(scene: Scene, pixel_ids: torch.Tensor, width: int,
                    height: int, key: tuple[int, int]) -> torch.Tensor:
    """The generic engine's clamped radiance of every sample of each pixel
    -> (P, spp, 3).  A ray's id is global (pixel * spp + sample), so
    tiling the pixels never changes a bit (the JAX ``sample_radiance``)."""
    spp = scene.settings.samples_per_pixel
    samples = torch.arange(spp, device=pixel_ids.device)
    ray_ids = (pixel_ids[:, None] * spp + samples[None, :]).reshape(-1)
    pid = pixel_ids.repeat_interleave(spp)
    x = (pid % width).to(torch.float32)
    y = (pid // width).to(torch.float32)
    jitter = rng.ray_uniforms(key, ray_ids, JITTER_STREAM, 2)
    # XLA divides by a constant as a product with its float32 reciprocal
    u = (x + jitter[:, 0]) * _recip(width - 1)
    v = (y + jitter[:, 1]) * _recip(height - 1)
    o, d = scene.camera.get_rays(u, v)
    rad = trace_paths(scene, o, d, key, ray_ids)
    rad = K.clip_samples(rad, scene.settings.clamp_indirect)
    return rad.view(pixel_ids.shape[0], spp, 3)


def _recip(n: int) -> float:
    """1 / n rounded to float32 once."""
    return float(np.float32(1.0) / np.float32(n))


def xla_tile_rays(scene: Scene) -> int:
    """Rays a tile of the generic engine: :func:`default_tile_rays` for the
    dense scan; XLA_FLAT_TILE_RAYS where the flat BVH's walk, which builds
    no (rays x primitives) matrix, takes every hit."""
    return XLA_FLAT_TILE_RAYS if uses_flat_bvh(scene) else \
        default_tile_rays(scene)


def xla_pixel_radiance(scene: Scene, pixel_ids: torch.Tensor, width: int,
                       height: int, key: tuple[int, int],
                       tile_rays=None) -> torch.Tensor:
    """(P, 3) mean clamped radiance of ``pixel_ids`` on the generic
    engine, in tiles of ``tile_rays`` rays (None: :func:`xla_tile_rays`),
    on the device the scene's tensors are on."""
    spp = scene.settings.samples_per_pixel
    tile = max(1, (tile_rays or xla_tile_rays(scene)) // max(spp, 1))
    return torch.cat([
        sample_radiance(scene, pixel_ids[p0:p0 + tile], width, height,
                        key).mean(dim=1)
        for p0 in range(0, pixel_ids.shape[0], tile)])


def pixel_radiance(scene: Scene, width: int, height: int,
                   key: tuple[int, int], device: torch.device,
                   engine=None) -> torch.Tensor:
    """(width * height, 3) mean radiance per pixel: each sample clamped to
    [0, clamp_indirect], then averaged over the pixel's samples.
    Differentiable in the scene's leaves on every path: the brute path's
    gradient kernel, the BVH path's record walk and replay, or the env
    path's replay (a sky map's texels too, on each of them), or the
    generic engine under autograd; a view (Normal, Random) has no
    gradient.  ``engine`` as :func:`resolve_engine`."""
    s = scene.settings
    spp = s.samples_per_pixel
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == MODE_CLAY)
    engine = resolve_engine(scene, engine, grad=wants_grad(scene))
    if engine == "xla":
        return xla_pixel_radiance(
            scene.to(device), torch.arange(width * height, device=device),
            width, height, key)
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
    ``seed``; ``engine`` as :func:`resolve_engine`."""
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
