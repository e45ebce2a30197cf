"""Differentiable rendering: which scene leaves train, and the fit's loss
(raytracingrust_tpu/diff/grad.py).

The render is differentiable in the scene's tensor leaves on both devices
(autograd through the plain version on the CPU; on the card the forward
megakernel with the gradient kernel as its backward; on the BVH path the
record walk with the replay over its recorded hits as its backward).  Gradients are the
reparameterized path gradients of the fixed-seed renderer with every
discrete event (winner, root, face, lobe choice) held fixed: they match
finite differences away from visibility and branch discontinuities;
silhouette terms are out of scope, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from ..models.scene import Scene
from ..ops.megakernel import brute_kinds, pack_fparams, pack_tri, scene_opts
from ..ops.mse_loss import mse_loss, supports_fused_mse
from ..render.render import render_linear, resolve_device, resolve_engine
from ..utils import rng

# Trainable leaf names -> (sub-object, field) paths
PARAM_PATHS = {
    "albedo": ("materials", "albedo"),
    "fuzz": ("materials", "fuzz"),
    "ir": ("materials", "ir"),
    "emission": ("materials", "emission"),
    "mix_factor": ("materials", "mix_factor"),
    "bg_color_a": ("background", "color_a"),
    "bg_color_b": ("background", "color_b"),
    "cam_lookfrom": ("camera", "lookfrom"),
    "cam_lookat": ("camera", "lookat"),
    "cam_up": ("camera", "vertical"),
    "cam_fov": ("camera", "vertical_fov"),
    "sphere_center": ("spheres", "center"),
    "sphere_radius": ("spheres", "radius"),
}


def extract_params(scene: Scene, names: Iterable[str]) -> dict:
    """Pull the selected trainable leaves out of a scene -> params dict."""
    out = {}
    for name in names:
        sub, field = PARAM_PATHS[name]
        out[name] = getattr(getattr(scene, sub), field)
    return out


def apply_params(scene: Scene, params: dict) -> Scene:
    """Swap trainable leaves back into the scene."""
    by_sub: dict[str, dict] = {}
    for name, value in params.items():
        sub, field = PARAM_PATHS[name]
        by_sub.setdefault(sub, {})[field] = value
    for sub, fields in by_sub.items():
        scene = dataclasses.replace(
            scene, **{sub: dataclasses.replace(getattr(scene, sub), **fields)}
        )
    return scene


def make_loss(scene: Scene, target, width: int, height: int, *,
              seed: int = 0, device=None, mesh=None, engine=None):
    """-> loss(params, key=None) = mean squared error against ``target``
    (H, W, 3) linear radiance, differentiable in every PARAM_PATHS leaf
    present in ``params``.  ``key`` (two cipher words, as
    :func:`..utils.rng.base_key` gives them) overrides ``seed``.

    When the scene passes :func:`..ops.mse_loss.supports_fused_mse` and the
    target is (H, W, 3), the loss is the fused render -> MSE -> gradient
    path: on the card one kernel launch gives the loss and its gradient.
    Otherwise, and for every scene that takes the BVH kernel, it is
    ``render_linear`` plus the mean in PyTorch: a brute scene under a sky
    map takes the forward kernel and, backward, the radiance gradient
    kernel (the JAX package's fused kernel excludes sky maps too).
    ``device`` and ``engine`` as in ``render_linear`` (None means cuda and
    the dispatch's route)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded fits are not ported yet (ROADMAP A9)")
    dev = resolve_device(device)
    scene = scene.to(dev)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)

    def scene_of(params):
        return apply_params(scene, {k: v.to(dev) for k, v in params.items()})

    def key_of(key):
        return rng.base_key(seed) if key is None else tuple(
            int(w) for w in key)

    if (resolve_engine(scene, engine, grad=True) == "brute"
            and supports_fused_mse(scene)
            and tuple(target.shape) == (height, width, 3)):
        s = scene.settings
        kinds = brute_kinds(scene)
        flat = target.reshape(-1, 3).contiguous()
        opts = scene_opts(scene)
        tri = pack_tri(scene)

        def loss(params: dict, key=None):
            return mse_loss(pack_fparams(scene_of(params), width, height),
                            kinds, key_of(key), flat, s.samples_per_pixel,
                            width, clamp=s.clamp_indirect, tri=tri, **opts)

        return loss

    def loss(params: dict, key=None):
        img = render_linear(scene_of(params), width, height,
                            key=key_of(key), device=dev, engine=engine)
        return torch.mean((img - target) ** 2)

    return loss


def render_and_grad(scene: Scene, target, names, width: int, height: int,
                    *, seed: int = 0, device=None, mesh=None, engine=None):
    """Convenience: (loss value, grads dict) for the selected params."""
    loss = make_loss(scene, target, width, height, seed=seed, device=device,
                     mesh=mesh, engine=engine)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              extract_params(scene.to(resolve_device(device)),
                             names).items()}
    value = loss(params)
    grads = torch.autograd.grad(value, list(params.values()),
                                allow_unused=True)
    return value.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(params.items(), grads)}
