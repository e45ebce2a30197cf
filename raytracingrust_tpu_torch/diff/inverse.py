"""Inverse rendering: recover scene parameters from a target image
(raytracingrust_tpu/diff/inverse.py).

Adam (``torch.optim.Adam`` with optax.adam's defaults) over selected scene
parameters against the MSE loss of :func:`.grad.make_loss` in linear
radiance.  Each step draws its rays with a fresh seed (a stochastic
gradient over path samples).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..models.scene import Scene
from ..render.render import resolve_device
from ..utils import rng
from .grad import apply_params, extract_params, make_loss


def fit(
    scene: Scene,
    target,
    names: Iterable[str],
    width: int,
    height: int,
    *,
    steps: int = 100,
    learning_rate: float = 5e-2,
    seed: int = 0,
    resample_every: int = 1,
    device=None,
    callback: Callable | None = None,
    constraints: dict | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 25,
    mesh=None,
    sharded: bool = False,
):
    """Optimize ``names`` parameters of ``scene`` to match ``target``.

    Returns (optimized scene, final params, loss history).

    ``resample_every``: draw a fresh RNG seed for the loss every k steps
    (seed index = seed + step // k); 0 pins the seed for all steps.
    ``constraints``: optional {name: (lo, hi)} clamps applied in place
    after each step (e.g. albedo in [0, 1], fuzz >= 0).
    ``callback(step, loss, params)`` runs after each step.  ``device`` as
    in ``render_linear`` (None means cuda): on the card each step is one
    launch of the fused loss kernel plus the Adam update.
    Checkpoints (``checkpoint_path``/``checkpoint_every``, ROADMAP A10) and
    sharded fits (``mesh``/``sharded``, ROADMAP A9) are not ported yet:
    asking for either raises NotImplementedError.
    """
    if checkpoint_path is not None:
        raise NotImplementedError(
            "fit checkpoints are not ported yet (ROADMAP A10)")
    if mesh is not None or sharded:
        raise NotImplementedError(
            "sharded fits are not ported yet (ROADMAP A9)")
    dev = resolve_device(device)
    scene = scene.to(dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene, list(names)).items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    loss_fn = make_loss(scene, target, width, height, seed=seed, device=dev)

    history = []
    for i in range(steps):
        seed_idx = seed + (i // resample_every if resample_every else 0)
        opt.zero_grad(set_to_none=True)
        value = loss_fn(params, rng.base_key(seed_idx))
        value.backward()
        opt.step()
        if constraints:
            with torch.no_grad():
                for name, (lo, hi) in constraints.items():
                    if name in params:
                        params[name].clamp_(lo, hi)
        history.append(float(value.detach()))
        if callback is not None:
            callback(i, history[-1], params)

    params = {k: v.detach() for k, v in params.items()}
    return apply_params(scene, params), params, history
