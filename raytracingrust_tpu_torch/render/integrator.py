"""The generic engine's wavefront path tracer
(raytracingrust_tpu/render/integrator.py), eager PyTorch.

The reference's recursive ``trace_ray`` (lib/core/render.rs:32-59) becomes a
loop over bounces on a wavefront of rays:

    throughput *= attenuation        (the recursion's multiply chain)
    radiance   += throughput * L     (on a miss the background; on a
                                      terminal material its attenuation)
    depth cutoff -> contributes 0    (a ray alive after max_ray_depth
                                      bounces adds nothing more)

After each bounce only the rays that scatter go on: the wavefront is
compacted, and a ray's radiance is written to its row when its path ends.
Each ray's arithmetic is the JAX integrator's, op for op, whose masked
lanes compute the same values for the rays that go on.

Gradients are the reparameterized path gradients of the fixed-seed
renderer: sampled directions are smooth in the parameters for fixed
uniforms, and every discrete event (the winner, the lobe, a mask) is held
fixed, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..diff.replay import _env_miss, _env_nee
from ..models import materials as M
from ..models.backgrounds import SKYMAP
from ..models.scene import MODE_CLAY, MODE_NORMAL, MODE_RANDOM, Scene
from ..ops import shade as shade_ops
from ..ops.intersect import intersect_brute
from ..ops.traverse import intersect_bvh
from ..utils import rng, vec
from ..utils.types import T_MIN

# a ray's uniform streams: 0 the pixel jitter, 1 + b bounce b; the sky
# sampler's draws of bounce b lie past the bounces, so importance sampling
# on or off never moves the path's own draws
JITTER_STREAM = 0


def bounce_stream(b: int) -> int:
    return 1 + b


def nee_stream(b: int, max_depth: int) -> int:
    return 1 + max_depth + b


# At or below this many primitives the dense scan is used whatever
# enable_bvh_tree says (the JAX package's threshold: both routes give the
# same hits, tests/test_bvh.py).
BRUTE_FORCE_THRESHOLD = 256


def uses_flat_bvh(scene: Scene) -> bool:
    """Whether :func:`closest_hit` walks the flat BVH: ``enable_bvh_tree``,
    a flat BVH built, more than BRUTE_FORCE_THRESHOLD primitives and no
    mesh volume (whose crossings at any t only the dense scan finds)."""
    return (scene.settings.enable_bvh_tree and scene.bvh is not None
            and scene.num_primitives > BRUTE_FORCE_THRESHOLD
            and scene.num_mesh_volumes == 0)


def closest_hit(scene: Scene, o, d, u_vol):
    """The world hit (lib/core/render.rs:68-72): the flat BVH's walk or
    the dense scan, by :func:`uses_flat_bvh`."""
    if uses_flat_bvh(scene):
        return intersect_bvh(scene, o, d, u_vol, tmin=T_MIN)
    return intersect_brute(scene, o, d, u_vol, tmin=T_MIN)


def trace_paths(scene: Scene, o, d, key, ray_ids):
    """Trace a wavefront to its end -> per-ray radiance (R, 3).

    ``key``: the two cipher words (utils/rng.base_key); ``ray_ids``: (R,)
    global ray ids.  Together they define every uniform a ray draws.
    """
    settings = scene.settings
    mode = settings.mode
    mats = scene.materials
    # free-flight columns: the sphere volumes', then the mesh volumes'
    n_vol = scene.spheres.num_volumes + scene.num_mesh_volumes
    n_shade = shade_ops.shade_uniforms(mats)
    n_uniforms = n_shade + n_vol

    if mode in (MODE_NORMAL, MODE_RANDOM):
        # one intersection, no scatter chain (lib/core/render.rs:42-49)
        if settings.max_ray_depth <= 0:
            return torch.zeros_like(o)
        u = rng.ray_uniforms(key, ray_ids, bounce_stream(0), n_uniforms)
        hit = closest_hit(scene, o, d, u[:, n_shade:])
        bg = scene.background.sample(d)
        if mode == MODE_RANDOM:
            return torch.where(hit.hit[:, None], 0.0, bg)
        ncol = 0.5 * (vec.normalize(hit.normal) + 1.0)
        return torch.where(hit.hit[:, None], ncol, bg)

    clay = mode == MODE_CLAY
    # one-sample MIS toward an HDRI sky: at a diffuse hit one direction
    # drawn from the sky's luminance too, both estimates weighted by the
    # balance heuristic
    env_is = (settings.env_importance_sampling and not clay
              and scene.background.kind == SKYMAP)
    max_depth = settings.max_ray_depth
    sky = scene.background

    def occlude(p, d_l, ids, stream):
        un = rng.ray_uniforms(key, ids, stream, 2 + n_vol)
        return closest_hit(scene, p.T, d_l.T, un[:, 2:]).hit

    out = torch.zeros_like(o)
    at = torch.arange(o.shape[0], device=o.device)  # rays still tracing
    thr = torch.ones_like(o)
    rad = torch.zeros_like(o)
    mis_pdf = torch.zeros(o.shape[0], device=o.device)  # 0: no MIS weight
    for b in range(max_depth):
        if not at.numel():
            break
        ids = ray_ids[at]
        u = rng.ray_uniforms(key, ids, bounce_stream(b), n_uniforms)
        hit = closest_hit(scene, o, d, u[:, n_shade:])
        missed = ~hit.hit
        if env_is:
            rad = torch.stack(_env_miss(sky, d.unbind(-1), thr.unbind(-1),
                                        rad.unbind(-1), missed, mis_pdf), -1)
        else:
            rad = rad + torch.where(missed[:, None],
                                    thr * scene.background.sample(d), 0.0)

        coins = u[:, :shade_ops.mix_uniforms(mats)].unbind(-1)
        mat_id = (shade_ops.resolve_mix(mats, hit.material, coins)
                  if mats.has_mix else hit.material)
        atten, new_dir, scatters = shade_ops.scatter(
            mats, mat_id, d, hit.normal, hit.front_face, u[:, :n_shade],
            clay=clay)
        terminal = hit.hit & ~scatters
        rad = rad + torch.where(terminal[:, None], thr * atten, 0.0)
        cont = hit.hit & scatters
        if env_is:
            diffuse = cont & (mats.kind[mat_id] == M.LAMBERTIAN)
            rad, mis_pdf = _env_nee(
                sky, occlude, key, ids, b, max_depth, thr.unbind(-1),
                rad.unbind(-1), diffuse, hit.point.unbind(-1),
                hit.normal.unbind(-1), mats.albedo[mat_id].unbind(-1),
                new_dir.unbind(-1))
            rad = torch.stack(rad, -1)
        # a path that ends keeps its radiance; the others go on
        done = (~cont).nonzero().squeeze(1)
        out = out.index_put((at[done],), rad[done])
        keep = cont.nonzero().squeeze(1)
        at, o, d = at[keep], hit.point[keep], new_dir[keep]
        thr, rad = (thr * atten)[keep], rad[keep]
        mis_pdf = mis_pdf[keep].detach()
    return out.index_put((at,), rad)
