"""Material shading (raytracingrust_tpu/ops/shade.py): mix resolution,
shared by every route, and the generic engine's branchless ``scatter``.

A MixMaterial picks its first child when the bounce's coin of its nesting
level is at least its factor, else its second (lib/materials.rs:149-156).
A hit's material id resolves in ``MAX_MIX_DEPTH`` masked lookup rounds, one
coin each, the bounce's uniform columns 0 .. 3; a non-mix row points at
itself, so a resolved id is a fixed point.  Kernel #5 (csrc/bvh_forward.cu)
runs the same rounds over the same table.

``scatter`` evaluates every lobe whose kind the table holds for every ray
and keeps each ray's own, as the JAX package's does (lib/materials.rs,
lib/volume.rs:75-88): Lambertian, the normal plus a unit-sphere sample
(the normal where that is near zero), always scatters; Metal, the
normalized reflection plus fuzz times the sample, absorbed below the
surface; Dielectric, Schlick against a coin or total internal reflection,
white; Emission, its colour, never scatters; Isotropic, a point of the
unit ball.  Its arithmetic is the JAX ``scatter``'s, op for op (not the
brute kernels' ``megakernel.bounce_tail``, which follows the Pallas
kernel's).
"""

from __future__ import annotations

import torch

from ..models import materials as M
from ..utils import rng, vec


def resolve_mix(mats: M.MaterialTable, mat_id: torch.Tensor,
                coins) -> torch.Tensor:
    """(R,) material ids -> (R,) leaf material ids.  ``coins``: the
    bounce's first ``MAX_MIX_DEPTH`` uniform columns, each (R,)."""
    mat_id = mat_id.long()
    for level in range(M.MAX_MIX_DEPTH):
        is_mix = mats.kind[mat_id] == M.MIX
        pick_first = coins[level] >= mats.mix_factor[mat_id]
        child = torch.where(pick_first, mats.mix_first[mat_id],
                            mats.mix_second[mat_id]).long()
        mat_id = torch.where(is_mix, child, mat_id)
    return mat_id


def mix_depth(mats: M.MaterialTable) -> int:
    """The deepest nesting of the table's mix DAG (0 without mixes);
    ``MAX_MIX_DEPTH + 1`` for a deeper chain or a cycle (the JAX
    ``_mix_depth``)."""
    kind = mats.kind.tolist()
    first, second = mats.mix_first.tolist(), mats.mix_second.tolist()

    def depth(m, hops):
        if kind[m] != M.MIX:
            return 0
        if hops > M.MAX_MIX_DEPTH:
            return M.MAX_MIX_DEPTH + 1
        return 1 + max(depth(first[m], hops + 1), depth(second[m], hops + 1))

    return max((depth(m, 0) for m in range(len(kind))), default=0)


def reachable_kinds(mats: M.MaterialTable, roots) -> set:
    """The leaf material kinds reachable from the material ids ``roots``
    through the mix DAG (the JAX ``_bvh_kinds``)."""
    kind = mats.kind.tolist()
    first, second = mats.mix_first.tolist(), mats.mix_second.tolist()
    out, seen, stack = set(), set(), torch.as_tensor(roots).unique().tolist()
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        if kind[m] == M.MIX:
            stack += [first[m], second[m]]
        else:
            out.add(kind[m])
    return out


def mix_uniforms(mats: M.MaterialTable) -> int:
    """Mix coins a bounce draws: MAX_MIX_DEPTH with mixes, else none."""
    return M.MAX_MIX_DEPTH if mats.has_mix else 0


def shade_uniforms(mats: M.MaterialTable) -> int:
    """Uniforms a bounce's mix resolution and lobe sampling draw: the mix
    coins, then (dir1, dir2, coin, radius)."""
    return mix_uniforms(mats) + 4


def kinds_present(mats: M.MaterialTable) -> set:
    """The leaf kinds of the table's rows (the JAX ``kinds_present``)."""
    return set(mats.kind.tolist()) - {M.MIX}


def schlick(cosine, idx):
    """Dielectric::reflectance (lib/materials.rs:103-108).  The fifth
    power is ``x * (x * x) ** 2``, as JAX's ``integer_pow`` expands it."""
    r0 = (1.0 - idx) / (1.0 + idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def scatter(mats: M.MaterialTable, mat_id, d_in, normal, front_face, u,
            clay: bool = False, forced: dict | None = None):
    """Every present lobe, then each ray's by its material's kind.

    ``mat_id`` (R,) resolved material ids; ``d_in`` (R, 3) the incoming
    direction (not normalized); ``normal`` (R, 3) front-face flipped;
    ``front_face`` (R,); ``u`` (R, >= shade_uniforms) the bounce's
    uniforms, whose 4 columns after the mix coins are (dir1, dir2, coin,
    radius); ``clay``: every hit shades as Lambertian(0.8 gray)
    (lib/core/render.rs:41); ``forced``: recorded decisions that replace
    the comparisons ({"metal_ok": (R,) bool, "dielectric_reflect": (R,)
    bool}).  -> (attenuation (R, 3), new direction (R, 3), scatters
    (R,))."""
    k = mix_uniforms(mats)
    u1, u2, u_coin, u_r = u[:, k], u[:, k + 1], u[:, k + 2], u[:, k + 3]
    sphere_dir = rng.unit_sphere_surface(u1, u2)  # one draw for every lobe

    def lambertian():
        lam_dir = normal + sphere_dir
        return torch.where(vec.near_zero(lam_dir)[:, None], normal, lam_dir)

    if clay:
        return (torch.full_like(normal, 0.8), lambertian(),
                torch.ones(mat_id.shape, dtype=torch.bool,
                           device=mat_id.device))

    present = kinds_present(mats)
    kind = mats.kind[mat_id]
    albedo = mats.albedo[mat_id]
    black = torch.zeros_like(albedo)
    true_ = torch.ones(kind.shape, dtype=torch.bool, device=kind.device)
    lobes = []  # (kind, attenuation, direction, scatters)

    if M.LAMBERTIAN in present:  # lib/materials.rs:31-42
        lobes.append((M.LAMBERTIAN, albedo, lambertian(), true_))
    if M.METAL in present:  # lib/materials.rs:58-70
        reflected = vec.normalize(vec.reflect(d_in, normal))
        metal_dir = reflected + mats.fuzz[mat_id][:, None] * sphere_dir
        metal_ok = vec.dot(metal_dir, normal) > 0.0
        if forced is not None and forced.get("metal_ok") is not None:
            metal_ok = forced["metal_ok"]
        lobes.append((M.METAL, torch.where(metal_ok[:, None], albedo, black),
                      metal_dir, metal_ok))
    if M.DIELECTRIC in present:  # lib/materials.rs:113-138
        ir = mats.ir[mat_id]
        ratio = torch.where(front_face, 1.0 / ir, ir)
        ud = vec.normalize(d_in)
        cos_theta = torch.clamp(vec.dot(normal, -ud), max=1.0)
        # sin_theta only feeds the total-internal-reflection test: detached,
        # so sqrt's infinite slope at normal incidence never enters autograd
        sin_theta = torch.sqrt(torch.clamp(
            1.0 - cos_theta * cos_theta, min=0.0)).detach()
        reflect = (ratio * sin_theta > 1.0) | (schlick(cos_theta, ratio)
                                               > u_coin)
        if forced is not None and forced.get("dielectric_reflect") is not None:
            reflect = forced["dielectric_reflect"]
        diel_dir = torch.where(reflect[:, None], vec.reflect(ud, normal),
                               vec.refract(ud, normal, ratio))
        lobes.append((M.DIELECTRIC, torch.ones_like(albedo), diel_dir, true_))
    if M.EMISSION in present:
        lobes.append((M.EMISSION, mats.emission[mat_id], normal,
                      torch.zeros_like(true_)))
    if M.ISOTROPIC in present:  # lib/volume.rs:75-88
        lobes.append((M.ISOTROPIC, albedo,
                      sphere_dir * rng.cbrt01(u_r)[:, None], true_))

    atten, new_dir, scatters = black, normal, true_
    for lk, at, nd, sc in reversed(lobes):  # the first match, as jnp.select
        sel = kind == lk
        atten = torch.where(sel[:, None], at, atten)
        new_dir = torch.where(sel[:, None], nd, new_dir)
        scatters = torch.where(sel, sc, scatters)
    return atten, new_dir, scatters
