"""Brute-force forward megakernel for scenes of spheres and triangles: the
CUDA kernel's wrapper and its plain PyTorch version.

Replaces the forward half of raytracingrust_tpu/ops/pallas_megakernel.py
(``_make_kernel`` over ``_radiance_math``, reached through
``pixel_radiance_pallas``).  Per ray: a jittered camera ray, then up to
``max_depth`` bounces of closest hit over every sphere (direct quadratic)
and every triangle (the bilinear form of ``_tri_intersect``), one material
lobe and the throughput/radiance update; a miss adds the background and
ends the path.

Layouts are the JAX package's (``_pack_fparams``), so its own packed
constants can be fed in: ``fparams`` is (20 + stride N,) float32 — camera
origin, horizontal, vertical, lower-left (0..11), background colors a and b
(12..17), 1/(width-1) and 1/(height-1) (18, 19), then per sphere cx cy cz
r, albedo rgb, fuzz, ir, emission rgb (stride 12).  A scene with mixes
packs leaf A of each sphere's material (``mix_first``) in those slots, then
the mix factor and leaf B (``mix_second``): stride 21, and a non-mix row
has A == B and factor 0.  A scene with volume spheres adds one slot, the
sphere's -1/density (0 for a solid sphere); volumes come last.  A scene
with triangles appends one row per material the triangles use (their
"slots", :func:`tri_slots`): leaf A, and with mixes the factor and leaf B
(stride 8 or 17).  Material kinds ride beside it as an int32 (N + M,)
tensor, each sphere's then each slot's (:func:`brute_kinds`), a runtime
input, so one kernel build serves every scene in the envelope: with mixes
kind A in bits 0-7 and kind B in bits 8-15.

The triangles' geometry is a (T, 20) float32 tensor of its own
(:func:`pack_tri`): the coefficients of ``pallas_megakernel._pack_tri``'s
C matrix in the port's layout (n = e1 x e2, v0 x e2, e2, v0 x e1, e1,
v0 . n), the flat face normal and the triangle's slot.  The determinant
and the numerators of u, v and t are sequential fused multiply-adds over
the ray's features [d, w = o x d, o, 1], as XLA's float32 dot computes the
TPU kernel's matmul on the CPU; the kernel uses ``__fmaf_rn``, the plain
version an exact emulation (:func:`_fma_chain`).

The bounce's uniform columns (stream 1 + b) are the JAX layout: with any
mix in the table the four mix coins first (``off = MAX_MIX_DEPTH``; a
single-level mix reads coin 0), then u1, u2, the coin and u_r at
``off + 0 .. 3``, then volume v's free-flight uniform at ``off + 4 + v``.

The envelope (:func:`unsupported`, the JAX ``supports``): 0 to 128
spheres, constant-density sphere volumes among them, and 0 to 8,192
surface triangles, at least one primitive; Lambertian, Metal,
Dielectric, Emission and Isotropic materials and single-level mixes of
them; a uniform, gradient or sky-map
background (the sky's nearest texel looked up in the kernel, as #5's
sky-map variant does); Full or Clay mode; any depth.  The kernels' new
branches (mixes, volumes, the isotropic lobe, the sky, triangles) sit
behind compile-time flags, so a scene of solid spheres runs the code it
ran before.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.  ``LAUNCHES`` counts kernel launches,
``EXT_LAUNCHES``, ``SKY_LAUNCHES`` and ``TRI_LAUNCHES`` again those of the
variants with mixes, volumes or the isotropic lobe, with a sky map, and
with triangles.  The
plain version is differentiable by autograd; on the card the gradient is a
kernel of its own (ops/radiance_grad.py, ops/mse_loss.py), whose limits
(``MAX_DEPTH``, the partial-sum blocks) sit here beside the input checks
that all kernels share.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..models import backgrounds as B
from ..models import materials as M
from ..models.scene import MODE_CLAY, MODE_FULL, Scene
from ..utils import vec
from ..utils.rng import cbrt01, ray_uniforms
from ..utils.types import T_MIN
from .shade import mix_depth

MAX_SPHERES = 128
MAX_TRIS = 8192  # pallas_megakernel.MAX_TRIS
# materials the triangles of one scene may use: rows of the gradient
# kernels' per-block sums in shared memory
MAX_TRI_MATS = 128
TRI_DET_EPS = 1e-8  # pallas_megakernel.TRI_DET_EPS
# the plain version's triangle test: triangles and rays of one step, which
# bound its (rays x triangles) temporaries (float64, 256 MB each)
TRI_BLOCK = 512
TRI_RAYS = 1 << 16
# columns of one triangle's row (pack_tri): the coefficients, the flat
# normal, the material slot
TRI_COLS = 20
_TN, _TU_D, _TU_W, _TV_D, _TV_W, _TV0N, _TNRM, _TSLOT = (0, 3, 6, 9, 12, 15,
                                                         16, 19)
_TRI_STRIDE = 8
_TRI_STRIDE_MIX = 17
_CAM = 0
_BG = 12
_INV_W = 18
_INV_H = 19
_SPHERES = 20
_SPHERE_STRIDE = 12
_SPHERE_STRIDE_MIX = 21
# offsets within one sphere's row: geometry and leaf A; with mixes the
# factor and leaf B (albedo rgb, fuzz, ir, emission rgb as leaf A)
_CENTER, _RADIUS, _ALBEDO, _FUZZ, _IR, _EMISSION = 0, 3, 4, 7, 8, 9
_FACTOR, _LEAF_B = 12, 13
_MAT = 8  # floats of one leaf's material
# rays per step of the plain version: bounds its temporaries
TILE_RAYS = 1 << 22
# 2 * float32(pi), the float32 constant of the sphere sample's angle
_TWO_PI = float(np.float32(2.0) * np.float32(np.pi))

# the gradient kernels' per-thread tape, in bounces
# (pallas_megakernel.UNROLL_MAX_DEPTH, the JAX fit path's depth gate)
MAX_DEPTH = 12
# gradient-kernel blocks per SM
BLOCKS_PER_SM = 8

LAUNCHES = 0
EXT_LAUNCHES = 0
SKY_LAUNCHES = 0
TRI_LAUNCHES = 0


def sphere_stride(mix: bool, n_vol: int) -> int:
    """Floats of one sphere's row (``pallas_megakernel._sphere_stride``)."""
    return (_SPHERE_STRIDE_MIX if mix else _SPHERE_STRIDE) + int(n_vol > 0)


def tri_stride(mix: bool) -> int:
    """Floats of one triangle material slot's row: leaf A, and with mixes
    the factor and leaf B."""
    return _TRI_STRIDE_MIX if mix else _TRI_STRIDE


# ------------------------------------------------------------- the envelope

def sphere_kinds(scene: Scene) -> torch.Tensor:
    """(N,) int32 material kind of each sphere; in a scene with mixes, kind
    A (of ``mix_first``) in bits 0-7 and kind B (``mix_second``) in bits
    8-15 (the JAX ``_sphere_kinds`` pairs)."""
    return _kinds_of(scene.materials, scene.spheres.material.long())


def tri_slots(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots, slot_of): the material ids the triangles use, ascending,
    and each triangle's index into them."""
    return torch.unique(scene.triangles.material.long(), return_inverse=True)


def _kinds_of(mats, mid: torch.Tensor) -> torch.Tensor:
    if not mats.has_mix:
        return mats.kind[mid]
    ka = mats.kind[mats.mix_first[mid].long()]
    kb = mats.kind[mats.mix_second[mid].long()]
    return (ka | (kb << 8)).to(torch.int32)


def brute_kinds(scene: Scene) -> torch.Tensor:
    """(N + M,) int32: :func:`sphere_kinds`, then each triangle material
    slot's kind (or kind pair) in the same form (the JAX ``_pack_tri``'s
    kind one-hot rows, ``_TS_LAM``.. and ``_T2_LAM``..)."""
    kinds = sphere_kinds(scene)
    if not len(scene.triangles):
        return kinds
    return torch.cat([kinds, _kinds_of(scene.materials,
                                       tri_slots(scene)[0])]).to(torch.int32)


def scene_opts(scene: Scene) -> dict:
    """The static options of the scene's brute path: depth, background
    kind, Clay mode, mixes, volume spheres, whether an isotropic material
    is shaded (which draws u_r, as the JAX kernel's ``iso`` over the sphere
    and triangle kinds) and the triangles' material slots."""
    s = scene.settings
    mix = scene.materials.has_mix
    kinds = brute_kinds(scene)
    iso = bool(((kinds & 0xFF) == M.ISOTROPIC).any()
               or (mix and ((kinds >> 8) == M.ISOTROPIC).any()))
    n_tm = kinds.shape[0] - len(scene.spheres)
    return dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == MODE_CLAY, mix=mix,
                n_vol=scene.spheres.num_volumes, iso=iso, n_tm=n_tm)


def unsupported(scene: Scene) -> str | None:
    """Why the scene lies outside the kernels' envelope, or None: the JAX
    ``supports``, and at most MAX_TRI_MATS materials on the triangles (the
    gradient kernels' shared rows; the JAX kernel has no such limit)."""
    n, n_tri = len(scene.spheres), len(scene.triangles)
    xla = ("; without its BVH the scene needs the XLA integrator, not "
           "ported yet (ROADMAP A6); built with it (with_bvh=True, or "
           "enable_bvh_tree) it takes the BVH kernel")
    if n > MAX_SPHERES:
        return (f"{n} spheres: the brute kernels take at most {MAX_SPHERES}"
                + xla)
    if n_tri > MAX_TRIS:
        return (f"{n_tri} triangles: the brute kernels take at most "
                f"{MAX_TRIS}" + xla)
    if n + n_tri == 0:
        return ("the scene has no primitive: the brute kernels take at "
                "least one (as the JAX package; its XLA integrator renders "
                "the background, not ported yet: ROADMAP A6)")
    if scene.num_mesh_volumes:
        return ("mesh volumes take the BVH kernel's crossing scan (the JAX "
                "brute kernel excludes them too): build the scene with its "
                "BVH")
    if n_tri and tri_slots(scene)[0].shape[0] > MAX_TRI_MATS:
        return (f"the triangles use more than {MAX_TRI_MATS} materials: the "
                "brute kernels keep their gradient rows in shared memory"
                + xla)
    if scene.materials.has_mix and mix_depth(scene.materials) > 1:
        return ("mixes nested more than one level deep: the brute kernels "
                "shade single-level mixes (as the JAX package); a scene "
                "built with its BVH takes the BVH kernel's resolution "
                "chain, one without it needs the XLA integrator, not ported "
                "yet (ROADMAP A6)")
    if (scene.settings.env_importance_sampling
            and scene.background.kind == B.SKYMAP
            and scene.settings.mode == MODE_FULL):
        return ("HDRI importance sampling: the brute kernels look a miss up "
                "in the sky only (as the JAX package); the env path takes "
                "the scene with its BVH, without it the XLA integrator, not "
                "ported yet (ROADMAP A6)")
    if scene.settings.mode not in (MODE_FULL, MODE_CLAY):
        return (f"the {scene.settings.mode} view is not a brute-kernel mode "
                "(as in the JAX package): the BVH kernel renders it with the "
                "scene's BVH; without it the XLA integrator, not ported yet "
                "(ROADMAP A6)")
    return None


def supports(scene: Scene) -> bool:
    return unsupported(scene) is None


def select_engine(device: torch.device) -> str:
    """"cuda" (the kernel) for a CUDA device, "torch" (its plain version)
    for the CPU."""
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "torch"
    raise ValueError(f"no radiance path for device {device}")


# ------------------------------------------------------------- host prep

def pack_head(scene: Scene, width: int, height: int) -> torch.Tensor:
    """The (20,) float32 head of the packed constants: camera origin,
    horizontal, vertical, lower-left, background colors a and b,
    1/(width-1) and 1/(height-1)."""
    origin, horizontal, vertical, lower_left = scene.camera.ray_origin()
    bg = scene.background
    return torch.cat([
        origin, horizontal, vertical, lower_left, bg.color_a, bg.color_b,
        torch.tensor([1.0 / (width - 1), 1.0 / (height - 1)],
                     dtype=torch.float32, device=origin.device),
    ])


def pack_fparams(scene: Scene, width: int, height: int) -> torch.Tensor:
    """Scene constants -> (20 + stride N + tri_stride M,) float32 on the
    scene's device: the layout of ``pallas_megakernel._pack_fparams(mix=
    has_mix)``, then a row for each triangle material slot (the material
    rows of ``_pack_tri``'s S and S2 matrices, one per material instead of
    one per triangle).  Plain tensor ops, so autograd folds each slot's
    cotangent back onto the scene leaf it was read from (a mix row's leaves
    onto their material rows, its factor onto ``mix_factor``)."""
    head = pack_head(scene, width, height)
    mats = scene.materials
    sph = scene.spheres
    mid = sph.material.long()

    def leaf(m):
        return [mats.albedo[m], mats.fuzz[m][:, None], mats.ir[m][:, None],
                mats.emission[m]]

    mix = mats.has_mix
    cols = [sph.center, sph.radius[:, None],
            *leaf(mats.mix_first[mid].long() if mix else mid)]
    if mix:
        cols += [mats.mix_factor[mid][:, None],
                 *leaf(mats.mix_second[mid].long())]
    if sph.num_volumes:
        cols.append(sph.neg_inv_density[:, None])
    parts = [head, torch.cat(cols, dim=1).reshape(-1)]
    if len(scene.triangles):
        slots = tri_slots(scene)[0].to(mid.device)
        cols = leaf(mats.mix_first[slots].long() if mix else slots)
        if mix:
            cols += [mats.mix_factor[slots][:, None],
                     *leaf(mats.mix_second[slots].long())]
        parts.append(torch.cat(cols, dim=1).reshape(-1))
    return torch.cat(parts).to(torch.float32)


def pack_tri(scene: Scene) -> Optional[torch.Tensor]:
    """The triangles' geometry -> (T, TRI_COLS) float32 on the scene's
    device, None without triangles: per triangle n = e1 x e2, v0 x e2, e2,
    v0 x e1, e1, v0 . n (the coefficients of ``_pack_tri``'s C matrix:
    a = -n . d, num_u = (v0 x e2) . d + e2 . w, num_v = -(v0 x e1) . d -
    e1 . w, num_t = n . o - v0 . n), the flat face normal (its S rows
    ``_TS_NRM``) and the triangle's material slot (:func:`tri_slots`)."""
    tris = scene.triangles
    if not len(tris):
        return None
    n = vec.cross(tris.e1, tris.e2)
    slot = tri_slots(scene)[1].to(n.device, torch.float32)
    return torch.cat([
        n, vec.cross(tris.v0, tris.e2), tris.e2, vec.cross(tris.v0, tris.e1),
        tris.e1, vec.dot(tris.v0, n)[:, None], tris.normal, slot[:, None],
    ], dim=1).to(torch.float32).contiguous()


def prep_rays(pixel_ids: torch.Tensor, spp: int, width: int):
    """(pixel, sample) fan-out -> flat (ray_ids int32, px, py float32).
    Ray ids are global: pixel * spp + sample."""
    pixel_ids = pixel_ids.to(torch.int32)
    samples = torch.arange(spp, dtype=torch.int32, device=pixel_ids.device)
    ray_ids = (pixel_ids[:, None] * spp + samples[None, :]).reshape(-1)
    pid = pixel_ids.repeat_interleave(spp)
    return ray_ids, (pid % width).to(torch.float32), \
        (pid // width).to(torch.float32)


# ------------------------------------------------------------- plain version

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def camera_ray(fp, key, ray_ids, px, py):
    """The jittered camera ray of each ray id (stream 0) -> (origin,
    direction), lists of three (R,) tensors.  ``fp`` holds the packed head
    (camera, background, pixel scale) at its first 20 entries."""
    oxc, oyc, ozc = fp[_CAM:_CAM + 3].unbind()
    hx, hy, hz = fp[_CAM + 3:_CAM + 6].unbind()
    vx, vy, vz = fp[_CAM + 6:_CAM + 9].unbind()
    llx, lly, llz = fp[_CAM + 9:_CAM + 12].unbind()
    j = ray_uniforms(key, ray_ids, 0, 2)
    s = (px + j[:, 0]) * fp[_INV_W]
    t = (py + j[:, 1]) * fp[_INV_H]
    dx = llx + s * hx - t * vx - oxc
    dy = lly + s * hy - t * vy - oyc
    dz = llz + s * hz - t * vz - ozc
    zero = torch.zeros_like(dx)
    return [zero + oxc, zero + oyc, zero + ozc], [dx, dy, dz]


def background(fp, bg_kind, d):
    """The uniform or gradient background's radiance along the directions
    ``d`` (three (R,) tensors), from the packed head ``fp``: three
    channels, 0-dim for a uniform one; None for a sky map, whose lookup is
    the caller's (:func:`sky_where`)."""
    bg_a = fp[_BG:_BG + 3].unbind()
    if bg_kind == B.UNIFORM:
        return list(bg_a)
    if bg_kind != B.GRADIENT:
        return None
    bg_b = fp[_BG + 3:_BG + 6].unbind()
    dx, dy, dz = d
    norm = 1.0 / torch.sqrt(_dot3(dx, dy, dz, dx, dy, dz))
    tt = 0.5 * (dy * norm + 1.0)
    return [(1.0 - tt) * bg_a[c] + tt * bg_b[c] for c in range(3)]


def sky_where(sky: B.Background, d, missed, tally=None):
    """(R, 3) the sky map's radiance along ``d`` where ``missed``, else 0:
    the lookup (``Background.sample``, the JAX ``_env_finish``) of the
    missed rays alone, differentiable in the texels.  ``tally`` receives
    the texels looked up, as a (H * W,) bool mask under "sky_texels"."""
    at = missed.nonzero().squeeze(1)
    bg = torch.zeros((missed.shape[0], 3), device=missed.device,
                     dtype=sky.image.dtype)
    if at.numel():
        dm = torch.stack([v[at] for v in d], dim=-1)
        bg = bg.index_put((at,), sky.sample(dm))
        if tally is not None:
            h, w = sky.image.shape[0], sky.image.shape[1]
            y, x = sky._texel(vec.to_spherical_coords(vec.normalize(dm)))
            seen = tally.get("sky_texels")
            if seen is None:
                seen = torch.zeros(h * w, dtype=torch.bool, device=dm.device)
            tally["sky_texels"] = seen.index_fill(0, y * w + x, True)
    return bg


def sky_map(image: torch.Tensor) -> B.Background:
    """A sky-map background around (H, W, 3) texels, for its lookup."""
    zero = image.new_zeros(3)
    return B.Background(B.SKYMAP, zero, zero, image)


def bounce_tail(fp, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n,
                mat, kind, u, forced=None, decisions=None):
    """The rest of a bounce once each ray's winner is known, shared by the
    brute and the BVH intersect stages (``_shade`` of ``_radiance_math``):
    the background on a miss, the front face, the lobe of the winner's kind
    (a where-chain: each ray keeps the lobe of its own kind) and the
    throughput/radiance update.

    ``o``, ``d``, ``thr``, ``rad``: the path state, lists of three (R,)
    tensors; ``alive`` the rays entering the bounce; ``a`` = d.d; ``hit``,
    the hit point ``pt`` and the outward normal ``n`` of the winner;
    ``mat`` its (albedo rgb, fuzz, ir, emission rgb) and ``kind`` its
    (resolved) material kind; ``u`` the bounce's [u1, u2, coin], and its
    fourth column u_r when the scene holds an isotropic material, whose
    lobe (lib/volume.rs:75-88) is the unit-ball sample: the sphere sample
    times ``cbrt01(u_r)``.  Rays that miss may hold any winner.
    -> (o, d, thr, rad, alive) entering the next bounce.

    The bounce's discrete decisions are the front face and, outside Clay
    mode, whether the metal lobe leaves above the surface and whether the
    dielectric reflects, each evaluated for every ray whatever its winner's
    kind.  ``forced``, a dict of bool tensors under the names "front",
    "metal_ok" and "reflect", replaces those comparisons (the replay over
    recorded hits, diff/replay.py); ``decisions``, a dict, receives their
    results under the same names (the BVH path's record walk).
    """
    dx, dy, dz = d
    nx, ny, nz = n
    al, fuzz, ir, em = mat[0:3], mat[3], mat[4], mat[5:8]
    u1, u2, u_coin = u[:3]
    zero = torch.zeros_like(a)

    # background on a miss (a sky map's is added by the caller:
    # sky_where)
    missed = alive & ~hit
    bg = background(fp, bg_kind, d)
    if bg is not None:
        rad = [rad[c] + torch.where(missed, thr[c] * bg[c], 0.0)
               for c in range(3)]

    front = (_dot3(dx, dy, dz, nx, ny, nz) < 0.0 if forced is None
             else forced["front"])
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    # unit-sphere-surface sample
    zs = 1.0 - 2.0 * u1
    rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    phi = _TWO_PI * u2
    sx = rs * torch.cos(phi)
    sy = rs * torch.sin(phi)
    sz = zs

    ldx, ldy, ldz = nx + sx, ny + sy, nz + sz
    deg = ((ldx.abs() < 1e-8) & (ldy.abs() < 1e-8)
           & (ldz.abs() < 1e-8))
    ldx = torch.where(deg, nx, ldx)
    ldy = torch.where(deg, ny, ldy)
    ldz = torch.where(deg, nz, ldz)

    if clay:
        at = [zero + 0.8] * 3
        nd = [ldx, ldy, ldz]
        scatters = torch.ones_like(alive)
    else:
        is_lam = kind == M.LAMBERTIAN
        is_met = kind == M.METAL
        is_die = kind == M.DIELECTRIC
        is_emi = kind == M.EMISSION
        at = [torch.where(is_lam, al[c], zero) for c in range(3)]
        nd = [torch.where(is_lam, ld, n_)
              for ld, n_ in ((ldx, nx), (ldy, ny), (ldz, nz))]

        dn = _dot3(dx, dy, dz, nx, ny, nz)
        rfx = dx - 2.0 * dn * nx
        rfy = dy - 2.0 * dn * ny
        rfz = dz - 2.0 * dn * nz
        inv_len = 1.0 / torch.sqrt(torch.clamp(
            _dot3(rfx, rfy, rfz, rfx, rfy, rfz), min=1e-30))
        md = [rfx * inv_len + fuzz * sx, rfy * inv_len + fuzz * sy,
              rfz * inv_len + fuzz * sz]
        m_ok = (_dot3(*md, nx, ny, nz) > 0.0 if forced is None
                else forced["metal_ok"])
        at = [torch.where(is_met, torch.where(m_ok, al[c], 0.0), at[c])
              for c in range(3)]
        nd = [torch.where(is_met, md[c], nd[c]) for c in range(3)]
        scatters = ~is_met | m_ok

        ratio = torch.where(front, 1.0 / ir, ir)
        inv_len = 1.0 / torch.sqrt(torch.clamp(a, min=1e-30))
        udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len
        cos_t = torch.clamp(-_dot3(nx, ny, nz, udx, udy, udz), max=1.0)
        if forced is None:
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            omc = 1.0 - cos_t
            omc2 = omc * omc
            schl = r0 + (1.0 - r0) * omc2 * omc2 * omc
            refl = (ratio * sin_t > 1.0) | (schl > u_coin)
        else:
            refl = forced["reflect"]
        udn = _dot3(udx, udy, udz, nx, ny, nz)
        rr = [udx - 2.0 * udn * nx, udy - 2.0 * udn * ny,
              udz - 2.0 * udn * nz]
        perp = [ratio * (udx + cos_t * nx), ratio * (udy + cos_t * ny),
                ratio * (udz + cos_t * nz)]
        par = -torch.sqrt(torch.clamp(
            (1.0 - _dot3(*perp, *perp)).abs(), min=1e-12))
        dd = [torch.where(refl, rr[c], perp[c] + par * n_)
              for c, n_ in enumerate((nx, ny, nz))]
        at = [torch.where(is_die, 1.0, at[c]) for c in range(3)]
        nd = [torch.where(is_die, dd[c], nd[c]) for c in range(3)]

        at = [torch.where(is_emi, em[c], at[c]) for c in range(3)]
        scatters = scatters & ~is_emi
        if len(u) > 3:  # the isotropic lobe: a point of the unit ball
            is_iso = kind == M.ISOTROPIC
            crt = cbrt01(u[3])
            at = [torch.where(is_iso, al[c], at[c]) for c in range(3)]
            nd = [torch.where(is_iso, sv * crt, nd[c])
                  for c, sv in enumerate((sx, sy, sz))]
        if decisions is not None:
            decisions.update(metal_ok=m_ok, reflect=refl)
    if decisions is not None:
        decisions["front"] = front

    terminal = alive & hit & ~scatters
    rad = [rad[c] + torch.where(terminal, thr[c] * at[c], 0.0)
           for c in range(3)]
    cont = alive & hit & scatters
    thr = [torch.where(cont, thr[c] * at[c], thr[c]) for c in range(3)]
    o = [torch.where(cont, pt[c], o[c]) for c in range(3)]
    d = [torch.where(cont, nd[c], d[c]) for c in range(3)]
    return o, d, thr, rad, cont


# the low 29 bits of a float64 that lies halfway between two float32s
_MID_MASK = (1 << 29) - 1
_MID = 1 << 28


def _fma_exact(c: torch.Tensor, x: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """float32 RN(c * x + acc), one rounding, of float64 ``c`` and ``x``
    holding float32 values (so c * x is exact) and float32 ``acc``: the sum
    rounded to odd in float64 (Knuth's two-sum gives its error), which then
    rounds to float32 as the exact sum would."""
    p = c * x
    a = acc.double()
    s = a + p
    bp = s - a
    err = (a - (s - bp)) + (p - bp)
    bits = s.view(torch.int64)
    away = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + away, bits)
    return bits.view(torch.float64).float()


class _Fma(torch.autograd.Function):
    """:func:`_fma_exact` under autograd: the gradient of c * x + acc."""

    @staticmethod
    def forward(ctx, c, x, acc):
        ctx.save_for_backward(c, x)
        return _fma_exact(c, x, acc)

    @staticmethod
    def backward(ctx, g):
        c, x = ctx.saved_tensors
        g64 = g.double()
        return g64 * x, g64 * c, g


def _fma_chain(terms, exact: bool = False):
    """XLA's float32 dot on the CPU, as it computes ``_tri_intersect``'s
    matmul: acc = RN(c * x + acc) over the (c, x) pairs in feature order,
    each step rounded once, from acc = RN(c0 x0).  ``terms`` holds float64
    tensors of float32 values, so each product is exact.  -> (float32
    result, bool mask of the entries that may be wrong by an ulp, or None):
    a step's float64 sum that lands halfway between two float32s may have
    rounded twice, and ``exact`` recomputes those."""
    (c, x), rest = terms[0], terms[1:]
    acc = (c * x).float()
    risky = None
    for c, x in rest:
        if exact:
            acc = _Fma.apply(c, x, acc)
            continue
        s = torch.addcmul(acc.double(), c, x)
        acc = s.float()
        mid = (s.view(torch.int64) & _MID_MASK) == _MID
        risky = mid if risky is None else risky | mid
    return acc, risky


def _fma_sum(terms) -> torch.Tensor:
    """:func:`_fma_chain`'s float32 result, exact: the entries whose float64
    sum may have rounded twice are computed again, exactly."""
    acc, risky = _fma_chain(terms)
    if risky is not None and bool(risky.any()):
        at = risky.nonzero(as_tuple=True)
        acc[at] = _fma_chain([(c.expand_as(acc)[at], x.expand_as(acc)[at])
                              for c, x in terms], exact=True)[0]
    return acc


def _features(o, d) -> list:
    """The rays' features [d, w = o x d, o] (three floats each) as float32
    rounds them."""
    ox, oy, oz = o
    dx, dy, dz = d
    return [dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
            ox * dy - oy * dx, ox, oy, oz]


@torch.no_grad()
def tri_closest(tri: torch.Tensor, o, d, bound=None):
    """Each ray's closest triangle below ``bound`` (R,) (None: inf) ->
    (t (R,) float32, ``bound`` where none is closer; index (R,) int64, -1
    where none is): ``_tri_intersect``'s test, a = -n . d, num_t, and for
    a t in (T_MIN, the best so far) num_u and num_v, each sum the fused
    multiply-adds of XLA's dot (:func:`_fma_sum`), with |a| >
    TRI_DET_EPS, u, v >= 0, u + v <= 1; the lowest t, and among equal t
    the lowest index (its chunk minimum and strict merge).  In steps of
    TRI_RAYS rays and TRI_BLOCK triangles."""
    feat = [v.detach().double() for v in _features(o, d)]
    n_rays, n_tri = feat[0].shape[0], tri.shape[0]
    t_best = (torch.full((n_rays,), float("inf"), device=tri.device)
              if bound is None else bound.detach().clone())
    best = torch.full((n_rays,), -1, dtype=torch.long, device=tri.device)
    cols = tri.detach().double().t()
    for r0 in range(0, n_rays, TRI_RAYS):
        rs = slice(r0, r0 + TRI_RAYS)
        f = [v[rs, None] for v in feat]
        for c0 in range(0, n_tri, TRI_BLOCK):
            g = cols[:, None, c0:c0 + TRI_BLOCK]
            a = _fma_sum([(-g[_TN + k], f[k]) for k in range(3)])
            nt = (_fma_sum([(g[_TN + k], f[6 + k]) for k in range(3)])
                  + (-g[_TV0N]).float())  # the feature 1: one rounding
            ok = a.abs() > TRI_DET_EPS
            inv = 1.0 / torch.where(ok, a, 1.0)
            t = inv * nt
            i, j = (ok & (t > T_MIN) & (t < t_best[rs, None])).nonzero(
                as_tuple=True)
            if not i.numel():
                continue
            # u and v of the pairs whose t would win
            gj, fi = g[:, 0, j], [v[i, 0] for v in f]
            nu = _fma_sum([(gj[_TU_D + k], fi[k]) for k in range(3)]
                          + [(gj[_TU_W + k], fi[3 + k]) for k in range(3)])
            nv = _fma_sum([(-gj[_TV_D + k], fi[k]) for k in range(3)]
                          + [(-gj[_TV_W + k], fi[3 + k]) for k in range(3)])
            u, v = inv[i, j] * nu, inv[i, j] * nv
            hit = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
            i, j, tt = i[hit], j[hit], t[i, j][hit]
            t_min = torch.full_like(t_best[rs], float("inf")).scatter_reduce(
                0, i, tt, "amin")
            first = torch.full_like(best[rs], TRI_BLOCK).scatter_reduce(
                0, i, torch.where(tt == t_min[i], j, TRI_BLOCK), "amin")
            better = t_min < t_best[rs]
            t_best[rs] = torch.where(better, t_min, t_best[rs])
            best[rs] = torch.where(better, first + c0, best[rs])
    return t_best, best


def tri_t(row: torch.Tensor, o, d) -> torch.Tensor:
    """t of each ray against the triangle of its ``row`` (its pack_tri
    row), as :func:`tri_closest` computes it and differentiable in ``o``
    and ``d`` (the VJP of ``_tri_intersect``'s matmul, through a and
    num_t; u and v are tests only)."""
    g = [row[:, k].double() for k in range(TRI_COLS)]
    feat = _features(o, d)
    d64 = [v.double() for v in feat[0:3]]
    o64 = [v.double() for v in feat[6:9]]
    a, _ = _fma_chain([(-g[_TN + k], d64[k]) for k in range(3)], exact=True)
    nt, _ = _fma_chain([(g[_TN + k], o64[k]) for k in range(3)], exact=True)
    nt = nt + (-g[_TV0N]).float()
    return 1.0 / torch.where(a.abs() > TRI_DET_EPS, a, 1.0) * nt


def _radiance_tile(fp, kinds, key, ray_ids, px, py, max_depth, bg_kind,
                   clay, mix, n_vol, iso, n_tm, tri, sky, observe=None):
    """One tile of :func:`radiance_plain`.  ``fp`` is the packed constants
    tensor on the rays' device; every constant is read by indexing it, so
    autograd reaches each packed entry."""
    n = kinds.shape[0] - n_tm
    stride = sphere_stride(mix, n_vol)
    n_solid = n - n_vol
    tab = fp[_SPHERES:_SPHERES + n * stride].view(n, stride)
    spheres = [tab[i, _CENTER:_RADIUS + 1].unbind() for i in range(n)]
    if not n:  # a row to index where no sphere won (radius 1: finite)
        tab = torch.cat([fp.new_zeros(_RADIUS), fp.new_ones(1),
                         fp.new_zeros(stride - _RADIUS - 1)])[None]
    inv_r_tab = 1.0 / tab[:, _RADIUS]
    kind_s = kinds[:n] if n else kinds.new_zeros(1)
    kind_a = kind_s & 0xFF if mix else kind_s
    kind_b = kind_s >> 8 if mix else kind_s
    if tri is not None:
        ts = tri_stride(mix)
        tmat = fp[_SPHERES + n * stride:].view(n_tm, ts)
        tkind = kinds[n:]
    # the bounce's uniform columns (pallas_megakernel's n_u)
    off = M.MAX_MIX_DEPTH if mix else 0
    n_u = off + ((4 if iso else 3) if n_vol == 0 else 4 + n_vol)
    n_lobe = 4 if iso else 3

    o, d = camera_ray(fp, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    inf = torch.full_like(one, float("inf"))

    for b in range(max_depth):
        if not bool(alive.any()):
            break  # dead rays never change: stopping early is exact
        us = ray_uniforms(key, ray_ids, 1 + b, n_u)
        u = us[:, off:off + n_lobe].unbind(-1)
        ox, oy, oz = o
        dx, dy, dz = d
        a = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a
        if n_vol:
            ray_len = torch.sqrt(a)
            windows = 0

        # closest hit; a tie keeps the lower sphere index
        t_best = inf
        best = torch.full_like(ray_ids, -1)
        for i, (cx, cy, cz, r) in enumerate(spheres):
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
            cq = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = half_b * half_b - a * cq
            ok = disc >= 0.0
            # sqrt(max(disc, 0)), whose gradient is 0 (not 0/0) at disc 0,
            # where the kernels' adjoint gives 0 too
            pos = disc > 0.0
            sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)),
                             0.0)
            t1 = (-half_b - sq) * inv_a
            t2 = (-half_b + sq) * inv_a
            if i >= n_solid:
                # a constant-density volume (lib/volume.rs:35-73): the
                # boundary window, then the free flight of its own column
                h1 = torch.clamp(t1, min=T_MIN)
                h2 = torch.where(t2 >= t1 + T_MIN, t2, inf)
                valid = ok & (h1 < h2)
                h1 = torch.clamp(h1, min=0.0)
                dist_inside = (h2 - h1) * ray_len
                hit_dist = tab[i, stride - 1] * torch.log(torch.clamp(
                    us[:, off + 4 + i - n_solid], min=1e-37))
                ti = h1 + hit_dist / ray_len
                ti = torch.where(valid & (hit_dist <= dist_inside), ti, inf)
                better = ti < t_best
                if observe is not None:
                    windows += int((alive & valid).sum())
            else:
                t1ok = (t1 >= T_MIN) & (t1 <= t_best)
                t2ok = (t2 >= T_MIN) & (t2 <= t_best)
                ti = torch.where(t1ok, t1, torch.where(t2ok, t2, inf))
                better = ok & (ti < t_best)
            t_best = torch.where(better, ti, t_best)
            best = torch.where(better, i, best)
        hit = best >= 0
        if tri is not None:
            # the closest triangle replaces the sphere winner only with a
            # strictly lower t; its t again, differentiable, for the winners
            tbest = tri_closest(tri, o, d, t_best)[1]
            tri_win = tbest >= 0
            trow = tri[tbest.clamp(min=0)]
            t_best = torch.where(tri_win, tri_t(trow, o, d), t_best)
            hit = hit | tri_win
        idx = best.clamp(min=0).long()
        row = tab[idx]
        inv_r = inv_r_tab[idx]

        safe_t = torch.where(hit, t_best, 1.0)
        pt = [ox + safe_t * dx, oy + safe_t * dy, oz + safe_t * dz]
        n_ = [(pt[c] - row[:, _CENTER + c]) * inv_r for c in range(3)]
        if n_vol:  # a volume's dummy normal (1, 0, 0) (lib/volume.rs:66-72)
            vol = best >= n_solid
            n_ = [torch.where(vol, float(c == 0), n_[c]) for c in range(3)]
        mat = row[:, _ALBEDO:_ALBEDO + _MAT]
        kind = kind_a[idx]
        if mix:
            fac = row[:, _FACTOR]
            mat_b = row[:, _LEAF_B:_LEAF_B + _MAT]
            kind_pb = kind_b[idx]
        if tri is not None:  # the flat normal and the slot's material
            slot = trow[:, _TSLOT].long()
            trm, tk = tmat[slot], tkind[slot]
            n_ = [torch.where(tri_win, trow[:, _TNRM + c], n_[c])
                  for c in range(3)]
            mat = torch.where(tri_win[:, None], trm[:, :_MAT], mat)
            kind = torch.where(tri_win, tk & 0xFF if mix else tk, kind)
            if mix:
                fac = torch.where(tri_win, trm[:, _MAT], fac)
                mat_b = torch.where(tri_win[:, None], trm[:, _MAT + 1:],
                                    mat_b)
                kind_pb = torch.where(tri_win, tk >> 8, kind_pb)
            if n_vol:
                vol = vol & ~tri_win
        if mix:  # the level-0 coin: u >= factor picks leaf A
            pick_a = us[:, 0] >= fac
            mat = torch.where(pick_a[:, None], mat, mat_b)
            kind = torch.where(pick_a, kind, kind_pb)
        seen = {} if observe is not None else None
        if sky is not None:  # an escaping ray adds the sky's texel
            missed = alive & ~hit
            bg = sky_where(sky, d, missed, seen)
            rad = [rad[c] + torch.where(missed, thr[c] * bg[:, c], 0.0)
                   for c in range(3)]
        if observe is not None:
            extra = {"texels": seen.get("sky_texels")} if sky else {}
            if n_vol:
                extra.update(windows=windows, vol=hit & vol)
            if tri is not None:
                extra.update(tri=hit & tri_win)
            observe(alive, hit, kind, **extra)
        o, d, thr, rad, alive = bounce_tail(
            fp, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n_,
            mat.unbind(-1), kind, u)
    return torch.stack(rad, dim=-1)


def radiance_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                   key: tuple[int, int], ray_ids: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor, *, max_depth: int,
                   bg_kind: int, clay: bool, mix: bool = False,
                   n_vol: int = 0, iso: bool = False, n_tm: int = 0,
                   tri: Optional[torch.Tensor] = None,
                   sky: Optional[torch.Tensor] = None,
                   observe=None) -> torch.Tensor:
    """Per-ray radiance (R, 3) float32, in tensor ops on any device, and
    differentiable in ``fparams`` (and ``sky``) by autograd.

    Mirrors ``_radiance_math``'s op order (not the XLA integrator's): the
    direct quadratic with ``inv_a = 1/a``, ``<=``/``<`` tie rules, the
    normal as ``(p - c) * (1/r)``, a volume's window and free flight, the
    triangles' bilinear test after the spheres (:func:`tri_closest`), the
    mix coin ``u >= factor``, the bounce stream's column layout and the
    lobe where-chain.  Where the JAX kernel calls ``rsqrt`` this computes
    ``1 / sqrt``, as the CUDA kernel does.  ``mix``, ``n_vol``, ``iso`` and
    ``n_tm`` as :func:`scene_opts` gives them; ``tri``, the triangles'
    rows (:func:`pack_tri`), with ``n_tm`` material slots at the end of
    ``fparams`` and ``kinds``; ``sky``, the (H, W, 3) texels of a SKYMAP
    background (``bg_kind`` SKYMAP), looked up where a ray escapes (the
    JAX ``_env_finish``).  Frames larger than ``TILE_RAYS`` run tile by
    tile.  A triangle's t has a gradient in the ray (through a and num_t);
    its vertices and its flat normal are constants here, as in the kernels.

    ``observe``, for measurement only, is called once per bounce traced
    with the rays' masks ``(alive, hit, kind)``: alive at the bounce's
    start, hit something, the winner's material kind (the picked leaf's);
    with volumes also ``windows=``, the volume windows the rays crossed
    (each draws its free flight), and ``vol=``, the rays whose winner is a
    volume; with triangles ``tri=``, the rays whose winner is a triangle;
    with a sky map ``texels=``, a (H * W,) bool mask of the texels the
    bounce's escaping rays looked up (None when none escaped)."""
    if (bg_kind == B.SKYMAP) != (sky is not None):
        raise ValueError("a sky map background (bg_kind SKYMAP) is looked "
                         "up in `sky`, and only then")
    if (tri is None) != (n_tm == 0):
        raise ValueError("triangles (`tri`) come with their material slots "
                         "(`n_tm`), and only then")
    fp = fparams.to(px.device)
    kinds = kinds.to(px.device)
    tri = None if tri is None else tri.to(px.device)
    bg = None if sky is None else sky_map(sky.to(px.device))
    opts = (max_depth, bg_kind, clay, mix, n_vol, iso, n_tm, tri, bg,
            observe)
    return torch.cat([
        _radiance_tile(fp, kinds, key, ray_ids[i:i + TILE_RAYS],
                       px[i:i + TILE_RAYS], py[i:i + TILE_RAYS], *opts)
        for i in range(0, ray_ids.shape[0], TILE_RAYS)
    ]) if ray_ids.shape[0] else torch.zeros((0, 3), device=px.device)


# ------------------------------------------------------------- the kernel

def _check_key(key: tuple[int, int]) -> None:
    if len(key) != 2 or not all(0 <= int(k) < 2 ** 32 for k in key):
        raise ValueError(f"key must be two words in [0, 2^32), got {key}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_depth(max_depth: int) -> None:
    """The gradient kernels record at most ``MAX_DEPTH`` bounces a ray."""
    if not 0 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"depth {max_depth}: the gradient kernels record at "
                         f"most {MAX_DEPTH} bounces a ray")


def max_blocks(device: torch.device) -> int:
    """Blocks of a gradient kernel's launch: each one's sums become one row
    of partials."""
    return (torch.cuda.get_device_properties(device).multi_processor_count
            * BLOCKS_PER_SM)


def check_scene_inputs(fn: str, fparams: torch.Tensor, kinds: torch.Tensor,
                       key: tuple[int, int], mix: bool = False,
                       n_vol: int = 0, n_tm: int = 0) -> int:
    """Check what every kernel of csrc/ takes (CUDA tensors, the packed
    constants and kinds of 0 to MAX_SPHERES spheres, of which the last
    ``n_vol`` are volumes, and of ``n_tm`` triangle material slots, at
    least one of either; a key); -> the sphere count."""
    if fparams.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {fparams.device}")
    n = kinds.shape[0] - n_tm
    if (not 0 <= n <= MAX_SPHERES or not 0 <= n_vol <= n
            or not 0 <= n_tm <= MAX_TRI_MATS or n + n_tm == 0):
        raise ValueError(f"{n} spheres ({n_vol} volumes) and {n_tm} "
                         f"triangle materials; the kernel takes 0 to "
                         f"{MAX_SPHERES} spheres and 0 to {MAX_TRI_MATS} "
                         "triangle materials, at least one of either")
    _check(fparams, "fparams", torch.float32,
           (_SPHERES + n * sphere_stride(mix, n_vol)
            + n_tm * tri_stride(mix),), fparams.device)
    _check(kinds, "kinds", torch.int32, (n + n_tm,), fparams.device)
    _check_key(key)
    return n


def sky_args(sky: Optional[torch.Tensor], device) -> list:
    """The texels' pointer, height and width of a sky map (null, 0, 0
    without one), checked."""
    if sky is None:
        return [ctypes.c_void_p(0), 0, 0]
    if sky.dim() != 3 or sky.shape[2] != 3:
        raise ValueError(f"sky has shape {tuple(sky.shape)}, expected "
                         "(H, W, 3)")
    _check(sky, "sky", torch.float32, tuple(sky.shape), device)
    return [ctypes.c_void_p(sky.data_ptr()), sky.shape[0], sky.shape[1]]


def tri_args(tri: Optional[torch.Tensor], n_tm: int, device) -> list:
    """The triangles' pointer and count and the material slots' count
    (null, 0, 0 without triangles), checked."""
    if (tri is None) != (n_tm == 0):
        raise ValueError("triangles (`tri`) come with their material slots "
                         "(`n_tm`), and only then")
    if tri is None:
        return [ctypes.c_void_p(0), 0, 0]
    n_tri = tri.shape[0]
    if not 0 < n_tri <= MAX_TRIS:
        raise ValueError(f"{n_tri} triangles; the kernel takes 1 to "
                         f"{MAX_TRIS}")
    _check(tri, "tri", torch.float32, (n_tri, TRI_COLS), device)
    return [ctypes.c_void_p(tri.data_ptr()), n_tri, n_tm]


def ext_flags(mix: bool, n_vol: int, iso: bool) -> list:
    """The kernels' run-time flags of a scene: its new branches (any of
    mixes, volumes, the isotropic lobe), mixes, volume spheres."""
    return [int(bool(mix or n_vol or iso)), int(bool(mix)), int(n_vol)]


def radiance_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                  key: tuple[int, int], n_rays: int, spp: int, width: int, *,
                  max_depth: int, bg_kind: int, clay: bool, mix: bool = False,
                  n_vol: int = 0, iso: bool = False, n_tm: int = 0,
                  tri: Optional[torch.Tensor] = None,
                  sky: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray radiance (n_rays, 3) from the CUDA kernel for rays
    0 .. n_rays - 1, where ray id = pixel * spp + sample and pixels run
    row-major over ``width``."""
    global LAUNCHES, EXT_LAUNCHES, SKY_LAUNCHES, TRI_LAUNCHES
    from . import _build

    n = check_scene_inputs("radiance_cuda", fparams, kinds, key, mix, n_vol,
                           n_tm)
    if not 0 <= n_rays < 2 ** 31 or spp < 1 or width < 1 or max_depth < 0:
        raise ValueError(f"bad launch: n_rays={n_rays} spp={spp} "
                         f"width={width} max_depth={max_depth}")
    if (bg_kind == B.SKYMAP) != (sky is not None):
        raise ValueError("a sky map background (bg_kind SKYMAP) is looked "
                         "up in `sky`, and only then")
    out = torch.empty((n_rays, 3), dtype=torch.float32, device=fparams.device)
    tris = tri_args(tri, n_tm, fparams.device)
    if n_rays == 0:
        return out
    flags = ext_flags(mix, n_vol, iso)
    lib = _build.load()
    with torch.cuda.device(fparams.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtrt_radiance(
            ctypes.c_void_p(fparams.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), n, key[0], key[1], n_rays,
            spp, width, max_depth, int(bg_kind), int(bool(clay)), *flags,
            *tris, *sky_args(sky, fparams.device),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"rtrt_radiance launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
    EXT_LAUNCHES += flags[0]
    SKY_LAUNCHES += int(sky is not None)
    TRI_LAUNCHES += int(tri is not None)
    return out


def uniforms_cuda(key: tuple[int, int], ray_ids: torch.Tensor, stream: int,
                  n: int) -> torch.Tensor:
    """The kernel's own cipher: (R, n) uniforms of one stream, for checking
    it bit for bit against :func:`..utils.rng.ray_uniforms` on the card."""
    from . import _build

    if ray_ids.device.type != "cuda":
        raise ValueError(f"uniforms_cuda needs a CUDA tensor, got "
                         f"{ray_ids.device}")
    if not 0 < n <= 512:
        raise ValueError(f"n = {n}: a stream holds 1 to 512 uniforms")
    _check(ray_ids, "ray_ids", torch.int32, (ray_ids.numel(),),
           ray_ids.device)
    _check_key(key)
    out = torch.empty((ray_ids.shape[0], n), dtype=torch.float32,
                      device=ray_ids.device)
    lib = _build.load()
    with torch.cuda.device(ray_ids.device):
        err = lib.rtrt_uniforms(
            ctypes.c_void_p(ray_ids.data_ptr()), ray_ids.shape[0], key[0],
            key[1], int(stream), n, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_uniforms launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    return out


# ------------------------------------------------------------- per pixel

def radiance(fparams: torch.Tensor, kinds: torch.Tensor,
             key: tuple[int, int], n_pixels: int, spp: int, width: int, *,
             max_depth: int, bg_kind: int, clay: bool, mix: bool = False,
             n_vol: int = 0, iso: bool = False, n_tm: int = 0,
             tri: Optional[torch.Tensor] = None,
             sky: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) of pixels 0 .. n_pixels - 1:
    the kernel for CUDA tensors, the plain version for CPU tensors (which
    autograd differentiates).  ops/radiance_grad.radiance adds the card's
    gradient."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay, mix=mix,
                n_vol=n_vol, iso=iso, n_tm=n_tm, tri=tri, sky=sky)
    if select_engine(fparams.device) == "cuda":
        return radiance_cuda(fparams, kinds, key, n_pixels * spp, spp, width,
                             **opts)
    ray_ids, px, py = prep_rays(torch.arange(n_pixels), spp, width)
    return radiance_plain(fparams, kinds, key, ray_ids, px, py, **opts)


def clip_samples(rad: torch.Tensor, clamp: float) -> torch.Tensor:
    """Each sample clipped to [0, clamp].  Under autograd the gradient is
    ``jnp.clip``'s: half of it at a sample exactly on a bound (which
    ``torch.clamp`` would pass whole).  Without it ``rad`` is clipped in
    place."""
    if rad.requires_grad:
        return torch.minimum(torch.maximum(rad, rad.new_zeros(())),
                             rad.new_full((), clamp))
    return rad.clamp_(0.0, clamp)  # in place: rad is ours, and large
