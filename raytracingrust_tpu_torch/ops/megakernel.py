"""Brute-force forward megakernel for sphere scenes: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the forward half of raytracingrust_tpu/ops/pallas_megakernel.py
(``_make_kernel`` over ``_radiance_math``, reached through
``pixel_radiance_pallas``).  Per ray: a jittered camera ray, then up to
``max_depth`` bounces of closest hit over every sphere (direct quadratic),
one material lobe and the throughput/radiance update; a miss adds the
background and ends the path.

Layouts are the JAX package's, so its own packed constants can be fed in:
``fparams`` is (20 + 12 N,) float32 — camera origin, horizontal, vertical,
lower-left (0..11), background colors a and b (12..17), 1/(width-1) and
1/(height-1) (18, 19), then per sphere cx cy cz r, albedo rgb, fuzz, ir,
emission rgb.  Sphere material kinds ride beside it as an int32 (N,) tensor,
a runtime input, so one kernel build serves every scene in the envelope.

The envelope (:func:`unsupported`): 1 to 128 solid spheres; Lambertian,
Metal, Dielectric and Emission materials; a uniform or gradient background;
Full or Clay mode; any depth.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models import backgrounds as B
from ..models import materials as M
from ..models.scene import MODE_CLAY, MODE_FULL, Scene
from ..utils.rng import ray_uniforms
from ..utils.types import T_MIN

MAX_SPHERES = 128
_CAM = 0
_BG = 12
_INV_W = 18
_INV_H = 19
_SPHERES = 20
_SPHERE_STRIDE = 12
# rays per step of the plain version: bounds its temporaries
TILE_RAYS = 1 << 22
# 2 * float32(pi), the float32 constant of the sphere sample's angle
_TWO_PI = float(np.float32(2.0) * np.float32(np.pi))

LAUNCHES = 0


# ------------------------------------------------------------- the envelope

def sphere_kinds(scene: Scene) -> torch.Tensor:
    """(N,) int32 material kind of each sphere."""
    return scene.materials.kind[scene.spheres.material.long()]


def unsupported(scene: Scene) -> str | None:
    """Why the scene lies outside the kernel's envelope, or None."""
    n = len(scene.spheres)
    if not 0 < n <= MAX_SPHERES:
        return (f"{n} spheres: the brute kernel takes 1 to {MAX_SPHERES}; "
                "larger scenes need the BVH path (ROADMAP A7)")
    if scene.spheres.num_volumes:
        return "constant-density volumes are not ported yet (ROADMAP A5)"
    if scene.materials.has_mix:
        return "mix materials are not ported yet (ROADMAP A5)"
    if bool((sphere_kinds(scene) == M.ISOTROPIC).any()):
        return "isotropic materials are not ported yet (ROADMAP A5)"
    if scene.background.kind not in (B.UNIFORM, B.GRADIENT):
        return "SkyMap backgrounds are not ported yet (ROADMAP A5)"
    if scene.settings.mode not in (MODE_FULL, MODE_CLAY):
        return (f"{scene.settings.mode} mode is not ported yet "
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

def pack_fparams(scene: Scene, width: int, height: int) -> torch.Tensor:
    """Scene constants -> (20 + 12 N,) float32 on the CPU, in the layout of
    ``pallas_megakernel._pack_fparams``."""
    origin, horizontal, vertical, lower_left = scene.camera.ray_origin()
    bg = scene.background
    head = torch.cat([
        origin, horizontal, vertical, lower_left, bg.color_a, bg.color_b,
        torch.tensor([1.0 / (width - 1), 1.0 / (height - 1)],
                     dtype=torch.float32),
    ])
    mats = scene.materials
    mid = scene.spheres.material.long()
    per_sphere = torch.cat([
        scene.spheres.center, scene.spheres.radius[:, None],
        mats.albedo[mid], mats.fuzz[mid][:, None], mats.ir[mid][:, None],
        mats.emission[mid],
    ], dim=1).reshape(-1)
    return torch.cat([head, per_sphere]).to(torch.float32)


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


def _radiance_tile(fp, kinds, key, ray_ids, px, py, max_depth, bg_kind,
                   clay):
    """One tile of :func:`radiance_plain`.  ``fp`` is the list of packed
    constants as Python floats (each an exact float32 value)."""
    n = kinds.shape[0]
    oxc, oyc, ozc = fp[_CAM:_CAM + 3]
    hx, hy, hz = fp[_CAM + 3:_CAM + 6]
    vx, vy, vz = fp[_CAM + 6:_CAM + 9]
    llx, lly, llz = fp[_CAM + 9:_CAM + 12]
    bg_a = fp[_BG:_BG + 3]
    bg_b = fp[_BG + 3:_BG + 6]
    dev = px.device
    tab = torch.tensor(fp[_SPHERES:_SPHERES + n * _SPHERE_STRIDE],
                       dtype=torch.float32, device=dev).view(n, _SPHERE_STRIDE)
    inv_r_tab = 1.0 / tab[:, 3]
    spheres = [fp[_SPHERES + i * _SPHERE_STRIDE:_SPHERES + i * _SPHERE_STRIDE
                  + 4] for i in range(n)]

    # camera ray from the pixel jitter (stream 0)
    j = ray_uniforms(key, ray_ids, 0, 2)
    s = (px + j[:, 0]) * fp[_INV_W]
    t = (py + j[:, 1]) * fp[_INV_H]
    dx = llx + s * hx - t * vx - oxc
    dy = lly + s * hy - t * vy - oyc
    dz = llz + s * hz - t * vz - ozc
    zero = torch.zeros_like(dx)
    one = torch.ones_like(dx)
    ox, oy, oz = zero + oxc, zero + oyc, zero + ozc
    thr = [one, one, one]
    rad = [zero, zero, zero]
    alive = torch.ones_like(dx, dtype=torch.bool)
    inf = torch.full_like(dx, float("inf"))

    for b in range(max_depth):
        if not bool(alive.any()):
            break  # dead rays never change: stopping early is exact
        u1, u2, u_coin = ray_uniforms(key, ray_ids, 1 + b, 3).unbind(-1)
        a = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a

        # closest hit; a tie keeps the lower sphere index
        t_best = inf
        best = torch.full_like(ray_ids, -1)
        for i, (cx, cy, cz, r) in enumerate(spheres):
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
            cq = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = half_b * half_b - a * cq
            ok = disc >= 0.0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t1 = (-half_b - sq) * inv_a
            t2 = (-half_b + sq) * inv_a
            t1ok = (t1 >= T_MIN) & (t1 <= t_best)
            t2ok = (t2 >= T_MIN) & (t2 <= t_best)
            ti = torch.where(t1ok, t1, torch.where(t2ok, t2, inf))
            better = ok & (ti < t_best)
            t_best = torch.where(better, ti, t_best)
            best = torch.where(better, i, best)
        hit = best >= 0
        idx = best.clamp(min=0).long()
        row = tab[idx]
        kind = kinds[idx]
        is_lam = kind == M.LAMBERTIAN
        is_met = kind == M.METAL
        is_die = kind == M.DIELECTRIC
        is_emi = kind == M.EMISSION
        al = row[:, 4:7].unbind(-1)
        fuzz, ir = row[:, 7], row[:, 8]
        em = row[:, 9:12].unbind(-1)
        inv_r = inv_r_tab[idx]

        safe_t = torch.where(hit, t_best, 1.0)
        ptx = ox + safe_t * dx
        pty = oy + safe_t * dy
        ptz = oz + safe_t * dz
        nx = (ptx - row[:, 0]) * inv_r
        ny = (pty - row[:, 1]) * inv_r
        nz = (ptz - row[:, 2]) * inv_r

        # background on a miss
        missed = alive & ~hit
        if bg_kind == B.UNIFORM:
            bg = bg_a
            rad = [rad[c] + torch.where(missed, thr[c] * bg[c], 0.0)
                   for c in range(3)]
        else:
            norm = 1.0 / torch.sqrt(_dot3(dx, dy, dz, dx, dy, dz))
            tt = 0.5 * (dy * norm + 1.0)
            rad = [rad[c] + torch.where(
                missed, thr[c] * ((1.0 - tt) * bg_a[c] + tt * bg_b[c]), 0.0)
                for c in range(3)]

        front = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
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
            # the lobe where-chain of _radiance_math: each lane keeps the
            # lobe of its winner's kind
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
            m_ok = _dot3(*md, nx, ny, nz) > 0.0
            at = [torch.where(is_met, torch.where(m_ok, al[c], 0.0), at[c])
                  for c in range(3)]
            nd = [torch.where(is_met, md[c], nd[c]) for c in range(3)]
            scatters = ~is_met | m_ok

            ratio = torch.where(front, 1.0 / ir, ir)
            inv_len = 1.0 / torch.sqrt(torch.clamp(a, min=1e-30))
            udx, udy, udz = dx * inv_len, dy * inv_len, dz * inv_len
            cos_t = torch.clamp(-_dot3(nx, ny, nz, udx, udy, udz), max=1.0)
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            omc = 1.0 - cos_t
            omc2 = omc * omc
            schl = r0 + (1.0 - r0) * omc2 * omc2 * omc
            refl = (ratio * sin_t > 1.0) | (schl > u_coin)
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

        terminal = alive & hit & ~scatters
        rad = [rad[c] + torch.where(terminal, thr[c] * at[c], 0.0)
               for c in range(3)]
        cont = alive & hit & scatters
        thr = [torch.where(cont, thr[c] * at[c], thr[c]) for c in range(3)]
        ox = torch.where(cont, ptx, ox)
        oy = torch.where(cont, pty, oy)
        oz = torch.where(cont, ptz, oz)
        dx = torch.where(cont, nd[0], dx)
        dy = torch.where(cont, nd[1], dy)
        dz = torch.where(cont, nd[2], dz)
        alive = cont
    return torch.stack(rad, dim=-1)


def radiance_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                   key: tuple[int, int], ray_ids: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor, *, max_depth: int,
                   bg_kind: int, clay: bool) -> torch.Tensor:
    """Per-ray radiance (R, 3) float32, in tensor ops on any device.

    Mirrors ``_radiance_math``'s op order (not the XLA integrator's): the
    direct quadratic with ``inv_a = 1/a``, ``<=``/``<`` tie rules, the
    normal as ``(p - c) * (1/r)``, the [u1, u2, coin] bounce stream and the
    lobe where-chain.  Where the JAX kernel calls ``rsqrt`` this computes
    ``1 / sqrt``, as the CUDA kernel does.  Frames larger than
    ``TILE_RAYS`` run tile by tile."""
    fp = fparams.tolist()
    kinds = kinds.to(px.device)
    return torch.cat([
        _radiance_tile(fp, kinds, key, ray_ids[i:i + TILE_RAYS],
                       px[i:i + TILE_RAYS], py[i:i + TILE_RAYS], max_depth,
                       bg_kind, clay)
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


def radiance_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                  key: tuple[int, int], n_rays: int, spp: int, width: int, *,
                  max_depth: int, bg_kind: int, clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_rays, 3) from the CUDA kernel for rays
    0 .. n_rays - 1, where ray id = pixel * spp + sample and pixels run
    row-major over ``width``."""
    global LAUNCHES
    from . import _build

    if fparams.device.type != "cuda":
        raise ValueError(f"radiance_cuda needs CUDA tensors, got "
                         f"{fparams.device}")
    n = kinds.shape[0]
    if not 0 < n <= MAX_SPHERES:
        raise ValueError(f"{n} spheres; the kernel takes 1 to {MAX_SPHERES}")
    _check(fparams, "fparams", torch.float32, (_SPHERES + n * _SPHERE_STRIDE,),
           fparams.device)
    _check(kinds, "kinds", torch.int32, (n,), fparams.device)
    _check_key(key)
    if not 0 <= n_rays < 2 ** 31 or spp < 1 or width < 1 or max_depth < 0:
        raise ValueError(f"bad launch: n_rays={n_rays} spp={spp} "
                         f"width={width} max_depth={max_depth}")
    out = torch.empty((n_rays, 3), dtype=torch.float32, device=fparams.device)
    if n_rays == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(fparams.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtrt_radiance(
            ctypes.c_void_p(fparams.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), n, key[0], key[1], n_rays,
            spp, width, max_depth, int(bg_kind), int(bool(clay)),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"rtrt_radiance launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
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
             max_depth: int, bg_kind: int, clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3) of pixels 0 .. n_pixels - 1:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay)
    if select_engine(fparams.device) == "cuda":
        return radiance_cuda(fparams, kinds, key, n_pixels * spp, spp, width,
                             **opts)
    ray_ids, px, py = prep_rays(torch.arange(n_pixels), spp, width)
    return radiance_plain(fparams, kinds, key, ray_ids, px, py, **opts)


def pixel_radiance(scene: Scene, width: int, height: int,
                   key: tuple[int, int], device: torch.device) -> torch.Tensor:
    """(width * height, 3) mean radiance per pixel: each sample clamped to
    [0, clamp_indirect], then averaged over the pixel's samples."""
    reason = unsupported(scene)
    if reason is not None:
        raise NotImplementedError(reason)
    s = scene.settings
    spp = s.samples_per_pixel
    fparams = pack_fparams(scene, width, height).to(device)
    kinds = sphere_kinds(scene).to(device)
    rad = radiance(fparams, kinds, key, width * height, spp, width,
                   max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                   clay=s.mode == MODE_CLAY)
    rad.clamp_(0.0, s.clamp_indirect)  # in place: rad is ours, and large
    return rad.view(width * height, spp, 3).mean(dim=1)
