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

The envelope (:func:`unsupported`): 1 to 128 solid spheres and no
triangle; Lambertian, Metal, Dielectric and Emission materials; a uniform
or gradient background; Full or Clay mode; any depth.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.  ``LAUNCHES`` counts kernel launches.  The
plain version is differentiable by autograd; on the card the gradient is a
kernel of its own (ops/radiance_grad.py, ops/mse_loss.py), whose limits
(``MAX_DEPTH``, the partial-sum blocks) sit here beside the input checks
that all kernels share.
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
# offsets within one sphere's row
_CENTER, _RADIUS, _ALBEDO, _FUZZ, _IR, _EMISSION = 0, 3, 4, 7, 8, 9
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


# ------------------------------------------------------------- the envelope

def sphere_kinds(scene: Scene) -> torch.Tensor:
    """(N,) int32 material kind of each sphere."""
    return scene.materials.kind[scene.spheres.material.long()]


def unsupported(scene: Scene) -> str | None:
    """Why the scene lies outside the kernel's envelope, or None."""
    n = len(scene.spheres)
    if not 0 < n <= MAX_SPHERES:
        return (f"{n} spheres: the brute kernel takes 1 to {MAX_SPHERES}; "
                "larger scenes take the BVH kernel (ops/bvh_kernel.py)")
    if len(scene.triangles):
        return ("triangles in the brute kernel are not ported yet "
                "(ROADMAP A5); a scene built with its BVH takes the BVH "
                "kernel")
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
    """Scene constants -> (20 + 12 N,) float32 on the scene's device, in the
    layout of ``pallas_megakernel._pack_fparams``.  Differentiable in every
    scene leaf that requires grad."""
    head = pack_head(scene, width, height)
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
    material kind; ``u`` the bounce's [u1, u2, coin].  Rays that miss may
    hold any winner.  -> (o, d, thr, rad, alive) entering the next bounce.

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
    u1, u2, u_coin = u
    zero = torch.zeros_like(a)
    bg_a = fp[_BG:_BG + 3].unbind()
    bg_b = fp[_BG + 3:_BG + 6].unbind()

    # background on a miss
    missed = alive & ~hit
    if bg_kind == B.UNIFORM:
        rad = [rad[c] + torch.where(missed, thr[c] * bg_a[c], 0.0)
               for c in range(3)]
    else:
        norm = 1.0 / torch.sqrt(_dot3(dx, dy, dz, dx, dy, dz))
        tt = 0.5 * (dy * norm + 1.0)
        rad = [rad[c] + torch.where(
            missed, thr[c] * ((1.0 - tt) * bg_a[c] + tt * bg_b[c]), 0.0)
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


def _radiance_tile(fp, kinds, key, ray_ids, px, py, max_depth, bg_kind,
                   clay, observe=None):
    """One tile of :func:`radiance_plain`.  ``fp`` is the packed constants
    tensor on the rays' device; every constant is read by indexing it, so
    autograd reaches each packed entry."""
    n = kinds.shape[0]
    tab = fp[_SPHERES:_SPHERES + n * _SPHERE_STRIDE].view(n, _SPHERE_STRIDE)
    inv_r_tab = 1.0 / tab[:, _RADIUS]
    spheres = [tab[i, _CENTER:_RADIUS + 1].unbind() for i in range(n)]

    o, d = camera_ray(fp, key, ray_ids, px, py)
    one = torch.ones_like(d[0])
    thr = [one, one, one]
    rad = [torch.zeros_like(one)] * 3
    alive = torch.ones_like(one, dtype=torch.bool)
    inf = torch.full_like(one, float("inf"))

    for b in range(max_depth):
        if not bool(alive.any()):
            break  # dead rays never change: stopping early is exact
        u = ray_uniforms(key, ray_ids, 1 + b, 3).unbind(-1)
        ox, oy, oz = o
        dx, dy, dz = d
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
        inv_r = inv_r_tab[idx]

        safe_t = torch.where(hit, t_best, 1.0)
        pt = [ox + safe_t * dx, oy + safe_t * dy, oz + safe_t * dz]
        n_ = [(pt[c] - row[:, _CENTER + c]) * inv_r for c in range(3)]
        if observe is not None:
            observe(alive, hit, kind)
        o, d, thr, rad, alive = bounce_tail(
            fp, bg_kind, clay, o, d, thr, rad, alive, a, hit, pt, n_,
            row[:, _ALBEDO:_EMISSION + 3].unbind(-1), kind, u)
    return torch.stack(rad, dim=-1)


def radiance_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                   key: tuple[int, int], ray_ids: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor, *, max_depth: int,
                   bg_kind: int, clay: bool, observe=None) -> torch.Tensor:
    """Per-ray radiance (R, 3) float32, in tensor ops on any device, and
    differentiable in ``fparams`` by autograd.

    Mirrors ``_radiance_math``'s op order (not the XLA integrator's): the
    direct quadratic with ``inv_a = 1/a``, ``<=``/``<`` tie rules, the
    normal as ``(p - c) * (1/r)``, the [u1, u2, coin] bounce stream and the
    lobe where-chain.  Where the JAX kernel calls ``rsqrt`` this computes
    ``1 / sqrt``, as the CUDA kernel does.  Frames larger than
    ``TILE_RAYS`` run tile by tile.

    ``observe``, for measurement only, is called once per bounce traced
    with the rays' masks ``(alive, hit, kind)``: alive at the bounce's
    start, hit something, the winner's material kind."""
    fp = fparams.to(px.device)
    kinds = kinds.to(px.device)
    return torch.cat([
        _radiance_tile(fp, kinds, key, ray_ids[i:i + TILE_RAYS],
                       px[i:i + TILE_RAYS], py[i:i + TILE_RAYS], max_depth,
                       bg_kind, clay, observe)
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
                       key: tuple[int, int]) -> int:
    """Check what every kernel of csrc/ takes (CUDA tensors, the packed
    constants and kinds of 1 to MAX_SPHERES spheres, a key); -> the sphere
    count."""
    if fparams.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {fparams.device}")
    n = kinds.shape[0]
    if not 0 < n <= MAX_SPHERES:
        raise ValueError(f"{n} spheres; the kernel takes 1 to {MAX_SPHERES}")
    _check(fparams, "fparams", torch.float32, (_SPHERES + n * _SPHERE_STRIDE,),
           fparams.device)
    _check(kinds, "kinds", torch.int32, (n,), fparams.device)
    _check_key(key)
    return n


def radiance_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                  key: tuple[int, int], n_rays: int, spp: int, width: int, *,
                  max_depth: int, bg_kind: int, clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_rays, 3) from the CUDA kernel for rays
    0 .. n_rays - 1, where ray id = pixel * spp + sample and pixels run
    row-major over ``width``."""
    global LAUNCHES
    from . import _build

    n = check_scene_inputs("radiance_cuda", fparams, kinds, key)
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
    the kernel for CUDA tensors, the plain version for CPU tensors (which
    autograd differentiates).  ops/radiance_grad.radiance adds the card's
    gradient."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay)
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
