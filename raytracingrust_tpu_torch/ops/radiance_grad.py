"""Radiance gradient kernel: the backward of the forward megakernel, its
wrapper, its plain PyTorch version and the autograd Function around both.

Replaces the backward half of raytracingrust_tpu/ops/pallas_megakernel.py
(``_make_grad_kernel``, reached through ``run_grad`` in ``_radiance_cvjp``'s
``custom_vjp``).  Given per-ray cotangents ``cts`` (R, 3) it returns
``d(sum(cts * radiance)) / d(fparams)``, (20 + stride N,) float32, for the
rays 0 .. R - 1 (ray id = pixel * spp + sample), and under a sky map also
the gradient in the sky's (H, W, 3) texels: the JAX package takes that
from the VJP of its gather outside the kernel (``_env_finish``), here the
kernel adds it with atomics.  The CUDA kernel (csrc/radiance_grad.cu)
replays each ray and runs the hand-derived adjoint of csrc/radiance.cuh;
the plain version is autograd through :func:`megakernel.radiance_plain`.

Depth is capped at ``megakernel.MAX_DEPTH`` = 12, the kernel's tape
(``pallas_megakernel.UNROLL_MAX_DEPTH``, the JAX fit path's gate); deeper
chains raise ``ValueError``.  ``LAUNCHES`` counts kernel launches,
``EXT_LAUNCHES``, ``SKY_LAUNCHES`` and ``TRI_LAUNCHES`` again those of its
variants with mixes, volumes or the isotropic lobe, with a sky map, and
with triangles (whose t has a gradient in the ray; their material slots'
rows are entries of ``fparams``, their vertices get none).
:func:`radiance` is the per-ray radiance that autograd differentiates on
either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models import backgrounds as B
from . import megakernel as K

LAUNCHES = 0
EXT_LAUNCHES = 0
SKY_LAUNCHES = 0
TRI_LAUNCHES = 0


def radiance_grad_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                        key: tuple[int, int], cts: torch.Tensor, spp: int,
                        width: int, *, max_depth: int, bg_kind: int,
                        clay: bool, mix: bool = False, n_vol: int = 0,
                        iso: bool = False, n_tm: int = 0,
                        tri: Optional[torch.Tensor] = None,
                        sky: Optional[torch.Tensor] = None):
    """The gradient by autograd through the plain forward, on any device:
    dfparams, or (dfparams, dsky) with a sky map."""
    fp = fparams.detach().requires_grad_(True)
    sk = None if sky is None else sky.detach().requires_grad_(True)
    ray_ids, px, py = K.prep_rays(
        torch.arange(cts.shape[0] // spp, device=cts.device), spp, width)
    with torch.enable_grad():
        rad = K.radiance_plain(fp, kinds, key, ray_ids, px, py,
                               max_depth=max_depth, bg_kind=bg_kind,
                               clay=clay, mix=mix, n_vol=n_vol, iso=iso,
                               n_tm=n_tm, tri=tri, sky=sk)
        leaves = [fp] if sk is None else [fp, sk]
        grads = torch.autograd.grad(rad, leaves, cts, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    return grads[0] if sk is None else tuple(grads)


def radiance_grad_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                       key: tuple[int, int], cts: torch.Tensor, spp: int,
                       width: int, *, max_depth: int, bg_kind: int,
                       clay: bool, mix: bool = False, n_vol: int = 0,
                       iso: bool = False, n_tm: int = 0,
                       tri: Optional[torch.Tensor] = None,
                       sky: Optional[torch.Tensor] = None):
    """The gradient from the CUDA kernel; ``cts`` is (n_pixels * spp, 3).
    -> dfparams, or (dfparams, dsky) with a sky map."""
    global LAUNCHES, EXT_LAUNCHES, SKY_LAUNCHES, TRI_LAUNCHES
    from . import _build

    n = K.check_scene_inputs("radiance_grad_cuda", fparams, kinds, key, mix,
                             n_vol, n_tm)
    dev, k = fparams.device, fparams.shape[0]
    n_rays = cts.shape[0]
    K._check(cts, "cts", torch.float32, (n_rays, 3), dev)
    K.check_depth(max_depth)
    if not 0 < n_rays < 2 ** 31 or spp < 1 or width < 1 or n_rays % spp:
        raise ValueError(f"bad launch: n_rays={n_rays} spp={spp} "
                         f"width={width}")
    if (bg_kind == B.SKYMAP) != (sky is not None):
        raise ValueError("a sky map background (bg_kind SKYMAP) is looked "
                         "up in `sky`, and only then")
    sky_args = K.sky_args(sky, dev)
    tris = K.tri_args(tri, n_tm, dev)
    gsky = None if sky is None else torch.zeros_like(sky)
    blocks = K.max_blocks(dev)
    partials = torch.empty((blocks, k), dtype=torch.float32, device=dev)
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    flags = K.ext_flags(mix, n_vol, iso)
    lib = _build.load("radiance_grad")
    with torch.cuda.device(dev):
        err = lib.rtrt_radiance_grad(
            ctypes.c_void_p(fparams.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), n, key[0], key[1], n_rays,
            spp, width, max_depth, int(bg_kind), int(bool(clay)), *flags,
            *tris, *sky_args,
            ctypes.c_void_p(0 if gsky is None else gsky.data_ptr()),
            ctypes.c_void_p(cts.data_ptr()),
            ctypes.c_void_p(partials.data_ptr()), blocks,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_radiance_grad launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    LAUNCHES += 1
    EXT_LAUNCHES += flags[0]
    SKY_LAUNCHES += int(sky is not None)
    TRI_LAUNCHES += int(tri is not None)
    return out if gsky is None else (out, gsky)


class Radiance(torch.autograd.Function):
    """Per-ray radiance on the card, differentiable in ``fparams`` and a
    sky map's texels: forward by the forward megakernel, backward by the
    gradient kernel (the port of ``_radiance_cvjp``, with ``_env_finish``'s
    gather moved into both)."""

    @staticmethod
    def forward(ctx, fparams, kinds, tri, sky, key, n_pixels, spp, width,
                opts):
        K.check_depth(opts["max_depth"])
        ctx.save_for_backward(fparams, kinds, tri, sky)
        ctx.args = (key, spp, width, opts)
        return K.radiance_cuda(fparams, kinds, key, n_pixels * spp, spp,
                               width, tri=tri, sky=sky, **opts)

    @staticmethod
    def backward(ctx, grad):
        fparams, kinds, tri, sky = ctx.saved_tensors
        key, spp, width, opts = ctx.args
        g = radiance_grad_cuda(fparams, kinds, key, grad.contiguous(), spp,
                               width, tri=tri, sky=sky, **opts)
        dfp, dsky = (g, None) if sky is None else g
        return (dfp, None, None, dsky) + (None,) * 5


def radiance(fparams: torch.Tensor, kinds: torch.Tensor,
             key: tuple[int, int], n_pixels: int, spp: int, width: int, *,
             max_depth: int, bg_kind: int, clay: bool, mix: bool = False,
             n_vol: int = 0, iso: bool = False, n_tm: int = 0,
             tri: Optional[torch.Tensor] = None,
             sky: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3), differentiable in ``fparams``
    (and ``sky``) on both devices: on the card under autograd,
    :class:`Radiance`; otherwise :func:`megakernel.radiance` (the forward
    kernel, or the plain version, which autograd differentiates on the
    CPU)."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay, mix=mix,
                n_vol=n_vol, iso=iso, n_tm=n_tm)
    wants = fparams.requires_grad or (sky is not None and sky.requires_grad)
    if (fparams.device.type == "cuda" and wants
            and torch.is_grad_enabled()):
        return Radiance.apply(fparams, kinds, tri, sky, key, n_pixels, spp,
                              width, opts)
    return K.radiance(fparams, kinds, key, n_pixels, spp, width, tri=tri,
                      sky=sky, **opts)
