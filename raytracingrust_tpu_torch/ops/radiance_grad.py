"""Radiance gradient kernel: the backward of the forward megakernel, its
wrapper, its plain PyTorch version and the autograd Function around both.

Replaces the backward half of raytracingrust_tpu/ops/pallas_megakernel.py
(``_make_grad_kernel``, reached through ``run_grad`` in ``_radiance_cvjp``'s
``custom_vjp``).  Given per-ray cotangents ``cts`` (R, 3) it returns
``d(sum(cts * radiance)) / d(fparams)``, (20 + 12 N,) float32, for the rays
0 .. R - 1 (ray id = pixel * spp + sample).  The CUDA kernel
(csrc/radiance_grad.cu) replays each ray and runs the hand-derived adjoint
of csrc/radiance.cuh; the plain version is autograd through
:func:`megakernel.radiance_plain`.

Depth is capped at ``megakernel.MAX_DEPTH`` = 12, the kernel's tape
(``pallas_megakernel.UNROLL_MAX_DEPTH``, the JAX fit path's gate); deeper
chains raise ``ValueError``.  ``LAUNCHES`` counts kernel launches.
:func:`radiance` is the per-ray radiance that autograd differentiates on
either device.
"""

from __future__ import annotations

import ctypes

import torch

from . import megakernel as K

LAUNCHES = 0


def radiance_grad_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                        key: tuple[int, int], cts: torch.Tensor, spp: int,
                        width: int, *, max_depth: int, bg_kind: int,
                        clay: bool) -> torch.Tensor:
    """The gradient by autograd through the plain forward, on any device."""
    fp = fparams.detach().requires_grad_(True)
    ray_ids, px, py = K.prep_rays(
        torch.arange(cts.shape[0] // spp, device=cts.device), spp, width)
    with torch.enable_grad():
        rad = K.radiance_plain(fp, kinds, key, ray_ids, px, py,
                               max_depth=max_depth, bg_kind=bg_kind,
                               clay=clay)
        (dfp,) = torch.autograd.grad(rad, fp, cts)
    return dfp


def radiance_grad_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                       key: tuple[int, int], cts: torch.Tensor, spp: int,
                       width: int, *, max_depth: int, bg_kind: int,
                       clay: bool) -> torch.Tensor:
    """The gradient from the CUDA kernel; ``cts`` is (n_pixels * spp, 3)."""
    global LAUNCHES
    from . import _build

    n = K.check_scene_inputs("radiance_grad_cuda", fparams, kinds, key)
    dev, k = fparams.device, fparams.shape[0]
    n_rays = cts.shape[0]
    K._check(cts, "cts", torch.float32, (n_rays, 3), dev)
    K.check_depth(max_depth)
    if not 0 < n_rays < 2 ** 31 or spp < 1 or width < 1 or n_rays % spp:
        raise ValueError(f"bad launch: n_rays={n_rays} spp={spp} "
                         f"width={width}")
    blocks = K.max_blocks(dev)
    partials = torch.empty((blocks, k), dtype=torch.float32, device=dev)
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    lib = _build.load("radiance_grad")
    with torch.cuda.device(dev):
        err = lib.rtrt_radiance_grad(
            ctypes.c_void_p(fparams.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), n, key[0], key[1], n_rays,
            spp, width, max_depth, int(bg_kind), int(bool(clay)),
            ctypes.c_void_p(cts.data_ptr()),
            ctypes.c_void_p(partials.data_ptr()), blocks,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_radiance_grad launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    LAUNCHES += 1
    return out


class Radiance(torch.autograd.Function):
    """Per-ray radiance on the card, differentiable in ``fparams``: forward
    by the forward megakernel, backward by the gradient kernel (the port of
    ``_radiance_cvjp``)."""

    @staticmethod
    def forward(ctx, fparams, kinds, key, n_pixels, spp, width, max_depth,
                bg_kind, clay):
        K.check_depth(max_depth)
        ctx.save_for_backward(fparams, kinds)
        ctx.args = (key, spp, width, max_depth, bg_kind, clay)
        return K.radiance_cuda(fparams, kinds, key, n_pixels * spp, spp,
                               width, max_depth=max_depth, bg_kind=bg_kind,
                               clay=clay)

    @staticmethod
    def backward(ctx, grad):
        fparams, kinds = ctx.saved_tensors
        key, spp, width, max_depth, bg_kind, clay = ctx.args
        dfp = radiance_grad_cuda(fparams, kinds, key, grad.contiguous(), spp,
                                 width, max_depth=max_depth, bg_kind=bg_kind,
                                 clay=clay)
        return (dfp,) + (None,) * 8


def radiance(fparams: torch.Tensor, kinds: torch.Tensor,
             key: tuple[int, int], n_pixels: int, spp: int, width: int, *,
             max_depth: int, bg_kind: int, clay: bool) -> torch.Tensor:
    """Per-ray radiance (n_pixels * spp, 3), differentiable in ``fparams``
    on both devices: on the card under autograd, :class:`Radiance`;
    otherwise :func:`megakernel.radiance` (the forward kernel, or the plain
    version, which autograd differentiates on the CPU)."""
    if (fparams.device.type == "cuda" and fparams.requires_grad
            and torch.is_grad_enabled()):
        return Radiance.apply(fparams, kinds, key, n_pixels, spp, width,
                              max_depth, bg_kind, clay)
    return K.radiance(fparams, kinds, key, n_pixels, spp, width,
                      max_depth=max_depth, bg_kind=bg_kind, clay=clay)
