"""Fused render -> MSE -> gradient kernel: the fit step's loss, its wrapper,
its plain PyTorch version and the autograd Function around both.

Replaces raytracingrust_tpu/ops/pallas_megakernel.py's fused loss
(``_make_mse_kernel`` through ``run_fused``, wrapped by ``_mse_cvjp`` and
``mse_loss_pallas``).  The loss of a frame is

    mean((clip(radiance, 0, clamp) averaged over spp  -  target) ** 2)

over pixels and channels, with ``target`` (H W, 3) a constant of the fit.
Under autograd on the card one launch of csrc/mse_loss.cu gives the loss
and ``d loss / d fparams``; the Function's forward returns the loss and
keeps the gradient, and its backward scales that by the incoming scalar.

The kernel runs one thread a sample: a pixel's spp samples (ray id =
pixel * spp + s) sit on consecutive lanes, an unpadded group of
min(spp, 128) lanes, whole pixels to a warp up to 32 samples and to a
block of 128 threads above that; past 128 samples a thread takes every
128th.  Each thread traces its sample once with the recording trace,
the group forms the pixel's mean in a fixed order (warp shuffles up to 32
samples, shared memory above), and each thread then runs the adjoint from
its own tape, one grid-stride iteration later: it holds two tapes, and
runs the last pixel's adjoint after this pixel's trace, so that no lane
idles while its warp waits for the mean.  The block's sums of the
gradient use shared atomics, as kernel #3's do, so their last bits vary
between runs; the loss's pixel means do not.  What bounds it: the FP32
work of one recording forward and one reverse sweep a sample and the
latency of their chains.
A call without grad runs the forward megakernel plus the same reduction in
PyTorch (the JAX ``mse`` primal).  The plain version is that reduction over
:func:`megakernel.radiance_plain`, differentiated by autograd.  The clip's
gradient follows ``jnp.clip``: half at a sample exactly on 0 or ``clamp``.

Gate: :func:`supports_fused_mse`.  ``LAUNCHES`` counts kernel launches,
``EXT_LAUNCHES`` and ``TRI_LAUNCHES`` again those of its variants with
mixes, volumes or the isotropic lobe, and with triangles.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models import backgrounds as B
from ..models.scene import Scene
from . import megakernel as K

LAUNCHES = 0
EXT_LAUNCHES = 0
TRI_LAUNCHES = 0


def supports_fused_mse(scene: Scene) -> bool:
    """The kernel's envelope without a sky map (the JAX
    ``supports_fused_mse``: its fused kernel cannot gather the sky), at
    depth <= megakernel.MAX_DEPTH; triangles included (the JAX fit
    dispatch sends triangle scenes elsewhere, render.select_engine says
    why the port does not)."""
    return (K.supports(scene) and scene.background.kind != B.SKYMAP
            and scene.settings.max_ray_depth <= K.MAX_DEPTH)


def reduce_mse(rad: torch.Tensor, target: torch.Tensor, spp: int,
               clamp: float) -> torch.Tensor:
    """The loss from per-ray radiance (H W spp, 3) and target (H W, 3)."""
    m = K.clip_samples(rad, clamp).view(-1, spp, 3).mean(dim=1)
    return ((m - target) ** 2).mean()


def mse_loss_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                   key: tuple[int, int], target: torch.Tensor, spp: int,
                   width: int, *, max_depth: int, bg_kind: int, clay: bool,
                   clamp: float, mix: bool = False, n_vol: int = 0,
                   iso: bool = False, n_tm: int = 0,
                   tri: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss in PyTorch ops on any device, differentiable by autograd."""
    ray_ids, px, py = K.prep_rays(
        torch.arange(target.shape[0], device=target.device), spp, width)
    rad = K.radiance_plain(fparams, kinds, key, ray_ids, px, py,
                           max_depth=max_depth, bg_kind=bg_kind, clay=clay,
                           mix=mix, n_vol=n_vol, iso=iso, n_tm=n_tm, tri=tri)
    return reduce_mse(rad, target, spp, clamp)


def mse_loss_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                  key: tuple[int, int], target: torch.Tensor, spp: int,
                  width: int, *, max_depth: int, bg_kind: int, clay: bool,
                  clamp: float, mix: bool = False, n_vol: int = 0,
                  iso: bool = False, n_tm: int = 0,
                  tri: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d fparams) from one launch of the fused kernel."""
    global LAUNCHES, EXT_LAUNCHES, TRI_LAUNCHES
    from . import _build

    n = K.check_scene_inputs("mse_loss_cuda", fparams, kinds, key, mix,
                             n_vol, n_tm)
    if bg_kind == B.SKYMAP:
        raise ValueError("the fused loss kernel takes no sky map (as the JAX "
                         "package's): its fit takes the forward and the "
                         "radiance gradient kernels")
    dev, k = fparams.device, fparams.shape[0]
    n_pixels = target.shape[0]
    K._check(target, "target", torch.float32, (n_pixels, 3), dev)
    K.check_depth(max_depth)
    if not 0 < n_pixels * spp < 2 ** 31 or spp < 1 or width < 1:
        raise ValueError(f"bad launch: n_pixels={n_pixels} spp={spp} "
                         f"width={width}")
    tris = K.tri_args(tri, n_tm, dev)
    blocks = K.max_blocks(dev)
    partials = torch.empty((blocks, k + 1), dtype=torch.float32, device=dev)
    out = torch.empty((k + 1,), dtype=torch.float32, device=dev)
    flags = K.ext_flags(mix, n_vol, iso)
    lib = _build.load("mse_loss")
    with torch.cuda.device(dev):
        err = lib.rtrt_mse_loss(
            ctypes.c_void_p(fparams.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), n, key[0], key[1], n_pixels,
            spp, width, max_depth, int(bg_kind), int(bool(clay)), *flags,
            *tris, float(clamp), ctypes.c_void_p(target.data_ptr()),
            ctypes.c_void_p(partials.data_ptr()), blocks,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_mse_loss launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
    EXT_LAUNCHES += flags[0]
    TRI_LAUNCHES += int(tri is not None)
    return out[k], out[:k]


class FusedMSE(torch.autograd.Function):
    """The loss on the card under autograd: the forward launches the fused
    kernel and keeps its gradient (the port of ``_mse_cvjp``)."""

    @staticmethod
    def forward(ctx, fparams, kinds, key, target, spp, width, clamp, opts):
        loss, dfp = mse_loss_cuda(fparams, kinds, key, target, spp, width,
                                  clamp=clamp, **opts)
        ctx.save_for_backward(dfp)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        (dfp,) = ctx.saved_tensors
        return (dfp * gbar,) + (None,) * 7


def mse_loss(fparams: torch.Tensor, kinds: torch.Tensor,
             key: tuple[int, int], target: torch.Tensor, spp: int,
             width: int, *, max_depth: int, bg_kind: int, clay: bool,
             clamp: float, mix: bool = False, n_vol: int = 0,
             iso: bool = False, n_tm: int = 0,
             tri: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The frame's loss, differentiable in ``fparams``: on the card the
    fused kernel under autograd, the forward kernel plus a PyTorch
    reduction without it; on the CPU the plain version."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay, mix=mix,
                n_vol=n_vol, iso=iso, n_tm=n_tm, tri=tri)
    if K.select_engine(fparams.device) == "cuda":
        if fparams.requires_grad and torch.is_grad_enabled():
            return FusedMSE.apply(fparams, kinds, key, target, spp, width,
                                  clamp, opts)
        rad = K.radiance_cuda(fparams, kinds, key, target.shape[0] * spp,
                              spp, width, **opts)
        return reduce_mse(rad, target, spp, clamp)
    return mse_loss_plain(fparams, kinds, key, target, spp, width,
                          clamp=clamp, **opts)
