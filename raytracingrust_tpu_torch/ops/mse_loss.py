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
A call without grad runs the forward megakernel plus the same reduction in
PyTorch (the JAX ``mse`` primal).  The plain version is that reduction over
:func:`megakernel.radiance_plain`, differentiated by autograd.  The clip's
gradient follows ``jnp.clip``: half at a sample exactly on 0 or ``clamp``.

Gate: :func:`supports_fused_mse`.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.scene import Scene
from . import megakernel as K

LAUNCHES = 0


def supports_fused_mse(scene: Scene) -> bool:
    """The kernel's envelope, at depth <= megakernel.MAX_DEPTH."""
    return (K.supports(scene)
            and scene.settings.max_ray_depth <= K.MAX_DEPTH)


def reduce_mse(rad: torch.Tensor, target: torch.Tensor, spp: int,
               clamp: float) -> torch.Tensor:
    """The loss from per-ray radiance (H W spp, 3) and target (H W, 3)."""
    m = K.clip_samples(rad, clamp).view(-1, spp, 3).mean(dim=1)
    return ((m - target) ** 2).mean()


def mse_loss_plain(fparams: torch.Tensor, kinds: torch.Tensor,
                   key: tuple[int, int], target: torch.Tensor, spp: int,
                   width: int, *, max_depth: int, bg_kind: int, clay: bool,
                   clamp: float) -> torch.Tensor:
    """The loss in PyTorch ops on any device, differentiable by autograd."""
    ray_ids, px, py = K.prep_rays(
        torch.arange(target.shape[0], device=target.device), spp, width)
    rad = K.radiance_plain(fparams, kinds, key, ray_ids, px, py,
                           max_depth=max_depth, bg_kind=bg_kind, clay=clay)
    return reduce_mse(rad, target, spp, clamp)


def mse_loss_cuda(fparams: torch.Tensor, kinds: torch.Tensor,
                  key: tuple[int, int], target: torch.Tensor, spp: int,
                  width: int, *, max_depth: int, bg_kind: int, clay: bool,
                  clamp: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d fparams) from one launch of the fused kernel."""
    global LAUNCHES
    from . import _build

    n = K.check_scene_inputs("mse_loss_cuda", fparams, kinds, key)
    dev, k = fparams.device, fparams.shape[0]
    n_pixels = target.shape[0]
    K._check(target, "target", torch.float32, (n_pixels, 3), dev)
    K.check_depth(max_depth)
    if not 0 < n_pixels * spp < 2 ** 31 or spp < 1 or width < 1:
        raise ValueError(f"bad launch: n_pixels={n_pixels} spp={spp} "
                         f"width={width}")
    blocks = K.max_blocks(dev)
    partials = torch.empty((blocks, k + 1), dtype=torch.float32, device=dev)
    out = torch.empty((k + 1,), dtype=torch.float32, device=dev)
    lib = _build.load("mse_loss")
    with torch.cuda.device(dev):
        err = lib.rtrt_mse_loss(
            ctypes.c_void_p(fparams.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), n, key[0], key[1], n_pixels,
            spp, width, max_depth, int(bg_kind), int(bool(clay)),
            float(clamp), ctypes.c_void_p(target.data_ptr()),
            ctypes.c_void_p(partials.data_ptr()), blocks,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_mse_loss launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
    return out[k], out[:k]


class FusedMSE(torch.autograd.Function):
    """The loss on the card under autograd: the forward launches the fused
    kernel and keeps its gradient (the port of ``_mse_cvjp``)."""

    @staticmethod
    def forward(ctx, fparams, kinds, key, target, spp, width, max_depth,
                bg_kind, clay, clamp):
        loss, dfp = mse_loss_cuda(fparams, kinds, key, target, spp, width,
                                  max_depth=max_depth, bg_kind=bg_kind,
                                  clay=clay, clamp=clamp)
        ctx.save_for_backward(dfp)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        (dfp,) = ctx.saved_tensors
        return (dfp * gbar,) + (None,) * 9


def mse_loss(fparams: torch.Tensor, kinds: torch.Tensor,
             key: tuple[int, int], target: torch.Tensor, spp: int,
             width: int, *, max_depth: int, bg_kind: int, clay: bool,
             clamp: float) -> torch.Tensor:
    """The frame's loss, differentiable in ``fparams``: on the card the
    fused kernel under autograd, the forward kernel plus a PyTorch
    reduction without it; on the CPU the plain version."""
    opts = dict(max_depth=max_depth, bg_kind=bg_kind, clay=clay)
    if K.select_engine(fparams.device) == "cuda":
        if fparams.requires_grad and torch.is_grad_enabled():
            return FusedMSE.apply(fparams, kinds, key, target, spp, width,
                                  max_depth, bg_kind, clay, clamp)
        rad = K.radiance_cuda(fparams, kinds, key, target.shape[0] * spp,
                              spp, width, **opts)
        return reduce_mse(rad, target, spp, clamp)
    return mse_loss_plain(fparams, kinds, key, target, spp, width,
                          clamp=clamp, **opts)
