"""Shadow-ray occlusion kernel (#8): its wrapper and its plain PyTorch
version.

Replaces raytracingrust_tpu/ops/pallas_megakernel.py's occlusion kernel
(``_make_occlusion_kernel``, reached through ``_occlusion_call.run`` and
``occlusion_bvh``): for each next-event shadow ray of the HDRI
importance-sampling path (diff/replay.py's env branch), whether anything
lies along it beyond T_MIN, over the packed scene's sphere tree and then
its triangle tree (ops/bvh_kernel.pack).  A ray leaves the walk at its
first candidate; the answer equals the TPU kernel's closest-hit
``t_best < inf`` (csrc/occlusion.cu says why).  The TPU kernel's volume
branch (free flight with the NEE stream's uniforms) waits for the port's
volume tree (ROADMAP B4): both versions refuse a packed scene with volume
spheres.

Rays are (3, R) float32 origins and directions, component-major.  On a CPU
tensor :func:`occluded` runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import megakernel as K
from .bvh_kernel import (BvhScene, _sphere_leaf, _tree_args, _triangle_leaf,
                         _walk)

LAUNCHES = 0


def _check_rays(sc: BvhScene, o: torch.Tensor, d: torch.Tensor) -> int:
    """The ray count, after checking the rays against the scene."""
    if sc.volumes:
        raise NotImplementedError(
            "shadow rays through constant-density volumes are not ported "
            "yet (ROADMAP B4)")
    if sc.spheres is None and sc.triangles is None:
        raise ValueError("occlusion: the scene has no tree")
    r = o.shape[-1]
    for name, v in (("o", o), ("d", d)):
        K._check(v, name, torch.float32, (3, r), sc.device)
    return r


def occluded_plain(sc: BvhScene, o: torch.Tensor, d: torch.Tensor, *,
                   tally=None) -> torch.Tensor:
    """(R,) bool, what the kernel computes, in tensor ops on ``sc``'s
    device: each ray's any-hit walk of the sphere tree, then, for the rays
    it left unoccluded, of the triangle tree (bvh_kernel's vectorized walk,
    leaving at the first candidate).  ``tally``, for measurement only, is a
    ``collections.Counter`` that receives the walk's node visits and sphere
    and triangle tests."""
    r = _check_rays(sc, o, d)
    o3, d3 = list(o.unbind(0)), list(d.unbind(0))
    a = K._dot3(*d3, *d3)
    inv_d = [1.0 / v for v in d3]
    t_best = torch.full_like(a, float("inf"))
    win = torch.full((r,), -1, dtype=torch.long, device=o.device)
    if sc.spheres is not None:
        _walk(sc.spheres, _sphere_leaf, o3, d3, inv_d, a,
              torch.ones_like(a, dtype=torch.bool), t_best, win, tally,
              "sphere_tests", any_hit=True)
    if sc.triangles is not None:
        _walk(sc.triangles, _triangle_leaf, o3, d3, inv_d, a,
              ~(t_best < float("inf")), t_best, win, tally,
              "triangle_tests", any_hit=True)
    return t_best < float("inf")


def occluded_cuda(sc: BvhScene, o: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """Kernel #8: as :func:`occluded_plain`, on the card."""
    global LAUNCHES
    from . import _build

    if sc.device.type != "cuda":
        raise ValueError(f"occluded_cuda needs CUDA tensors, got "
                         f"{sc.device}")
    r = _check_rays(sc, o, d)
    if r >= 2 ** 31:
        raise ValueError(f"occluded_cuda: {r} rays")
    leaf = (sc.spheres or sc.triangles).leaf_size
    args = _tree_args(sc.spheres, 4) + _tree_args(sc.triangles, 12)
    out = torch.empty((r,), dtype=torch.bool, device=sc.device)
    if r == 0:
        return out
    lib = _build.load("occlusion")
    with torch.cuda.device(sc.device):
        err = lib.rtrt_occlusion(
            *args, leaf, ctypes.c_void_p(o.data_ptr()),
            ctypes.c_void_p(d.data_ptr()), r, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_occlusion launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
    return out


def occluded(sc: BvhScene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """#8 on a CUDA device, its plain version on the CPU."""
    cuda = K.select_engine(sc.device) == "cuda"
    return (occluded_cuda if cuda else occluded_plain)(sc, o, d)
