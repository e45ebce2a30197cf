"""Shadow-ray occlusion kernel (#8): its wrapper and its plain PyTorch
version.

Replaces raytracingrust_tpu/ops/pallas_megakernel.py's occlusion kernel
(``_make_occlusion_kernel``, reached through ``_occlusion_call.run`` and
``occlusion_bvh``): for each next-event shadow ray of the HDRI
importance-sampling path (diff/replay.py's env branch), whether anything
lies along it beyond T_MIN, over the packed scene's sphere tree, then its
volume tree, then its triangle tree (ops/bvh_kernel.pack).  A volume
occludes stochastically, as in the JAX package: the ray's free flight
through it ends inside it, drawn from column ``2 + ordinal`` of the
bounce's NEE stream (``1 + max_depth + b``, render/integrator.py), so the
test reads each ray's global id and the key.  A ray leaves the walk at its
first candidate; the answer equals the TPU kernel's closest-hit
``t_best < inf`` (csrc/occlusion.cu says why).  The kernel walks the small
trees inside the chunks of the sphere and the triangle tree
(ops/bvh_kernel.sub_boxes), and refuses a scene packed without them; the
plain version tests every slot of a chunk, and its tally runs the small
trees' any-hit twin beside it (bvh_kernel._twin_check).

Rays are (3, R) float32 origins and directions, component-major, with
(R,) int32 ray ids.  On a CPU tensor :func:`occluded` runs the plain
version; on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.rng import ray_uniforms
from . import megakernel as K
from .bvh_kernel import (BvhScene, _leaf_size, _sub_args, _tree_args,
                         _walk_all)

# the NEE stream's columns: the sky direction's two, then one a volume
NEE_VOL_COL = 2

LAUNCHES = 0


def _check_rays(sc: BvhScene, o, d, ray_ids, key) -> int:
    """The ray count, after checking the rays against the scene."""
    if sc.spheres is None and sc.triangles is None and sc.volumes is None:
        raise ValueError("occlusion: the scene has no tree")
    if sc.mesh_vols is not None:
        raise ValueError("occlusion: the shadow-ray test does not model a "
                         "mesh volume's stochastic occlusion: such a scene "
                         "takes the generic engine (\"xla\")")
    r = o.shape[-1]
    for name, v in (("o", o), ("d", d)):
        K._check(v, name, torch.float32, (3, r), sc.device)
    if sc.volumes is not None:
        if ray_ids is None or key is None:
            raise ValueError("occlusion through volumes needs the rays' ids "
                             "and the key (their free-flight uniforms)")
        K._check(ray_ids, "ray_ids", torch.int32, (r,), sc.device)
        K._check_key(key)
    return r


def occluded_plain(sc: BvhScene, o: torch.Tensor, d: torch.Tensor,
                   ray_ids=None, key=None, stream: int = 0, *,
                   tally=None) -> torch.Tensor:
    """(R,) bool, what the kernel computes, in tensor ops on ``sc``'s
    device: each ray's any-hit walk of the sphere tree, then, for the rays
    it left unoccluded, of the volume tree, then of the triangle tree
    (bvh_kernel's vectorized walk, leaving at the first candidate).
    ``ray_ids``, ``key`` and the NEE ``stream`` give the volumes'
    uniforms; a scene without volumes needs none of them.  ``tally``, for
    measurement only, is a ``collections.Counter`` that receives the walk's
    node visits and sphere, volume and triangle tests, and those of the
    small trees' any-hit walk, which the kernel makes, with
    "sub_mismatch" (bvh_kernel._walk_all)."""
    r = _check_rays(sc, o, d, ray_ids, key)
    o3, d3 = list(o.unbind(0)), list(d.unbind(0))
    a = K._dot3(*d3, *d3)
    u_vol = None
    if sc.volumes is not None:
        u_vol = ray_uniforms(key, ray_ids, stream,
                             NEE_VOL_COL + sc.n_vol)[:, NEE_VOL_COL:]
    t_best, _ = _walk_all(sc, o3, d3, a, torch.ones(r, dtype=torch.bool,
                                                    device=o.device),
                          u_vol, tally, any_hit=True)
    return t_best < float("inf")


def occluded_cuda(sc: BvhScene, o: torch.Tensor, d: torch.Tensor,
                  ray_ids=None, key=None, stream: int = 0, *,
                  boxes=None) -> torch.Tensor:
    """Kernel #8: as :func:`occluded_plain`, on the card.  ``boxes``: the
    small trees' boxes (bvh_kernel.scene_sub_boxes), which a render
    computes once for all its launches; computed here if None."""
    global LAUNCHES
    from . import _build

    if sc.device.type != "cuda":
        raise ValueError(f"occluded_cuda needs CUDA tensors, got "
                         f"{sc.device}")
    r = _check_rays(sc, o, d, ray_ids, key)
    if r >= 2 ** 31 or not 0 <= stream < 2 ** 24:
        raise ValueError(f"occluded_cuda: {r} rays, stream {stream}")
    leaf = _leaf_size(sc)
    args = (_tree_args(sc.spheres, 4) + _tree_args(sc.volumes, 4, True)
            + _tree_args(sc.triangles, 12))
    subs, stride, _boxes = _sub_args(sc, boxes)
    out = torch.empty((r,), dtype=torch.bool, device=sc.device)
    if r == 0:
        return out
    k0, k1 = key if key is not None else (0, 0)
    lib = _build.load("occlusion")
    with torch.cuda.device(sc.device):
        err = lib.rtrt_occlusion(
            *args, leaf, sc.n_vol,
            ctypes.c_void_p(0 if ray_ids is None else ray_ids.data_ptr()),
            k0, k1, int(stream), ctypes.c_void_p(o.data_ptr()),
            ctypes.c_void_p(d.data_ptr()), r, ctypes.c_void_p(out.data_ptr()),
            *subs, stride,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_occlusion launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    LAUNCHES += 1
    return out


def occluded(sc: BvhScene, o: torch.Tensor, d: torch.Tensor, ray_ids=None,
             key=None, stream: int = 0, *, boxes=None) -> torch.Tensor:
    """#8 on a CUDA device (over the small trees' ``boxes`` if given), its
    plain version on the CPU."""
    if K.select_engine(sc.device) == "cuda":
        return occluded_cuda(sc, o, d, ray_ids, key, stream, boxes=boxes)
    return occluded_plain(sc, o, d, ray_ids, key, stream)
