#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracingrust_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a traceback and a
non-zero exit, and prints no result:

1. the card's name and power limit, then the build of the CUDA kernels
   from csrc/, one nvcc per source, all started together (seconds, and the
   compiler's register report);
2. the kernel's Threefry equals the plain ``ray_uniforms`` bit for bit;
3. kernel against its plain PyTorch version on the card, same inputs:
   per-ray radiance bit for bit equal, at depth 1 and at full depth, on the
   benchmark scene at 64x48 spp 4 (Full, Clay, gradient background) and at
   both shapes of phase 4; the plain version's seed-11-vs-12 image noise
   is printed beside each as the scale a fault would have.  Then the
   kernel's and the plain version's times, and the kernel's bound, at
   both shapes;
4. the main path through the CLI entry, in process: scenes/benchmark.json
   at 512x512 spp 8 depth 6, then scenes/cornell_spheres.json at the CLI's
   default 1000x1000 with its own spp 64 and depth 8.  The kernel's launch
   count must grow, the PNGs must exist, the images must be finite and not
   flat.  Then warm times and primary Mrays/s;
5. the gradient kernels against autograd through the plain version on the
   card, same inputs: the fused loss kernel's loss and gradient, and the
   radiance gradient kernel's gradient for numpy-seeded cotangents, on
   benchmark 64x48 spp 5 depth 6 (uniform and gradient background, Clay)
   and 512x512 spp 8 depth 6.  Every entry of a gradient must lie within
   GRAD_RTOL of the plain version's or GRAD_ATOL of its largest entry, the
   loss within LOSS_RTOL; every parameter group the case can move must
   have a nonzero gradient.  Then the fused kernel's lane groups where
   they can break: each of its four variants (benchmark.json's spheres,
   the zoo's kExt, tri_brute's kTri, tri_zoo's kExt + kTri, written as in
   phases 13 and 14) at depth 6 on a 61x37 frame, whose 2,257 pixels fill
   no whole block, at spp 1, 5, 8, 16, 48 (groups across warps) and 130
   (more than one sample a thread), loss and gradient against autograd
   through the plain version as above.  Then bench.py::run_parity's
   directional finite-difference probe of the fused kernel's own loss at
   64x48, and the kernels' and plain versions' times at 512x512;
6. the fit path: the CLI ``fit`` on scenes/benchmark.json at 512x512 spp 8
   depth 6 with bench.py's six parameters, against a target the port
   renders from perturbed albedos.  The fused kernel must launch once a
   step and the loss must be finite and fall.  Then the warm step time and
   primary Mrays/s fwd+bwd of ``fit``, its device time by kernel under
   ``torch.profiler`` (four steps), and two steps of a loss of its own
   through ``render_linear`` under autograd (forward kernel, then the
   radiance gradient kernel as its backward);
7. the BVH path (kernel #5) at full size on three shapes: the repo's
   scenes/bvh_stress.json (1,189 spheres) at the CLI's default 1000x1000
   with its own spp 8 and depth 4; "grid8k", 8,000 Lambertian spheres
   (scripts/exp_bvh.py's grid) at 512x512 spp 5 depth 6; and a sheet of
   8,192 triangles plus two spheres (tests/test_pallas_bvh.py's
   mesh_builder, n_side 64, read from an OBJ) at 512x512 spp 8 depth 6.
   The kernel against its plain version on the card, same inputs: per-ray
   radiance bit for bit equal at depth 1 and at full depth, on every ray.
   Then the CLI ``render`` of each shape (the kernel's launch count must
   grow, the brute kernel's must not; PNGs in build/smoke/), the kernel's
   and the plain version's times, the kernel's bound from the work the
   plain version's rays did, its registers, and the warm render wall and
   primary Mrays/s;
8. the BVH fit path (the record variant of #5, the winner-row fetch #6
   and its transpose #7, the replay in between) on bvh_stress 1000x1000
   spp 8 depth 4 and sheet64 512x512 spp 8 depth 6: the record variant's
   radiance equals #5's and its codes the plain record walk's, bit for
   bit on every ray and bounce; #6 equals its plain version bit for bit;
   #7 lies within FETCH_RTOL of the magnitudes it adds from its plain
   version summed in float64; the replay's forward within REPLAY_ATOL of
   #5's radiance; the packed tensors' gradient through the kernels within
   GRAD_RTOL/GRAD_ATOL of autograd through the plain route, finite; a
   directional FD probe of ``make_loss`` on albedo, emission and
   bg_color_a within 5%.  Then the times, plain versions' times, the
   library's ``index_select`` time for #6 (#7 has none: no one call
   scatters every table's winners) and bounds; the CLI
   ``fit`` of bvh_stress (albedo, emission; 6 steps) against a target the
   CLI rendered, whose loss must fall, with one launch of each of the
   three kernels a step; and the warm fit step of both shapes with its
   peak memory and a ``torch.profiler`` breakdown into the record kernel,
   #6, the replay's forward and backward, #7, Adam and host;
9. the HDRI importance-sampling path (the record variant of #5, #6, the
   occlusion kernel #8, the replay's MIS estimator; #7 under a fit) on a
   procedural 1024x2048 sky written with the port's EXR writer, over
   "sky_bvh_stress" (scenes/bvh_stress.json under the sky) at 1000x1000
   spp 8 depth 4 and "sky_sheet64" (phase 7's sheet under the sky) at
   512x512 spp 8 depth 6, both with importance sampling on: #8 equals its
   plain version bit for bit on every shadow ray of every bounce of the
   plain route's replay; the env radiance through the kernels equals the
   plain route (plain walk, fetch and occlusion test) bit for bit; the
   gradient in the packed tensors and the sky's texels through the
   kernels within GRAD_RTOL/GRAD_ATOL of the plain route at 64x48, finite;
   a directional FD probe of ``make_loss`` on albedo within 5%.  Then #8's
   time over a render's launches, its plain version's and its bound from
   the plain version's tally of the any-hit walk; the CLI ``render
   --env-is`` of both scenes (launches counted; PNGs in build/smoke/) with
   the warm render wall and a ``torch.profiler`` breakdown; the CLI ``fit
   --env-is`` of sky_bvh_stress at 512x512 (albedo, emission; 6 steps),
   whose loss must fall, with one launch of the record kernel, #6 and #7 a
   step and one of #8 a bounce that has a Lambertian hit; and the warm fit
   step at 1000x1000 with its breakdown and peak memory;
10. volumes, isotropic materials and mixes on the BVH path, on
   scenes/material_zoo.json (47 spheres, a fog sphere of an isotropic
   material, a mix) and "sky_zoo" (the zoo under phase 9's sky, env-IS on,
   spp 16), each kernel held to its plain version at the main path's own
   shapes: at the zoo's 1200x800 spp 32 depth 8, #5's radiance bit for bit
   equal at depth 1 and 8 on every ray (the volume tree's free flight, the
   mix rounds and the isotropic lobe); at the fit shape 600x400 spp 16
   depth 8, phase 8's list (#6 in raw mode), with an FD probe on albedo
   and emission; at sky_zoo 600x400 spp 16, phase 9's list, the gradient
   at that shape too, some shadow rays blocked by the fog alone.  Then the
   depth-13 fit of scenes/cornell_spheres.json at 256x256 spp 8: the
   record variant's radiance and codes equal the plain record walk's on
   every ray and bounce, and two fit steps run through record #5, #6 and
   #7, never #3 or #4, and the loss falls; the zoo's BVH route by name
   (the dispatch sends the zoo to the brute kernels, phase 13):
   ``render_linear(engine="bvh")`` at 1200x800 and ``fit(engine="bvh")``
   at 600x400 (albedo, emission; 6 steps; the loss must fall), and the CLI
   ``render --env-is`` of sky_zoo, each with its launches counted; and
   the warm render and fit step on #5's route (the zoo's: albedo, emission,
   sphere centers and radii, these held within ZOO_FIT_GEO of their start;
   sky_zoo's: albedo, emission; each loss must fall) with a ``torch.profiler``
   breakdown and the peak memory;
11. a sky map without importance sampling, and the inspection views, on
   #5: "sky_bvh_stress" and "sky_sheet64" (phase 9's scenes and sky,
   importance sampling off) at 1000x1000 spp 8, #5's sky-map variant
   (the texel looked up in the kernel) bit for bit equal to its plain
   version at depth 1 and full depth on every ray; at sky_bvh_stress the
   sky fit's kernels as phase 8 checks them (the record walk under a
   black background; the replay with the sky on a miss held to the
   sky-map variant within REPLAY_ATOL), the gradient in the packed
   tensors and the sky's texels against the plain route, an FD probe on
   albedo and one on the texel of largest gradient; the Normal and
   Random views of bvh_stress, sheet64, sky_sheet64 and the zoo at
   1000x1000 spp 8, each bit for bit equal to its plain version, timed,
   with its bound from the one-bounce tally.  Then the CLI renders of
   both sky scenes and of the eight views (launches counted: the sky-map
   variant and the views, no other kernel), the warm sky renders, the
   CLI fit of sky_bvh_stress at 512x512 (record #5, #6, #7 six times,
   never #8; the loss must fall) and the warm fit step at 1000x1000 with
   its breakdown and peak memory;
12. mesh-bounded volumes on #5: "fog_sheet" (phase 7's sheet of 8,192
   triangles with its metal and emissive spheres under a gradient
   background, an icosphere of 2,048 triangles bounding a fog of an
   isotropic material, and a 12-triangle cube bounding a fog of a mix;
   written as JSON and OBJs to build/smoke/) at 1000x1000 with its own
   spp 8 and depth 6: #5's mesh-volume variant (the walks of each fog
   boundary's own tree) bit for bit equal to its plain version at
   depth 1 and depth 6 on every ray, and the Normal and Random views on
   every ray, each timed with its bound from the plain run's count of
   the trees' node visits and Moller-Trumbore tests, and the variants'
   registers and spills; at the fit's frame 512x512, phase 8's list (the
   record codes, #6 raw with the fogs' codes, #7 against its float64
   sums, the replay's forward, the gradient against the plain route)
   with an FD probe on the icosphere's phase albedo.  Then the CLI
   ``render`` (1000x1000), the two views and ``fit`` (512x512, albedo and
   emission, 6 steps; the loss must fall), each launching the mesh-volume
   variants and no other kernel of the path, and the warm render and fit
   step with a ``torch.profiler`` breakdown and the peak memory.
   ``python3 chip_smoke.py 12`` runs the build and this phase alone;
13. the brute kernels' mixes, sphere volumes, isotropic lobe and sky map
   (#1's, #3's and #4's ``kExt`` and ``kSky`` variants) on three shapes
   the dispatch sends to them: "zoo_brute" (scenes/material_zoo.json at
   its own 1200x800 spp 32 depth 8; its fit at 600x400 spp 16, #4),
   "sky_bench" (scenes/benchmark.json under phase 9's sky, importance
   sampling off, 1000x1000 spp 8 depth 6; its fit at 512x512, #1 + #3)
   and "sky_zoo_naive" (the zoo under the sky, importance sampling off,
   600x400 spp 16 depth 8; both flags in #1 and #3).  #1 bit for bit
   equal to its plain version on every ray at depth 1 and at full depth;
   #3 (the sky's texels included) and #4 at the fit's frame within
   GRAD_RTOL/GRAD_ATOL of autograd through the plain version (summed over
   pixel ranges), finite; an FD probe of
   ``make_loss`` on four albedos of the zoo and one on the texel of
   largest gradient of sky_bench within 5%.  Then the kernels' and the
   plain versions' times and bounds from a plain run's tally; the CLI
   ``render`` and ``fit`` (albedo, emission; 6 steps; the loss must
   fall) of each shape with its launches (#4 a step on the zoo, #1 and #3
   a step under the sky, no #5), an L1 loss of the zoo through
   ``render_linear`` (#1, then #3 as its backward), the warm render and
   fit step with a ``torch.profiler`` breakdown and the peak memory (the
   zoo's beside phase 10's #5 route on the same shapes), and each
   variant's registers and spills.
14. the brute kernels' triangles (#1's, #3's and #4's ``kTri`` variants,
   with ``kExt`` and ``kSky``) on three shapes built without their BVH,
   written with their OBJs to OUT_DIR: "tri_brute" (scenes/benchmark.json
   over a numpy-seeded height field of 1,024 triangles, half Lambertian
   and half metal, 1000x1000 spp 8 depth 6; its fit at 512x512 with
   ``bench.py``'s six parameters, #4), "tri_zoo" (the zoo with a
   320-triangle icosphere of its mix and a two-triangle mirror, 1200x800
   spp 32 depth 8; its fit at 600x400 spp 16, #4) and "tri_zoo_sky" (that
   under phase 9's sky, importance sampling off, 600x400 spp 16; its fit
   #1 + #3).  The checks, times, CLI runs, an L1 loss of tri_brute
   (#1, then #3) and the warm renders and fit steps as phase 13's; then
   the route comparison: tri_brute built with its BVH on #5 (its kernel,
   warm render and fit step on the record walk and the replay).
   ``python3 chip_smoke.py 14`` runs the build and this phase alone.

The line before the last is the kernel report as JSON: each kernel's
launches on its own path (the forward kernel's in the CLI renders of
phase 4, the radiance gradient kernel's under ``render_linear``'s
backward, the fused kernel's in the CLI fit, the BVH kernel's in the CLI
renders of phase 7, the record variant's, #6's and #7's in the CLI fit of
phase 8, #8's in the CLI renders of phase 9, and phase 10's entries of #5,
its record variant, #6, #7 and #8 on the zoo and sky_zoo from its
render and fit by name and its CLI env render, phase 11's sky-map
variant and views of #5 from its CLI renders, phase 12's mesh-volume
variants of #5, its record walk, views, #6 and #7 from its CLI render,
views and fit, phase 13's variants of #1 (its CLI renders), #3 (the
zoo's L1 loss, the CLI fits under the sky) and #4 (the zoo's CLI fit),
and phase 14's triangle variants of #1 (its CLI renders), #3 (tri_brute's
L1 loss, the CLI fit under the sky) and #4 (the CLI fits); the other
paths' counts are in the phase lines), and its least
possible time for one forward and one reverse sweep of the FP32
operations the run's rays traced, or for the bytes it must move; the last
line is
``{"ok": true, "device": {...}}``.  The run needs one CUDA device and
fails without one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

BENCH = "scenes/benchmark.json"
CORNELL = "scenes/cornell_spheres.json"
STRESS = "scenes/bvh_stress.json"
OUT_DIR = os.path.join("build", "smoke")
SEED_WORDS_HIGH = 0xDEADBEEFCAFEBABE  # both 32-bit words >= 2^31
BENCH_PARAMS = "albedo,fuzz,ir,emission,cam_lookfrom,bg_color_a"
# gradient kernels vs autograd through the plain version: the same
# branches, other summation orders (shared atomics, per-block partials)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5  # of |plain|, of max |plain|
LOSS_RTOL = 1e-5
# the card's peaks (NVIDIA's H100 SXM data sheet): FP32 outside the
# tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of csrc/radiance.cuh, counted from its source (sinf and
# cosf as ~20 each): per ray (camera), per bounce a ray enters (uniforms,
# a, 1/a), per sphere tested, per hit by lobe, per miss by background kind
OPS_RAY = 25
OPS_BOUNCE = 10
OPS_SPHERE = 31
OPS_HIT = 75  # hit point, normal, face, sphere sample
OPS_LOBE = {0: 6, 1: 45, 2: 65, 3: 3}  # Lambertian .. Emission
# a miss under a sky map (radiance.cuh sky_radiance): the normalization
# (5 for the length, sqrtf, 3 divisions), acosf (~20), atan2f (~25), the
# clamp, the offset, 2 scales, 2 products, 2 floors, the wrap and flip
OPS_MISS = {0: 6, 1: 25, 2: 65}
# The reverse of that chain, which a gradient needs once besides one
# forward: only the adjoint's own operations count, not the forward values
# that the kernels recompute (the hit and normal, ~45 a bounce; the metal
# sample and reflection; the background blend) nor csrc/mse_loss.cu's
# second forward.  Per ray that ended within the depth (the kernels skip
# the others): the camera's adjoint, then the path's end by what ended it
# (a miss by background kind, an emitter, a metal ray absorbed below the
# surface), then per scattering bounce the throughput, hit point, normal
# and root, and its lobe by kind (the dielectric as the mean of its
# reflect, ~50, and refract, ~70, branches).
OPS_ADJ_RAY = 37
OPS_ADJ_MISS = {0: 9, 1: 41, 2: 3}
OPS_ADJ_EMIT = 9
OPS_ADJ_ABSORB = 6
OPS_ADJ_HIT = 99
OPS_ADJ_LOBE = {0: 0, 1: 52, 2: 60}
# the loss around it (mse_loss.cu): per sample the clip, the sum and the
# clip's slope times the pixel's cotangent; per pixel the mean, the error,
# its square and the cotangent
OPS_LOSS_RAY = 15
OPS_LOSS_PIXEL = 15
# the brute kernels' kExt branches (csrc/radiance.cuh trace, adjoint),
# counted from the source: per bounce with volumes the ray's length
# (sqrtf, ~5); per volume a ray tests, the quadratic (OPS_SPHERE) and the
# window (4: the clamp, the far root's test, the compare); a window a ray
# crosses draws its free flight (OPS_VOL_DRAW); each hit in a scene with
# mixes converts the coin and compares it with the factor (2); the
# isotropic lobe is OPS_ISO.  Their adjoints: a volume winner's hit
# through its window and free flight (sqrtf, logf and the divisions,
# ~35); a miss under a sky map only g * thr (3), its lookup being a
# forward value recomputed
OPS_RAY_LEN = 5
OPS_VOL_WINDOW = 4
OPS_MIX_PICK = 2
OPS_ADJ_VOL = 35
# csrc/bvh_forward.cu, counted from its source: per bounce a ray enters
# (a, 1/d, the uniforms), per node a walk visits (the slab test: 6
# differences, 6 products, 12 min/max, the compare), per sphere and per
# triangle a leaf tests, with the merge's compare; the camera ray, hit,
# lobes and background are radiance.cuh's, counted as above
OPS_BVH_BOUNCE = 12
OPS_NODE = 25
OPS_SPHERE_TEST = 30
OPS_TRI_TEST = 55
# csrc/bvh_walk.cuh volume_t, counted from its source: the quadratic and
# the window per volume candidate; a window a ray crosses adds the draw's
# float part, logf (~20) and the free flight; with mixes each hit resolves
# in 4 rounds (the coins' conversions and compares); the isotropic lobe is
# cbrt01 (logf and expf, ~20 each) and the scaled sample
OPS_VOL_TEST = 30
OPS_VOL_DRAW = 29
OPS_MIX_HIT = 8
OPS_ISO = 45
# the Normal view's hit (bvh_forward.cu bvh_view_kernel): the hit point,
# the normal, the face, its length (5, sqrtf, the division), the colour
OPS_VIEW_HIT = 40
# csrc/bvh_walk.cuh mv_walk and mesh_volume_scan, counted from their
# source: per node of a mesh volume's tree a walk visits, the three slabs
# (6 differences, 6 products, 6 NaN tests, 6 min/max), entry and exit (4),
# the slack (4) and the three comparisons with their two sums (5); per
# boundary triangle a walk tests, triangle_raw (h, det, s, u, q, v, t: 43)
# with its 5 compares and the floor and min compares; per window a ray
# crosses, the window (4), the draw's float part, logf (~20) and the free
# flight (4)
OPS_MV_NODE = 37
OPS_MV_TEST = 50
OPS_MV_DRAW = 29
# the brute kernels' kTri branch (csrc/radiance.cuh tri_hit), counted from
# its source with a fused multiply-add as two operations: per ray and
# bounce the moment w = o x d (9); per triangle a ray tests, the
# determinant and num_t (7 multiply-adds and an add, 15), |a| and its
# compare, 1/a (~4), t and its two compares: ~24, and for a t below the
# best so far u and v (12 multiply-adds, 3 products and 5 compares, ~32),
# ~30 on average; the adjoint of a triangle winner's t (1/a, num_t,
# the four products, the origin's and direction's terms: ~30)
OPS_TRI_W = 9
OPS_TRI_BRUTE = 30
OPS_ADJ_TRI = 30
BYTES_TRI = 80  # a triangle's row (pack_tri)


def _cuda_time_ms(fn, reps: int, warm: bool = True) -> float:
    """ms a call of ``fn``, the mean of ``reps`` after a warm-up call
    (none with ``warm`` False: a plain version that ran at this shape just
    before, whose seconds no first-call cost moves)."""
    import torch

    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(ops: float, n_bytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


class _Count:
    """What the rays of one plain-version run traced, from the masks it
    passes to ``radiance_plain(..., observe=count)`` once a bounce: rays
    entering each bounce, hits by the winner's kind (the picked mix
    leaf's), misses; with volumes the windows crossed; under a sky map
    the texels looked up.  Sums only, so a frame of many tiles adds up."""

    def __init__(self):
        self.bounces = self.misses = self.windows = self.tri_hits = 0
        self.hits = collections.Counter()
        self.texels = None

    def __call__(self, alive, hit, kind, windows=0, vol=None, texels=None,
                 tri=None):
        self.bounces += int(alive.sum())
        self.misses += int((alive & ~hit).sum())
        self.windows += windows
        if tri is not None:
            self.tri_hits += int((alive & tri).sum())
        for k in range(5):
            self.hits[k] += int((alive & hit & (kind == k)).sum())
        if texels is not None:
            self.texels = texels if self.texels is None else (
                self.texels | texels)

    def texel_bytes(self) -> int:
        """The bytes of the sky's texels looked up, each once."""
        return 0 if self.texels is None else 12 * int(self.texels.sum())

    def forward_ops(self, n_rays: int, n_spheres: int, bg_kind: int,
                    mix: bool = False, n_vol: int = 0, n_tri: int = 0,
                    **_) -> int:
        """FP32 operations of the forward chain over these rays (the
        options as ``megakernel.scene_opts`` gives them; ``n_tri``
        triangles)."""
        lobe = {**OPS_LOBE, 4: OPS_ISO}
        hits = sum(self.hits.values())
        return (n_rays * OPS_RAY
                + self.bounces * (OPS_BOUNCE + n_spheres * OPS_SPHERE)
                + hits * OPS_HIT
                + sum(self.hits[k] * lobe[k] for k in range(5))
                + self.misses * OPS_MISS[bg_kind]
                + (self.bounces * (OPS_RAY_LEN + n_vol * OPS_VOL_WINDOW)
                   + self.windows * OPS_VOL_DRAW if n_vol else 0)
                + (hits * OPS_MIX_PICK if mix else 0)
                + (self.bounces * (OPS_TRI_W + n_tri * OPS_TRI_BRUTE)
                   if n_tri else 0))


class _Tally(_Count):
    """A :class:`_Count` that also keeps, for the reverse sweep, which rays
    ended within the depth and their scattering bounces by kind.  A
    Full-mode scene of one tile of rays."""

    def __init__(self, max_depth: int):
        super().__init__()
        self.max_depth = max_depth
        self.calls = 0
        self.prev = None  # rays that hit a scattering kind at the last call

    def __call__(self, alive, hit, kind, windows=0, vol=None, texels=None,
                 tri=None):
        import torch

        super().__call__(alive, hit, kind, windows, vol, texels, tri)
        if self.prev is None:
            self.ended = torch.zeros_like(alive)
            self.absorbed = torch.zeros_like(alive)
            # scattering bounces by kind (3, the emitter, unused), then
            # those whose winner is a volume
            self.scatter = torch.zeros((7,) + alive.shape, dtype=torch.int32,
                                       device=alive.device)
        else:  # a metal ray reflected below the surface ends there
            self.absorbed |= self.prev & ~alive
            self.scatter[1] -= (self.prev & ~alive).int()
        self.calls += 1
        for k in (0, 1, 2, 4):
            self.scatter[k] += (alive & hit & (kind == k)).int()
        if vol is not None:
            self.scatter[5] += (alive & vol & (kind != 3)).int()
        if tri is not None:  # scattering bounces off a triangle
            self.scatter[6] += (alive & tri & (kind != 3)).int()
        self.ended |= (alive & ~hit) | (alive & hit & (kind == 3))
        self.prev = alive & hit & (kind != 3)

    def adjoint_ops(self, bg_kind: int) -> int:
        """FP32 operations of the reverse sweep over the same rays."""
        absorbed = self.absorbed.clone()
        if self.calls < self.max_depth:  # nothing was alive after the last
            absorbed |= self.prev
            self.scatter[1] -= self.prev.int()
        ended = self.ended | absorbed
        scatter = [int(self.scatter[k][ended].sum()) for k in range(7)]
        lobe = {**OPS_ADJ_LOBE, 4: 0}
        return (int(ended.sum()) * OPS_ADJ_RAY
                + self.misses * OPS_ADJ_MISS[bg_kind]
                + self.hits[3] * OPS_ADJ_EMIT
                + int(absorbed.sum()) * OPS_ADJ_ABSORB
                + sum(scatter[k] * (OPS_ADJ_HIT + lobe[k])
                      for k in (0, 1, 2, 4))
                + scatter[5] * OPS_ADJ_VOL
                + scatter[6] * (OPS_ADJ_TRI - OPS_ADJ_HIT))


class _TallySum(_Count):
    """:class:`_Tally`'s counts summed over ranges of rays, each range
    traced on its own (:func:`_brute_plain_grads`): the forward counts and
    the reverse sweep's FP32 operations, ``adj_ops``."""

    def __init__(self):
        super().__init__()
        self.adj_ops = 0

    def add(self, t: _Tally, bg_kind: int) -> None:
        self.bounces += t.bounces
        self.misses += t.misses
        self.windows += t.windows
        self.tri_hits += t.tri_hits
        self.hits.update(t.hits)
        if t.texels is not None:
            self.texels = t.texels if self.texels is None else (
                self.texels | t.texels)
        self.adj_ops += t.adjoint_ops(bg_kind)


def _sheet_obj(path: str, n_side: int) -> None:
    """tests/test_pallas_bvh.py::mesh_builder's sheet, 2 n_side^2
    triangles, as an OBJ."""
    import numpy as np

    xs = np.linspace(-2, 2, n_side + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.3 * np.sin(gx * 2.1) * np.cos(gz * 1.7)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    for i in range(n_side):
        for j in range(n_side):
            a = i * (n_side + 1) + j + 1  # 1-based
            lines.append(f"f {a} {a + 1} {a + n_side + 1}")
            lines.append(f"f {a + 1} {a + n_side + 2} {a + n_side + 1}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def bvh_scenes() -> list:
    """Phase 7's shapes: (label, scene JSON, width, height, CLI flags).
    grid8k and the sheet are written as JSON (and OBJ) to OUT_DIR, so the
    CLI reads them as a user's files."""
    from raytracingrust_tpu_torch import (Camera, Emission, Lambertian,
                                          Metal, RenderSettings,
                                          SceneBuilder)
    from raytracingrust_tpu_torch.models.mesh import Mesh

    b = SceneBuilder()  # scripts/exp_bvh.py's grid8k
    m = b.add_material(Lambertian((0.5, 0.5, 0.5)))
    for i in range(20):
        for j in range(20):
            for k in range(20):
                b.add_sphere((i * 1.0, j * 1.0, k * 1.0), 0.3, m)
    c = (9.5, 9.5, 9.5)
    b.camera = Camera.create(tuple(ci + 2.2 * 20 * v for ci, v in
                                   zip(c, (0.7, 0.6, 0.8))), c, (0, 1, 0),
                             45.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=5, max_ray_depth=6)
    grid = os.path.join(OUT_DIR, "grid8k.json")
    b.save(grid)

    obj = os.path.join(OUT_DIR, "sheet64.obj")
    _sheet_obj(obj, 64)
    b = SceneBuilder()  # tests/test_pallas_bvh.py::mesh_builder(n_side=64)
    b.camera = Camera.create((0, 2.5, 4), (0, 0, 0), (0, 1, 0), 55.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=8, max_ray_depth=6)
    ml = b.add_material(Lambertian((0.6, 0.5, 0.3)))
    mm = b.add_material(Metal((0.9, 0.85, 0.8), 0.05))
    me = b.add_material(Emission((2.5, 2.2, 1.8)))
    b.add_mesh(Mesh.from_file(obj, ml))
    b.add_sphere((0.8, 1.2, 0.0), 0.4, mm)
    b.add_sphere((-1.2, 1.8, 0.5), 0.35, me)
    sheet = os.path.join(OUT_DIR, "sheet64.json")
    b.save(sheet)
    size = ["--width", "512", "--height", "512"]
    return [("bvh_stress", STRESS, 1000, 1000, []),  # the CLI's defaults
            ("grid8k", grid, 512, 512, size),
            ("sheet64", sheet, 512, 512, size)]


def _ptxas(name: str) -> str:
    """The compiler's register and spill report of one kernel source."""
    from raytracingrust_tpu_torch.ops import _build

    log = _build.library_path(name=name).with_suffix(".log")
    return " | ".join(ln.strip() for ln in (
        log.read_text().splitlines() if log.exists() else [])
        if "registers" in ln or "spill" in ln)


def _reset_launches() -> None:
    """Sets every kernel's launch count to 0."""
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import fetch as F
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import occlusion as OC
    from raytracingrust_tpu_torch.ops import radiance_grad as RG

    BK.LAUNCHES = BK.RECORD_LAUNCHES = OC.LAUNCHES = K.LAUNCHES = 0
    BK.SKY_LAUNCHES = BK.VIEW_LAUNCHES = BK.MV_LAUNCHES = 0
    F.FETCH_LAUNCHES = F.TRANSPOSE_LAUNCHES = RG.LAUNCHES = MS.LAUNCHES = 0
    K.EXT_LAUNCHES = K.SKY_LAUNCHES = RG.EXT_LAUNCHES = RG.SKY_LAUNCHES = 0
    MS.EXT_LAUNCHES = K.TRI_LAUNCHES = RG.TRI_LAUNCHES = MS.TRI_LAUNCHES = 0


def _launches() -> dict:
    """Every kernel's launches since :func:`_reset_launches`."""
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import fetch as F
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import occlusion as OC
    from raytracingrust_tpu_torch.ops import radiance_grad as RG

    return dict(fwd=BK.LAUNCHES, sky=BK.SKY_LAUNCHES, view=BK.VIEW_LAUNCHES,
                record=BK.RECORD_LAUNCHES, mv=BK.MV_LAUNCHES,
                fetch=F.FETCH_LAUNCHES, transpose=F.TRANSPOSE_LAUNCHES,
                occlusion=OC.LAUNCHES, brute=K.LAUNCHES, grad=RG.LAUNCHES,
                fused=MS.LAUNCHES, brute_ext=K.EXT_LAUNCHES,
                brute_sky=K.SKY_LAUNCHES, grad_ext=RG.EXT_LAUNCHES,
                grad_sky=RG.SKY_LAUNCHES, fused_ext=MS.EXT_LAUNCHES,
                brute_tri=K.TRI_LAUNCHES, grad_tri=RG.TRI_LAUNCHES,
                fused_tri=MS.TRI_LAUNCHES)


def _entry(name: str, source: str, at: str, launches: int, err: float,
           ms: float, plain_ms: float, bound: tuple, lib=None) -> dict:
    """One kernel's entry of the kernel report."""
    return {"name": name, "route": "cuda",
            "source": "raytracingrust_tpu_torch/csrc/" + source,
            "replaces": "raytracingrust_tpu/ops/pallas_megakernel.py:" + at,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib}


def _load(path: str, spp=None, depth=None):
    """The scene of a JSON, at another spp or depth if given."""
    from raytracingrust_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder.from_file(path)
    b.settings = dataclasses.replace(
        b.settings, samples_per_pixel=spp or b.settings.samples_per_pixel,
        max_ray_depth=depth or b.settings.max_ray_depth)
    return b.build()


def _write_scene(src: str, name: str, dim: bool = False, sky: bool = False,
                 **settings) -> str:
    """Writes the scene JSON ``src`` to OUT_DIR/``name``, with every albedo
    at 0.7 of its value (``dim``: a fit's target), under the procedural
    sky SKY with importance sampling on (``sky``), and ``settings`` over
    its own; -> its path."""
    with open(src) as f:
        d = json.load(f)
    if dim:
        for m in d["materials"]:
            if "albedo" in m:
                m["albedo"] = {c: 0.7 * v for c, v in m["albedo"].items()}
    if sky:
        d["background"] = {"type": "SkyMap", "path": SKY}
        settings = {"env_importance_sampling": True, **settings}
    d["settings"].update(settings)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def _bit_equal(what: str, a, b) -> float:
    """Raises unless the float tensors ``a`` and ``b`` (R, 3) are equal
    bit for bit, with the count of rays that differ; -> their max abs
    difference (0.0)."""
    import torch

    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        bad = (a.view(torch.int32) != b.view(torch.int32)).any(dim=1)
        raise AssertionError(
            f"{what} differs on {int(bad.sum())} of {bad.numel()} rays, max "
            f"abs diff {(a - b).abs().max().item():.3e}")
    return 0.0


def _grad_check(label, got, want) -> float:
    """Max abs diff of gradients within GRAD_RTOL/GRAD_ATOL of the plain
    route's, finite; raises otherwise."""
    import torch

    err = 0.0
    for a, b in zip(got, want):
        e = (a - b).abs()
        if not bool(torch.isfinite(a).all()) or bool(
                (e > GRAD_RTOL * b.abs() + GRAD_ATOL * b.abs().max()).any()):
            raise AssertionError(f"{label}: a gradient differs from the "
                                 f"plain route by up to {e.max().item():.3e}")
        err = max(err, e.max().item())
    return err


def _scene_bytes(sc) -> int:
    """Bytes of a packed scene's tensors that #5 reads: head, tables, the
    trees', and the mesh volumes' tree, bounds, densities and materials
    (not their dense rows, which only the replay reads)."""
    import torch

    mv = sc.mesh_vols
    return sum(t.numel() * t.element_size() for t in (
        sc.head, sc.mats, sc.kinds, *(sc.mixes or ()),
        *(v for tree in (sc.spheres, sc.volumes, sc.triangles)
          if tree is not None for v in tree),
        *(() if mv is None else (*mv.tree[:4], mv.bounds, mv.nid, mv.mat)))
        if isinstance(t, torch.Tensor))


def _bvh_ops(sc, tally, n_rays: int, bg_kind: int,
             record: bool = False, view=None) -> int:
    """FP32 operations of #5, or with ``record`` of its record variant, or
    of its ``view`` ("normal", "random"), over the rays a plain run
    tallied."""
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK

    hits = [tally[f"hits_{k}"] for k in range(5)]
    lobe = {**OPS_LOBE, 4: OPS_ISO}
    ops = (n_rays * OPS_RAY
           + tally["bounces"] * (OPS_BVH_BOUNCE + (1 if sc.iso else 0))
           + tally["nodes"] * OPS_NODE
           + tally["sphere_tests"] * OPS_SPHERE_TEST
           + tally["volume_tests"] * OPS_VOL_TEST
           + tally["volume_draws"] * OPS_VOL_DRAW
           + tally["triangle_tests"] * OPS_TRI_TEST
           + tally["mv_nodes"] * OPS_MV_NODE
           + tally["mv_tests"] * OPS_MV_TEST
           + tally["mv_draws"] * OPS_MV_DRAW
           + sum(hits) * (OPS_HIT + (OPS_MIX_HIT if sc.mixes is not None
                                     else 0))
           + sum(n * lobe[k] for k, n in enumerate(hits))
           + tally["view_hits"] * (OPS_VIEW_HIT if view == "normal" else 0)
           + tally["misses"] * OPS_MISS[bg_kind])
    if record:  # the record's decisions: the metal and dielectric tests
        ops += sum(hits) * (
            (OPS_LOBE[1] if sc.rec_mask & BK.REC_METAL_OK else 0)
            + (OPS_LOBE[2] if sc.rec_mask & BK.REC_REFLECT else 0))
    return ops


def _texel_bytes(tally) -> int:
    """The bytes of the sky's texels a plain run looked up, each once."""
    seen = tally.get("sky_texels")
    return 0 if seen is None else 12 * int(seen.sum())


def _forward_check(label, sc, key, n_pix: int, spp: int, width: int,
                   opts: dict, tally: bool = True) -> dict:
    """#5 against its plain version on the same rays: per-ray radiance bit
    for bit equal at depth 1 and at full depth on every ray (``opts`` may
    name a sky map).  Then #5's time, the plain version's (the full-depth
    run), and with ``tally`` the work that run's rays did (counted as it
    runs, in its time) and #5's bound from it."""
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import megakernel as K

    n_rays = n_pix * spp
    ids, px, py = K.prep_rays(torch.arange(n_pix, device=sc.device), spp,
                              width)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    count = collections.Counter() if tally else None
    for d in (1, opts["max_depth"]):
        at = {**opts, "max_depth": d}
        ker = BK.radiance_bvh_cuda(sc, key, n_rays, spp, width, **at)
        start.record()
        with torch.no_grad():
            plain = BK.radiance_bvh_plain(
                sc, key, ids, px, py,
                tally=count if d == opts["max_depth"] else None, **at)
        end.record()
        torch.cuda.synchronize()
        err = _bit_equal(f"{label}: #5's radiance at depth {d}", ker, plain)
    plain_ms = start.elapsed_time(end)
    del ker, plain
    ms = _cuda_time_ms(lambda: BK.radiance_bvh_cuda(
        sc, key, n_rays, spp, width, **opts), 5)
    if not tally:
        return dict(ms=ms, plain_ms=plain_ms, err=err)
    ops = _bvh_ops(sc, count, n_rays, opts["bg_kind"])
    return dict(ms=ms, plain_ms=plain_ms, err=err, tally=count, ops=ops,
                bound=_bound(ops, _scene_bytes(sc) + 12 * n_rays
                             + _texel_bytes(count)))


def _per_ray(tally, n_rays: int) -> str:
    """A plain run's work per ray, for the phase lines."""
    return (f"{tally['bounces'] / n_rays:.3f} bounces, "
            f"{tally['nodes'] / n_rays:.2f} node visits, "
            f"{tally['sphere_tests'] / n_rays:.1f} sphere, "
            f"{tally['volume_tests'] / n_rays:.3f} volume and "
            f"{tally['triangle_tests'] / n_rays:.1f} triangle tests, "
            f"{tally['volume_draws'] / n_rays:.3f} free flights"
            + (f", {tally['mv_nodes'] / n_rays:.1f} mesh-volume node "
               f"visits, {tally['mv_tests'] / n_rays:.1f} mesh-volume "
               f"triangle tests, {tally['mv_draws'] / n_rays:.3f} "
               f"mesh-volume windows" if tally["mv_nodes"] else ""))


def _record_check(label, sc, key, n_pix: int, spp: int, width: int,
                  opts: dict, tally: bool = True) -> tuple:
    """#5 and its record variant against the plain record walk on the same
    rays: both radiances equal the plain one bit for bit, and the codes
    the plain codes, on every ray and bounce.  -> (#5's radiance, the
    codes, the max abs difference (0.0), the plain walk's ms, and with
    ``tally`` the work its rays did, counted as it runs, in its time)."""
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import megakernel as K

    n_rays = n_pix * spp
    ids, px, py = K.prep_rays(torch.arange(n_pix, device=sc.device), spp,
                              width)
    ker = BK.radiance_bvh_cuda(sc, key, n_rays, spp, width, **opts)
    rec, codes = BK.radiance_bvh_cuda(sc, key, n_rays, spp, width,
                                      record=True, **opts)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    count = collections.Counter() if tally else None
    start.record()
    with torch.no_grad():
        plain, plain_codes = BK.radiance_bvh_plain(
            sc, key, ids, px, py, record=True, tally=count, **opts)
    end.record()
    torch.cuda.synchronize()
    err = max(_bit_equal(f"{label}: #5's radiance", ker, plain),
              _bit_equal(f"{label}: the record variant's radiance", rec,
                         plain))
    if not torch.equal(codes, plain_codes):
        bad = (codes != plain_codes).any(dim=0)
        raise AssertionError(f"{label}: record codes differ from the plain "
                             f"walk's on {int(bad.sum())} of {n_rays} rays")
    del rec, plain, plain_codes
    return ker, codes, err, start.elapsed_time(end), count


def _fetch_check(label, sc, codes, seed: int) -> dict:
    """#6 against its plain version, bit for bit, and #7 against its plain
    version summed in float64, within FETCH_RTOL of the magnitudes each
    entry adds, on the winners of ``codes``.  Then their times, their
    plain versions', the library's gather of the first table's rows
    (``index_select``) and their bounds: the tables, the codes and the
    rows they move, once.  #7 has no library time: no one PyTorch call
    scatters every table's winners; the chain of calls that does (the
    winners' compaction and an ``index_add_`` a table) is its plain
    version."""
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import fetch as F

    args = (codes, *BK.fetch_inputs(sc))
    (kinds, tri_base, sph_mat, tri_mat, mats, sph_geo, tri_geo, raw, mv_base,
     mv_mat) = args[1:]
    rows, kind = F.fetch_rows_cuda(*args)
    p_rows, p_kind = F.fetch_rows_plain(*args)
    if not (torch.equal(rows.view(torch.int32), p_rows.view(torch.int32))
            and torch.equal(kind, p_kind)):
        raise AssertionError(f"{label}: #6 differs from its plain version "
                             f"in {int((rows != p_rows).sum())} of "
                             f"{rows.numel()} fields and "
                             f"{int((kind != p_kind).sum())} kinds")
    del p_rows, p_kind, kind
    dev = codes.device
    g_rows = torch.randn(tuple(rows.shape), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
    sizes = (kinds.shape[0], 0 if sph_geo is None else sph_geo.shape[0],
             0 if tri_geo is None else tri_geo.shape[0])
    targs = (codes, g_rows, tri_base, sph_mat, tri_mat, *sizes, raw, mv_base,
             mv_mat)
    # float32 sums of ~1e5 terms of both signs (the ground sphere, a few
    # materials) differ from the exact sum, in any order, by more than
    # 1e-5 of the result, so the bound is 1e-5 of the magnitudes added
    g64 = g_rows.double()
    exact = F.fetch_rows_transpose_plain(codes, g64, *targs[2:])
    scale = F.fetch_rows_transpose_plain(codes, g64.abs(), *targs[2:])
    err7 = p_err = 0.0
    for got, plain, want, mag in zip(
            F.fetch_rows_transpose_cuda(*targs),
            F.fetch_rows_transpose_plain(*targs), exact, scale):
        if want is None:
            continue
        e = (got.double() - want).abs()
        if bool((e > FETCH_RTOL * mag).any()):
            raise AssertionError(f"{label}: #7 differs from the exact sums "
                                 f"by up to {e.max().item():.3e}")
        err7 = max(err7, e.max().item())
        p_err = max(p_err, (plain.double() - want).abs().max().item())
    del g64, exact, scale

    ms = (_cuda_time_ms(lambda: F.fetch_rows_cuda(*args), 10),
          _cuda_time_ms(lambda: F.fetch_rows_transpose_cuda(*targs), 10))
    plain_ms = (_cuda_time_ms(lambda: F.fetch_rows_plain(*args), 2),
                _cuda_time_ms(lambda: F.fetch_rows_transpose_plain(*targs),
                              2))
    # the library: the first table's rows (its slots count from 0 in the
    # codes) and, unless raw, the material rows, gathered
    geo, mat = (sph_geo, sph_mat) if sph_geo is not None else (tri_geo,
                                                               tri_mat)
    flat = codes.reshape(-1)
    limit = tri_base if sph_geo is not None else BK.REC_SLOT + 1
    own = (flat >= 0) & ((flat & BK.REC_SLOT) < limit)
    slot = torch.where(own, flat & BK.REC_SLOT, 0).long()
    if raw:  # the raw material id instead of the material rows
        lib = (_cuda_time_ms(lambda: (geo.index_select(0, slot),
                                      mat.index_select(0, slot)), 10), None)
    else:
        mid = mat[slot].long()
        lib = (_cuda_time_ms(lambda: (geo.index_select(0, slot),
                                      mats.index_select(0, mid)), 10), None)

    n = codes.numel()
    valid = flat >= 0
    hits = int(valid.sum())
    slots = flat & BK.REC_SLOT
    n_mv = 0 if mv_base is None else int((valid & (slots >= mv_base)).sum())
    n_tri = int((valid & (slots >= tri_base)).sum()) - n_mv
    # a mesh volume's winner moves no geometry
    moved = (4 * (hits - n_tri - n_mv) + 12 * n_tri
             + (0 if raw else 8 * hits))
    table_bytes = sum(t.numel() * t.element_size() for t in (
        sph_mat, tri_mat, sph_geo, tri_geo, mv_mat,
        *(() if raw else (mats, kinds))) if t is not None)
    bounds = (
        # codes in; the rows and the kind out a code
        _bound(0, table_bytes + 4 * n + 4 * (rows.shape[0] + 1) * n),
        # codes and the winners' cotangents in, one add each
        _bound(2 * moved, 4 * n + 4 * moved + 4 * hits + table_bytes))
    return dict(err=(0.0, err7), plain_err=p_err, fields=rows.shape[0],
                ms=ms, plain=plain_ms, lib=lib, bounds=bounds)


def _bvh_grad_check(label, sc, key, n_pix: int, spp: int, width: int,
                    opts: dict, gen) -> tuple:
    """The packed tensors' gradient for numpy-seeded cotangents through
    the kernels (record #5, #6, the replay, #7) against autograd through
    the plain route, within GRAD_RTOL/GRAD_ATOL, finite, nonzero in the
    volumes' rows where there are volumes.  -> (max abs diff, the
    kernels' route's peak memory in GB)."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK

    cts = torch.tensor(gen.standard_normal((n_pix * spp, 3),
                                           dtype=np.float32),
                       device=sc.device)
    want = BK.radiance_grad_plain(sc, key, cts, n_pix, spp, width, **opts)
    torch.cuda.reset_peak_memory_stats()
    rows = [None if v is None else v.detach().requires_grad_(True)
            for v in BK._rows(sc)]
    rad = BK.radiance(sc.with_rows(*rows), key, n_pix, spp, width, **opts)
    got = torch.autograd.grad(rad, [v for v in rows if v is not None], cts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err = _grad_check(label, got, [v for v in want if v is not None])
    if sc.volumes is not None and got[-1].abs().sum() == 0:
        raise AssertionError(f"{label}: no gradient in the volumes' rows")
    return err, peak_gb


def _fd_probe(label, scene, dev, width: int, height: int, key, probe,
              gen, rows=None, engine=None) -> tuple:
    """A directional finite-difference probe of ``make_loss`` (on the
    route ``engine``, None for the dispatch's) along a numpy-seeded
    direction in the ``probe`` parameters (only in their rows
    ``rows[name]`` where given), against a target at 0.9 of the scene's own
    render: AD within 5% of the central difference.  -> (AD, FD)."""
    import torch

    from raytracingrust_tpu_torch.diff import grad as G
    from raytracingrust_tpu_torch.render.render import render_linear

    sc_dev = scene.to(dev)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.extract_params(sc_dev, probe).items()}
    v = {k: torch.tensor(gen.standard_normal(tuple(p.shape)),
                         dtype=torch.float32, device=dev)
         for k, p in params.items()}
    for k, at in (rows or {}).items():
        keep = torch.zeros_like(v[k])
        keep[at] = 1.0
        v[k] = v[k] * keep
    with torch.no_grad():
        target = render_linear(sc_dev, width, height, seed=12,
                               device=dev) * 0.9
    loss = G.make_loss(sc_dev, target, width, height, device=dev,
                       engine=engine)
    loss(params, key).backward()
    ad = sum((params[k].grad * v[k]).sum().item() for k in params)
    with torch.no_grad():
        fd = (loss({k: p + FD_EPS * v[k] for k, p in params.items()}, key)
              - loss({k: p - FD_EPS * v[k] for k, p in params.items()}, key)
              ).item() / (2 * FD_EPS)
    if not abs(ad - fd) <= 0.05 * max(abs(fd), 1e-6):
        raise AssertionError(f"{label}: FD probe AD {ad:.6e} vs FD {fd:.6e}")
    return ad, fd


def _fit_path(label, scene, sc, key, width: int, height: int, opts: dict,
              gen, probe, sky=None, probe_rows=None) -> dict:
    """The BVH fit path's kernels at ``sc``'s frame against their plain
    versions on the same inputs (:func:`_record_check`,
    :func:`_fetch_check`), the replay's forward within REPLAY_ATOL of
    #5's radiance, the gradient (:func:`_bvh_grad_check`) and the FD
    probe (:func:`_fd_probe`); then the record variant's time and bound
    from the plain walk's tally.  With a sky map ``sky`` (importance
    sampling off), the path of its fit: the record walk under a black
    uniform background, the replay with the sky on a miss held to #5's
    sky-map variant, the gradient in the sky's texels too
    (:func:`_env_grad_check` without MIS).  -> the numbers, the codes
    among them."""
    import torch

    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK

    spp = scene.settings.samples_per_pixel
    n_pix, n_rays = width * height, width * height * spp
    rec_opts = opts if sky is None else {**opts, "bg_kind": B.UNIFORM}
    ker, codes, err, plain_ms, tally = _record_check(
        label, sc, key, n_pix, spp, width, rec_opts)
    fetch = _fetch_check(label, sc, codes, 0)
    with torch.no_grad():
        rep = BK.replay(sc, codes, key, n_pix, spp, width, sky=sky, **opts)
        if sky is not None:
            ker = BK.radiance_bvh_cuda(sc, key, n_rays, spp, width, sky=sky,
                                       **opts)
    rep_err = (rep - ker).abs().max().item()
    if not rep_err <= REPLAY_ATOL:
        raise AssertionError(f"{label}: the replay's forward is "
                             f"{rep_err:.3e} from #5's radiance")
    del rep, ker
    if sky is None:
        g_err, peak_gb = _bvh_grad_check(label, sc, key, n_pix, spp, width,
                                         opts, gen)
    else:
        g_err, peak_gb = _env_grad_check(label, sc, sky, key, n_pix, spp,
                                         width, opts["max_depth"], gen,
                                         mis=False)
    ad, fd = _fd_probe(label, scene, sc.device, width, height, key, probe,
                       gen, probe_rows, engine="bvh")
    ms = _cuda_time_ms(lambda: BK.radiance_bvh_cuda(
        sc, key, n_rays, spp, width, record=True, **rec_opts), 5)
    ops = _bvh_ops(sc, tally, n_rays, rec_opts["bg_kind"], record=True)
    return dict(codes=codes, hits=int((codes >= 0).sum()), err=err,
                fetch=fetch, rep_err=rep_err, g_err=g_err, peak_gb=peak_gb,
                ad=ad, fd=fd, ms=ms, plain_ms=plain_ms, tally=tally,
                bound=_bound(ops, _scene_bytes(sc) + 12 * n_rays
                             + 4 * codes.numel()))


def _print_fit_path(phase: str, label: str, size: str, r: dict, probe,
                    extra: str = "") -> None:
    """The phase lines of :func:`_fit_path`'s numbers."""
    f, n_codes = r["fetch"], r["codes"].numel()
    b6, b7 = f["bounds"]
    print(f"{phase} {label} {size}: record radiance == #5 == plain bit for "
          f"bit, codes == plain codes on all {r['codes'].shape[1]} rays x "
          f"{r['codes'].shape[0]} bounces ({r['hits']} hits{extra}); #6 == "
          f"plain bit for bit ({f['fields']} fields); #7 max abs diff from "
          f"the float64 sums {f['err'][1]:.3e} (float32 index_add_ "
          f"{f['plain_err']:.3e}; allowed {FETCH_RTOL:g} of the magnitudes "
          f"added); replay forward vs #5 max abs diff {r['rep_err']:.3e} "
          f"(allowed {REPLAY_ATOL:g}); gradient vs plain route max abs diff "
          f"{r['g_err']:.3e} (allowed {GRAD_RTOL:g} rel + {GRAD_ATOL:g} of "
          f"max), finite; peak memory of the backward {r['peak_gb']:.2f} "
          f"GB; FD probe ({', '.join(probe)}; eps {FD_EPS:g}, rtol 5%): AD "
          f"{r['ad']:.6e}, FD {r['fd']:.6e}")
    print(f"{phase} {label} times: record #5 {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.1f} ms, bound {r['bound'][0]:.5f} ms "
          f"{r['bound'][1]}); #6 {f['ms'][0]:.4f} ms (plain "
          f"{f['plain'][0]:.3f}, index_select {f['lib'][0]:.4f}, bound "
          f"{b6[0]:.5f} {b6[1]}); #7 {f['ms'][1]:.4f} ms (plain "
          f"{f['plain'][1]:.3f}, the chain of index_add_ a table, bound "
          f"{b7[0]:.5f} {b7[1]}); {r['hits']} hits of {n_codes} codes")


def _fit_entries(r: dict, launches: dict, suffix: str = "") -> list:
    """The report entries of the record variant of #5, #6 and #7."""
    f = r["fetch"]
    return [
        _entry("bvh_record" + suffix, "bvh_forward.cu", "3001",
               launches["record"], r["err"], r["ms"], r["plain_ms"],
               r["bound"]),
        _entry("fetch_rows" + suffix, "fetch_rows.cu", "3179",
               launches["fetch"], f["err"][0], f["ms"][0], f["plain"][0],
               f["bounds"][0], f["lib"][0]),
        _entry("fetch_rows_transpose" + suffix, "fetch_rows.cu", "3179",
               launches["transpose"], f["err"][1], f["ms"][1], f["plain"][1],
               f["bounds"][1], f["lib"][1]),
    ]


def _check_png(path: str, width: int, height: int, label: str) -> None:
    """Raises unless the PNG at ``path`` has the frame's shape and is not
    flat."""
    from raytracingrust_tpu_torch.io.png import read_png

    png = read_png(path)
    if (png.shape != (height, width, 4)
            or png[..., :3].min() == png[..., :3].max()):
        raise AssertionError(f"{label}: PNG {png.shape} is flat or "
                             f"misshapen")


def _warm_render(scene, width: int, height: int, dev, label: str,
                 engine=None) -> tuple:
    """(best wall of three renders in s, the image's mean) on the route
    ``engine`` (None for the dispatch's); the image must be finite and not
    flat."""
    import torch

    from raytracingrust_tpu_torch.render.render import render_linear

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = render_linear(scene, width, height, seed=0, device=dev,
                            engine=engine)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(img).all()) or img.std().item() == 0.0:
        raise AssertionError(f"{label}: image not finite or flat")
    return min(times), img.mean().item()


def _profile(run, steps: int) -> dict:
    """Device ms a call by part: ``run(step)``, which calls ``step()``
    after each of its calls (a render, a fit step), under torch.profiler,
    one call of warm-up and then ``steps`` recorded.  The kernels by name;
    "replay and rest" is the other kernels' time (the replay's elementwise
    kernels, the clamp, the mean, Adam's); the replay's halves and Adam by
    their ranges where a fit step names them (user annotations span their
    kernels on the device; #6 runs inside the replay's forward, #7 inside
    its backward).  The device events are read as the profiler recorded
    them: ``key_averages`` first builds an event tree of every host op,
    seconds of Python for the thousands of ops of a BVH fit step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        run(prof.step)
    part = collections.Counter()
    ranges = collections.Counter()
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.duration_ns() / 1e6 / steps
        key = evt.name()
        if evt.is_user_annotation():
            ranges[key] += ms
            continue
        if "bvh_radiance_kernel" in key:
            record = "<true" in key or "ILb1E" in key
            part["record #5" if record else "#5"] += ms
        elif "fetch_kernel" in key:
            part["#6"] += ms
        elif "transpose_kernel" in key:
            part["#7"] += ms
        elif "occlusion_kernel" in key:
            part["#8"] += ms
        elif "mse_kernel" in key:
            part["#4"] += ms
        elif "grad_kernel" in key:
            part["#3"] += ms
        elif "radiance_kernel" in key:
            part["#1"] += ms
        else:
            part["replay and rest"] += ms
        part["busy"] += ms
    if "bvh_replay_forward" in ranges:
        part["replay forward"] = ranges["bvh_replay_forward"] - part["#6"]
        part["replay backward"] = ranges["bvh_replay_backward"] - part["#7"]
        part["Adam"] = sum(v for k, v in ranges.items() if "Adam" in k)
    return part


def _parts(part: dict, keys) -> str:
    """A :func:`_profile` breakdown's ``keys``, for the phase lines."""
    return ", ".join(f"{k} {part[k]:.3f} ms" for k in keys)


def _warm_fit(scene, target, names, width: int, height: int, dev,
              **fit_kw) -> dict:
    """Five steps of ``fit``: the first step's and the median warm step's
    ms, the peak memory, the loss history (finite, as the parameters);
    then three more under :func:`_profile`."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.diff.inverse import fit

    ticks = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, params, history = fit(scene, target, names, width, height, steps=5,
                             device=dev, callback=lambda *_: ticks.append(
                                 time.perf_counter()), **fit_kw)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = sorted(b - a for a, b in zip(ticks[1:], ticks[2:]))
    if not all(np.isfinite(history)) or not all(
            bool(torch.isfinite(p).all()) for p in params.values()):
        raise AssertionError(f"a warm fit is not finite: {history}")
    part = _profile(lambda step: fit(
        scene, target, names, width, height, steps=3, device=dev,
        callback=lambda *_: step(), **fit_kw), 2)
    return dict(first_ms=(ticks[0] - t0) * 1e3,
                warm_ms=step_s[len(step_s) // 2] * 1e3, n=len(step_s),
                peak_gb=peak_gb, history=history, part=part)


def _cli_fit(path: str, target_png: str, flags=()) -> tuple:
    """The CLI ``fit`` of ``path`` against ``target_png``, CLI_FIT_STEPS
    steps of CLI_FIT_PARAMS from seed 0, whose loss must be finite and
    fall.  -> (the launches, the first and the final loss, its output)."""
    import numpy as np

    from raytracingrust_tpu_torch import cli

    _reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit", path, target_png, *flags, "--params",
                       CLI_FIT_PARAMS, "--steps", str(CLI_FIT_STEPS),
                       "--seed", "0"])
    text = buf.getvalue()
    launches = _launches()
    if rc != 0:
        raise AssertionError(f"cli fit {path} returned {rc}\n{text}")
    first = float(text.split("step 0: loss")[1].split()[0])
    final = float(text.split("final loss")[1].split()[0])
    if not (np.isfinite(first) and np.isfinite(final) and final < first):
        raise AssertionError(f"cli fit {path}: loss {first} -> {final}"
                             f"\n{text}")
    return launches, first, final, text


def _cli_render(path: str, png: str, flags=(), seed: int = 0) -> None:
    """The CLI ``render`` of ``path`` to ``png``; raises if it fails."""
    from raytracingrust_tpu_torch import cli

    if cli.main(["render", path, *flags, "-o", png, "--seed",
                 str(seed)]) != 0:
        raise AssertionError(f"cli render {path} failed")


def bvh_phase(dev, card: str) -> dict:
    """Phase 7; -> kernel #5's entry of the kernel report."""
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.render.render import select_engine
    from raytracingrust_tpu_torch.utils import rng

    regs = _ptxas("bvh_forward")
    shapes = bvh_scenes()
    key = rng.base_key(11)
    out = {}
    for label, path, w, h, _ in shapes:
        scene = SceneBuilder.from_file(path).build()
        if select_engine(scene) != "bvh":
            raise AssertionError(f"{label}: not sent to the BVH kernel")
        s = scene.settings
        spp, depth = s.samples_per_pixel, s.max_ray_depth
        sc = BK.pack(scene, w, h, dev)
        n_rays = w * h * spp
        opts = dict(max_depth=depth, bg_kind=scene.background.kind,
                    clay=False)
        out[label] = r = _forward_check(label, sc, key, w * h, spp, w, opts)
        print(f"phase 7 {label} {w}x{h} spp {spp} depth {depth} "
              f"({len(scene.spheres)} spheres, {len(scene.triangles)} "
              f"triangles): per-ray radiance bit for bit equal at depth 1 "
              f"and depth {depth} on all {n_rays} rays; per ray "
              f"{_per_ray(r['tally'], n_rays)}; kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.2f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}; {r['ops']:.4g} FP32 operations)")

    # the main path, through the CLI entry
    _reset_launches()
    for label, path, *_, flags in shapes:
        _cli_render(path, os.path.join(OUT_DIR, label + ".png"), flags)
    launches = _launches()
    if launches["fwd"] < len(shapes) or launches["brute"] != 0:
        raise AssertionError(f"the CLI renders launched {launches}, expected "
                             f"{len(shapes)} of #5 and none of #1")
    for label, path, w, h, _ in shapes:
        _check_png(os.path.join(OUT_DIR, label + ".png"), w, h, label)
        scene = SceneBuilder.from_file(path).build()
        best, mean = _warm_render(scene, w, h, dev, label)
        spp = scene.settings.samples_per_pixel
        print(f"phase 7 {label} {w}x{h} spp {spp}: warm render {best:.4f} s,"
              f" {w * h * spp / best / 1e6:.1f} primary Mrays/s (kernel #5), "
              f"image mean {mean:.5f}")
    print(f"phase 7 CLI renders: {launches['fwd']} launches of kernel #5, "
          f"{launches['brute']} of #1; {card}; ptxas: {regs}")
    main = out["bvh_stress"]
    return _entry("bvh_forward", "bvh_forward.cu", "3001", launches["fwd"],
                  max(o["err"] for o in out.values()), main["ms"],
                  main["plain_ms"], main["bound"])


# phase 8: the fitted shapes, their parameters and the CLI fit's
FIT_SHAPES = (("bvh_stress", 1000, 1000,
               "albedo,emission,bg_color_a,bg_color_b,sphere_center,"
               "sphere_radius,cam_lookfrom"),
              ("sheet64", 512, 512, "albedo,emission,bg_color_a,"
                                    "sphere_center"))
CLI_FIT_PARAMS = "albedo,emission"
CLI_FIT_STEPS = 6
# #7 vs its plain version in float64: of the sum of the magnitudes added
FETCH_RTOL = 1e-5
REPLAY_ATOL = 1e-4  # the replay's forward vs the kernel's radiance
FD_EPS = 1e-3


def bvh_fit_phase(dev, card: str) -> list:
    """Phase 8; -> the report entries of the record variant of #5, #6 and
    #7."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.utils import rng

    paths = {label: path for label, path, *_ in bvh_scenes()}
    key = rng.base_key(11)
    gen = np.random.default_rng(0)
    probe = ["albedo", "emission", "bg_color_a"]
    out = {}
    for label, w, h, names in FIT_SHAPES:
        scene = SceneBuilder.from_file(paths[label]).build()
        s = scene.settings
        opts = dict(max_depth=s.max_ray_depth,
                    bg_kind=scene.background.kind, clay=False)
        with torch.no_grad():
            sc = BK.pack(scene, w, h, dev)
        out[label] = r = _fit_path(label, scene, sc, key, w, h, opts, gen,
                                   probe)
        _print_fit_path("phase 8", label, f"{w}x{h} spp "
                        f"{s.samples_per_pixel} depth {s.max_ray_depth}", r,
                        probe)
        del r["codes"], sc

    # the main path: CLI fit of bvh_stress against a CLI-rendered target
    dim = _write_scene(STRESS, "bvh_stress_dim.json", dim=True)
    target_png = os.path.join(OUT_DIR, "bvh_fit_target.png")
    _cli_render(dim, target_png, seed=1)
    steps = CLI_FIT_STEPS
    counts, first, final, text = _cli_fit(
        STRESS, target_png, ["-o", os.path.join(OUT_DIR,
                                                "bvh_fit_result.png")])
    got = tuple(counts[k] for k in ("record", "fetch", "transpose", "fwd",
                                    "brute"))
    if got != (steps, steps, steps, 1, 0):
        raise AssertionError(f"cli fit launches (record, #6, #7, #5, #1) "
                             f"{got}, expected ({steps}, {steps}, {steps}, "
                             f"1, 0)\n{text}")
    print(f"phase 8 cli fit {STRESS} 1000x1000 spp 8 depth 4, {steps} "
          f"steps of {CLI_FIT_PARAMS}: loss {first:.6f} -> {final:.6f}; "
          f"launches record {got[0]}, #6 {got[1]}, #7 {got[2]}, #5 {got[3]} "
          f"(the fitted render)")

    # the warm fit step of each shape, and where its time goes
    for label, w, h, names in FIT_SHAPES:
        scene = SceneBuilder.from_file(paths[label]).build()
        spp = scene.settings.samples_per_pixel
        target = (read_png(target_png)[..., :3].astype(np.float32) / 255.0
                  ) ** 2 if label == "bvh_stress" else np.full(
            (h, w, 3), 0.25, np.float32)
        r = _warm_fit(scene, target, names.split(","), w, h, dev)
        print(f"phase 8 {label} fit step ({names}): first step "
              f"{r['first_ms']:.1f} ms, warm step {r['warm_ms']:.3f} ms "
              f"(median of {r['n']}), "
              f"{w * h * spp / r['warm_ms'] / 1e3:.1f} primary Mrays/s "
              f"fwd+bwd, peak memory {r['peak_gb']:.2f} GB; loss "
              f"{r['history'][0]:.6f} -> {r['history'][-1]:.6f}; per step "
              f"under torch.profiler: " + _parts(r["part"], (
                  "record #5", "#6", "replay forward", "replay backward",
                  "#7", "Adam", "replay and rest", "busy"))
              + f", host (warm step - busy) "
              f"{r['warm_ms'] - r['part']['busy']:.3f} ms; {card}")
    return _fit_entries(out["bvh_stress"], counts)


# phase 9: the HDRI importance-sampling path
SKY = os.path.join(OUT_DIR, "sky2k.exr")
# csrc/occlusion.cu, counted from its source: per shadow ray a = d.d and
# the three reciprocals; node visits and leaf tests as #5's
OPS_OCC_RAY = 8
BYTES_OCC_RAY = 25  # origin and direction in, one byte out
BYTES_OCC_VOL_RAY = 29  # with volumes #8 also reads each ray's id
ENV_CLI_FIT_SIZE = 512  # the CLI fit's frame
ENV_FIT_SIZE = 1000  # the timed fit step's frame


def procedural_sky(path: str, h: int = 1024, w: int = 2048,
                   seed: int = 0) -> None:
    """A 2K equirect HDRI, the size of a studio HDRI, written with the
    port's EXR writer: a smooth sky from a bright horizon to a blue zenith
    over a dim ground, seeded noise of 3%, and a sun of 3x4 texels at
    radiance 4,000, far above the scenes' clamp of 10.  Row 0 faces the
    zenith (the lookup's y flip)."""
    import numpy as np

    from raytracingrust_tpu_torch.io.exr import write_exr

    r = np.arange(h, dtype=np.float32)
    up = -np.cos((h - r - 0.5) / h * np.pi)  # the rows' elevation sines
    horizon = np.asarray([1.2, 1.14, 1.08], np.float32)
    zenith = np.asarray([0.2, 0.36, 0.72], np.float32)
    ground = np.asarray([0.15, 0.125, 0.1], np.float32)
    e = np.clip(up, 0.0, 1.0)[:, None]
    row = np.where(up[:, None] > 0, horizon * (1 - e) + zenith * e, ground)
    img = row[:, None, :] * np.random.default_rng(seed).uniform(
        0.97, 1.03, (h, w, 3)).astype(np.float32)
    sun = int(h - 1 - np.arccos(-np.sin(np.radians(40.0))) / np.pi * h)
    img[sun:sun + 3, int(0.3 * w):int(0.3 * w) + 4] = 4000.0
    write_exr(path, img.astype(np.float32))


def env_scenes() -> list:
    """Phase 9's shapes: (label, scene JSON, width, height, CLI flags), the
    JSONs written beside the sky: scenes/bvh_stress.json and phase 7's
    sheet64, each under the sky with importance sampling on."""
    procedural_sky(SKY)
    return [(f"sky_{label}", _write_scene(path, f"sky_{label}.json",
                                          sky=True), w, h, flags)
            for label, path, w, h, flags in bvh_scenes()
            if label != "grid8k"]


def _shadow_rays(sc, sky, key, n_pix, spp, w, depth):
    """(plain route's per-ray radiance, the shadow rays of each bounce of
    its replay): the plain record walk, fetch and occlusion test."""
    import torch

    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.ops import occlusion as OC

    rays = []

    def occlude(o, d, ids, stream):
        rays.append((o, d, ids, stream))
        return OC.occluded_plain(sc, o, d, ids, key, stream)

    ids, px, py = K.prep_rays(torch.arange(n_pix, device=sc.device), spp, w)
    with torch.no_grad():
        _, codes = BK.radiance_bvh_plain(sc, key, ids, px, py,
                                         max_depth=depth, bg_kind=B.UNIFORM,
                                         clay=False, record=True)
        rad = BK.replay(sc, codes, key, n_pix, spp, w, max_depth=depth,
                        bg_kind=B.SKYMAP, clay=False, plain=True, sky=sky,
                        occlude=occlude)
    return rad, rays


def _env_route_check(label, sc, sky, key, n_pix: int, spp: int, width: int,
                     depth: int) -> dict:
    """The env path at ``sc``'s frame: #8 against its plain version on
    every shadow ray of every bounce of the plain route's replay, some
    blocked and some not (with volumes, counting those the solid trees
    leave open); #8's time a render over its launches, its plain
    version's and its bound from the plain version's tally; the env
    radiance through the kernels against the plain route, bit for bit,
    finite."""
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import occlusion as OC

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain, rays = _shadow_rays(sc, sky, key, n_pix, spp, width, depth)
    end.record()
    torch.cuda.synchronize()
    route_ms = start.elapsed_time(end)
    solid = sc._replace(volumes=None)
    tally = collections.Counter()
    n_shadow = n_blocked = n_fog = 0
    ms, plain_ms, per_launch = [], 0.0, []
    for o, d, ids, stream in rays:
        got = OC.occluded_cuda(sc, o, d, ids, key, stream)
        want = OC.occluded_plain(sc, o, d, ids, key, stream, tally=tally)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{label}: #8 differs from its plain version on "
                f"{int((got != want).sum())} of {got.numel()} shadow rays")
        n_shadow += got.numel()
        n_blocked += int(got.sum())
        if sc.volumes is not None:
            n_fog += int((got & ~OC.occluded_plain(solid, o, d)).sum())
        per_launch.append(got.numel())
        ms.append(_cuda_time_ms(
            lambda: OC.occluded_cuda(sc, o, d, ids, key, stream), 5))
        plain_ms += _cuda_time_ms(lambda: OC.occluded_plain(
            sc, o, d, ids, key, stream), 1)
    if not rays or not 0 < n_blocked < n_shadow:
        raise AssertionError(f"{label}: {n_shadow} shadow rays, {n_blocked} "
                             f"blocked")
    vol = sc.volumes is not None
    ops = (n_shadow * (OPS_OCC_RAY + (1 if vol else 0))
           + tally["nodes"] * OPS_NODE
           + tally["sphere_tests"] * OPS_SPHERE_TEST
           + tally["volume_tests"] * OPS_VOL_TEST
           + tally["volume_draws"] * OPS_VOL_DRAW
           + tally["triangle_tests"] * OPS_TRI_TEST)
    tree_bytes = sum(t.numel() * t.element_size() for tree in (
        sc.spheres, sc.volumes, sc.triangles) if tree is not None
        for t in (tree.nodes_f, tree.nodes_i, tree.chunk_len, tree.geo,
                  tree.nid, tree.ordinal) if t is not None)
    bound = _bound(ops, (BYTES_OCC_VOL_RAY if vol else BYTES_OCC_RAY)
                   * n_shadow + tree_bytes)
    with torch.no_grad():
        ker = BK.env_radiance(sc, sky, key, n_pix, spp, width,
                              max_depth=depth)
    err = _bit_equal(f"{label}: the env radiance through the kernels", ker,
                     plain)
    if not bool(torch.isfinite(ker).all()):
        raise AssertionError(f"{label}: env radiance not finite")
    return dict(ms=sum(ms), ms_launch=ms, per_launch=per_launch,
                plain_ms=plain_ms, bound=bound, n_shadow=n_shadow,
                n_blocked=n_blocked, n_fog=n_fog, tally=tally, err=err,
                route_ms=route_ms, n_rays=n_pix * spp)


def _print_env_route(phase: str, label: str, size: str, r: dict,
                     card: str) -> None:
    """The phase lines of :func:`_env_route_check`'s numbers."""
    t, n = r["tally"], r["n_shadow"]
    fog = (f", {r['n_fog']} of them by the volumes alone, their free "
           f"flight drawn from the NEE stream" if r["n_fog"] else "")
    print(f"{phase} {label} {size}: #8 == plain bit for bit on all {n} "
          f"shadow rays "
          f"({r['n_blocked']} blocked{fog}) of the plain route's replay; "
          f"env radiance through record #5, #6 and #8 == the plain route "
          f"bit for bit (max abs diff {r['err']:.1e}) on all {r['n_rays']} "
          f"rays")
    print(f"{phase} {label} #8: {r['ms']:.4f} ms a render over its "
          f"{len(r['ms_launch'])} launches ("
          + ", ".join(f"{x:.4f}" for x in r["ms_launch"]) + " ms; "
          f"{r['per_launch']} shadow rays); plain {r['plain_ms']:.2f} ms; "
          f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}; per shadow ray "
          f"{t['nodes'] / n:.2f} node visits, {t['sphere_tests'] / n:.1f} "
          f"sphere, {t['volume_tests'] / n:.3f} volume and "
          f"{t['triangle_tests'] / n:.1f} triangle tests); the plain "
          f"route's render {r['route_ms']:.1f} ms; {card}")


def _env_grad_check(label, sc, sky, key, n_pix: int, spp: int, width: int,
                    depth: int, gen, mis: bool = True) -> tuple:
    """The gradient in the packed tensors and the sky's texels through the
    kernels against the plain route for numpy-seeded cotangents, within
    GRAD_RTOL/GRAD_ATOL, finite, nonzero in the materials and the sky
    (without ``mis``, the sky on a miss at weight 1: no term depends
    smoothly on the camera, whose gradient is then none on both routes);
    -> (the max abs diff, the kernels' route's peak memory in GB)."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK

    cts = torch.tensor(gen.standard_normal((n_pix * spp, 3),
                                           dtype=np.float32),
                       device=sc.device)
    grads = []
    torch.cuda.reset_peak_memory_stats()
    for plain in (False, True):
        rows = [None if v is None else v.detach().requires_grad_(True)
                for v in BK._rows(sc)]
        img = sky.image.detach().requires_grad_(True)
        live = [v for v in rows if v is not None] + [img]
        rad = BK.env_radiance(sc.with_rows(*rows),
                              dataclasses.replace(sky, image=img), key,
                              n_pix, spp, width, max_depth=depth,
                              plain=plain, mis=mis)
        grads.append(torch.autograd.grad(rad, live, cts, allow_unused=True))
        del rad
        if not plain:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if [g is None for g in grads[0]] != [g is None for g in grads[1]]:
        raise AssertionError(f"{label}: the routes differ in which tensors "
                             f"have a gradient")
    got, want = ([g for g in gs if g is not None] for gs in grads)
    err = _grad_check(label, got, want)
    if grads[0][1].abs().sum() == 0 or grads[0][-1].abs().sum() == 0:
        raise AssertionError(f"{label}: no material or sky gradient")
    return err, peak_gb


def env_phase(dev, card: str) -> dict:
    """Phase 9; -> kernel #8's entry of the kernel report."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.render.render import (render_linear,
                                                        select_engine)
    from raytracingrust_tpu_torch.utils import rng

    regs = _ptxas("occlusion")
    t0 = time.perf_counter()
    shapes = env_scenes()
    write_s = time.perf_counter() - t0
    key = rng.base_key(11)
    gen = np.random.default_rng(9)
    out = {}
    for label, path, w, h, _ in shapes:
        t0 = time.perf_counter()
        scene = SceneBuilder.from_file(path).build()
        load_s = time.perf_counter() - t0
        if select_engine(scene) != "env":
            raise AssertionError(f"{label}: not sent to the env path")
        s = scene.settings
        spp, depth = s.samples_per_pixel, s.max_ray_depth
        with torch.no_grad():
            sc = BK.pack(scene, w, h, dev)
        sky = scene.to(dev).background
        out[label] = r = _env_route_check(label, sc, sky, key, w * h, spp, w,
                                          depth)

        # the gradient through the kernels against the plain route, and an
        # FD probe of make_loss on albedo, at 64x48
        gw, gh = 64, 48
        with torch.no_grad():
            gsc = BK.pack(scene, gw, gh, dev)
        g_err, _ = _env_grad_check(label, gsc, sky, key, gw * gh, spp, gw,
                                   depth, gen)
        ad, fd = _fd_probe(label, scene, dev, gw, gh, key, ["albedo"], gen)
        _print_env_route("phase 9", label, f"{w}x{h} spp {spp} depth "
                         f"{depth} ({len(scene.spheres)} spheres, "
                         f"{len(scene.triangles)} triangles; sky "
                         f"{tuple(sky.image.shape)}, loaded in {load_s:.2f} "
                         f"s)", r, card)
        print(f"phase 9 {label} gradient at {gw}x{gh} vs the plain route "
              f"max abs diff {g_err:.3e} (allowed {GRAD_RTOL:g} rel + "
              f"{GRAD_ATOL:g} of max), finite; FD probe (albedo, eps "
              f"{FD_EPS:g}, rtol 5%): AD {ad:.6e}, FD {fd:.6e}; ptxas: "
              f"{regs}")

    # the main path: CLI renders of both scenes, then the CLI fit
    _reset_launches()
    for label, path, *_, flags in shapes:
        _cli_render(path, os.path.join(OUT_DIR, label + ".png"),
                    ["--env-is", *flags])
    counts = _launches()
    depths = [SceneBuilder.from_file(p).settings.max_ray_depth
              for _, p, *_ in shapes]
    if ((counts["record"], counts["fetch"]) != (len(shapes),) * 2
            or not 0 < counts["occlusion"] <= sum(depths)
            or counts["fwd"] or counts["brute"] or counts["transpose"]):
        raise AssertionError(f"the CLI renders launched {counts}")
    for label, path, w, h, _ in shapes:
        _check_png(os.path.join(OUT_DIR, label + ".png"), w, h, label)
        scene = SceneBuilder.from_file(path).build()
        spp = scene.settings.samples_per_pixel
        best, mean = _warm_render(scene, w, h, dev, label)

        def renders(step, scene=scene, w=w, h=h):
            for _ in range(3):
                render_linear(scene, w, h, seed=0, device=dev)
                torch.cuda.synchronize()
                step()

        part = _profile(renders, 2)
        print(f"phase 9 {label} {w}x{h} spp {spp}: warm render {best:.4f} s,"
              f" {w * h * spp / best / 1e6:.1f} primary Mrays/s, image mean "
              f"{mean:.5f}; per render under torch.profiler: "
              + _parts(part, ("record #5", "#6", "#8", "replay and rest",
                              "busy"))
              + f", host (warm render - busy) {best * 1e3 - part['busy']:.3f}"
              f" ms")
    print(f"phase 9 CLI renders: launches record #5 {counts['record']}, #6 "
          f"{counts['fetch']}, #8 {counts['occlusion']} (of {sum(depths)} "
          f"bounces), #5 {counts['fwd']}, #1 {counts['brute']}")

    stress, label = shapes[0][1], shapes[0][0]
    dim = _write_scene(stress, "sky_bvh_stress_dim.json", dim=True)
    target_png = os.path.join(OUT_DIR, "env_fit_target.png")
    size = str(ENV_CLI_FIT_SIZE)
    _cli_render(dim, target_png, ["--env-is", "--width", size, "--height",
                                  size], seed=1)
    steps, depth = CLI_FIT_STEPS, depths[0]
    fit_counts, first, final, text = _cli_fit(stress, target_png,
                                              ["--env-is"])
    if ((fit_counts["record"], fit_counts["fetch"], fit_counts["transpose"])
            != (steps,) * 3
            or not steps <= fit_counts["occlusion"] <= steps * depth
            or fit_counts["fwd"] or fit_counts["brute"]):
        raise AssertionError(f"cli fit launches {fit_counts}\n{text}")
    print(f"phase 9 cli fit {stress} --env-is {size}x{size} depth {depth}, "
          f"{steps} steps of {CLI_FIT_PARAMS}: loss {first:.6f} -> "
          f"{final:.6f}; launches record {fit_counts['record']}, #6 "
          f"{fit_counts['fetch']}, #7 {fit_counts['transpose']}, #8 "
          f"{fit_counts['occlusion']} (of {steps * depth} bounces)")

    # the warm fit step at sky_bvh_stress 1000x1000, and where its time goes
    w = h = ENV_FIT_SIZE
    scene = SceneBuilder.from_file(stress).build()
    spp = scene.settings.samples_per_pixel
    with torch.no_grad():
        target = render_linear(SceneBuilder.from_file(dim).build(), w, h,
                               seed=1, device=dev)
    r = _warm_fit(scene, target, CLI_FIT_PARAMS.split(","), w, h, dev)
    print(f"phase 9 {label} {w}x{h} fit step ({CLI_FIT_PARAMS}): first step "
          f"{r['first_ms']:.1f} ms, warm step {r['warm_ms']:.3f} ms (median "
          f"of {r['n']}), {w * h * spp / r['warm_ms'] / 1e3:.1f} primary "
          f"Mrays/s fwd+bwd; peak memory {r['peak_gb']:.2f} GB; per step "
          f"under torch.profiler: " + _parts(r["part"], (
              "record #5", "#6", "#8", "#7", "replay and rest", "busy"))
          + f", host (warm step - busy) "
          f"{r['warm_ms'] - r['part']['busy']:.3f} ms; writing the sky and "
          f"scenes {write_s:.2f} s; {card}")

    main = out[shapes[0][0]]  # a render's launches at sky_bvh_stress
    # no PyTorch call computes a BVH any-hit: no library time
    return _entry("occlusion", "occlusion.cu", "3591", counts["occlusion"],
                  main["err"], main["ms"], main["plain_ms"], main["bound"])


# phase 10: volumes, isotropic materials and mixes (the material zoo)
ZOO = "scenes/material_zoo.json"
ZOO_RENDER = (1200, 800)  # the scene's own spp 32 and depth 8, its aspect
ZOO_FIT = (600, 400, 16)  # width, height, spp; depth 8
ZOO_FIT_PARAMS = "albedo,emission,sphere_center,sphere_radius"
# the warm zoo fit holds the sphere centers and radii within this of
# their start (fit's constraints): the replay's gradient holds visibility
# fixed, Adam moves every coordinate by about its learning rate a step
# whatever the gradient's size, and the 40 spheres of radius 0.12, moved
# so, change which paths hit them and the loss rises
ZOO_FIT_GEO = 1e-3
C1_SHAPE = (256, 256, 8)  # cornell at depth 13
C1_DEPTH = 13


def zoo_phase(dev, card: str) -> tuple:
    """Phase 10; -> (the report entries of #5, its record variant, #6, #7
    and #8 on the zoo and sky_zoo, #5's zoo times for phase 13).  The
    dispatch sends the zoo to the brute kernels (phase 13); #5's route is
    driven here by name (``engine="bvh"``)."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.diff import grad as G
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models import materials as M
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.render.render import (render_linear,
                                                        select_engine)
    from raytracingrust_tpu_torch.utils import rng

    if not os.path.exists(SKY):
        procedural_sky(SKY)
    zoo = ZOO
    sky_zoo = _write_scene(ZOO, "sky_zoo.json", sky=True,
                           samples_per_pixel=ZOO_FIT[2])
    key = rng.base_key(11)
    gen = np.random.default_rng(10)
    depth = 8

    # ---- #5 at the zoo's render shape
    rw, rh = ZOO_RENDER
    scene = _load(zoo)
    if select_engine(scene) != "brute":
        raise AssertionError("the zoo is not sent to the brute kernels")
    r_spp = scene.settings.samples_per_pixel
    r_rays = rw * rh * r_spp
    opts = dict(max_depth=depth, bg_kind=scene.background.kind, clay=False)
    with torch.no_grad():
        sc = BK.pack(scene, rw, rh, dev)
    fwd = _forward_check("zoo", sc, key, rw * rh, r_spp, rw, opts)
    print(f"phase 10 zoo {rw}x{rh} spp {r_spp} depth {depth} "
          f"({len(scene.spheres)} spheres, {scene.spheres.num_volumes} "
          f"volume, mixes, isotropic): #5 radiance == plain bit for bit at "
          f"depth 1 and depth {depth} on all {r_rays} rays; per ray "
          f"{_per_ray(fwd['tally'], r_rays)}; hits by kind "
          f"{[fwd['tally'][f'hits_{k}'] for k in range(5)]}; #5 "
          f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.1f} ms, bound "
          f"{fwd['bound'][0]:.5f} ms ({fwd['bound'][1]}; {fwd['ops']:.4g} "
          f"FP32 operations)")
    del sc

    # ---- the fit path at the fit shape
    fw, fh, f_spp = ZOO_FIT
    f_rays = fw * fh * f_spp
    scene = _load(zoo, spp=f_spp)
    with torch.no_grad():
        sc = BK.pack(scene, fw, fh, dev)
    probe = ["albedo", "emission"]
    fp = _fit_path("zoo", scene, sc, key, fw, fh, opts, gen, probe)
    codes = fp["codes"]
    hit, slot = codes >= 0, codes & BK.REC_SLOT
    fog_hits = int((hit & (slot >= sc.vol_base)).sum())
    mix_slots = (sc.spheres.mat == int(
        (scene.materials.kind == M.MIX).nonzero()[0])).nonzero().squeeze(1)
    mix_hits = int((hit & torch.isin(slot, mix_slots)).sum())
    if fog_hits == 0 or mix_hits == 0:
        raise AssertionError(f"zoo: {fog_hits} fog hits, {mix_hits} mix "
                             f"hits")
    _print_fit_path("phase 10", "zoo", f"{fw}x{fh} spp {f_spp} depth "
                    f"{depth} (the fit shape; #6 raw)", fp, probe,
                    f", {fog_hits} in the fog, {mix_hits} on the mix")
    del fp["codes"], codes, hit, slot, sc

    # ---- the env path at the fit shape: #8 through the fog
    sky_scene = _load(sky_zoo)
    if select_engine(sky_scene) != "env":
        raise AssertionError("sky_zoo is not sent to the env path")
    with torch.no_grad():
        ssc = BK.pack(sky_scene, fw, fh, dev)
    sky = sky_scene.to(dev).background
    env = _env_route_check("sky_zoo", ssc, sky, key, fw * fh, f_spp, fw,
                           depth)
    if env["n_fog"] == 0:
        raise AssertionError("sky_zoo: no shadow ray blocked by the fog")
    s_err, _ = _env_grad_check("sky_zoo", ssc, sky, key, fw * fh, f_spp, fw,
                               depth, gen)
    _print_env_route("phase 10", "sky_zoo", f"{fw}x{fh} spp {f_spp} depth "
                     f"{depth}", env, card)
    print(f"phase 10 sky_zoo gradient (packed tensors and the sky's "
          f"texels) vs the plain route max abs diff {s_err:.3e} (allowed "
          f"{GRAD_RTOL:g} rel + {GRAD_ATOL:g} of max), finite")
    del ssc

    # ---- C1: the depth-13 cornell fit takes the record walk and replay
    cw, ch, c_spp = C1_SHAPE
    cornell = _load(CORNELL, spp=c_spp, depth=C1_DEPTH)
    c_opts = dict(max_depth=C1_DEPTH, bg_kind=cornell.background.kind,
                  clay=cornell.settings.mode == "Clay")
    with torch.no_grad():
        csc = BK.pack(cornell, cw, ch, dev)
    _, c_codes, _, c_plain_ms, _ = _record_check(
        "C1 cornell", csc, key, cw * ch, c_spp, cw, c_opts, tally=False)
    deep = int((c_codes[12:] >= 0).sum())  # hits past the brute tape
    del csc, c_codes
    with torch.no_grad():
        c_target = render_linear(G.apply_params(cornell, {
            "albedo": cornell.materials.albedo * 0.7}), cw, ch, seed=1,
            device=dev)
    _reset_launches()
    _, _, c_hist = fit(cornell, c_target, ["albedo", "emission"], cw, ch,
                       steps=2, device=dev, resample_every=0)
    c_counts = _launches()
    if (c_counts["record"], c_counts["fetch"], c_counts["transpose"],
            c_counts["grad"], c_counts["fused"]) != (2, 2, 2, 0, 0) or not (
            np.isfinite(c_hist).all() and c_hist[-1] < c_hist[0]):
        raise AssertionError(f"C1: cornell depth {C1_DEPTH} fit launches "
                             f"{c_counts}, losses {c_hist}")
    print(f"phase 10 C1: cornell {cw}x{ch} spp {c_spp} depth {C1_DEPTH}: "
          f"record radiance == #5 == plain bit for bit, codes == plain "
          f"codes on all {cw * ch * c_spp} rays x {C1_DEPTH} bounces "
          f"({deep} hits past bounce 12; plain walk {c_plain_ms:.1f} ms); 2 "
          f"fit steps of albedo, emission: loss {c_hist[0]:.6f} -> "
          f"{c_hist[-1]:.6f}; launches record #5 {c_counts['record']}, #6 "
          f"{c_counts['fetch']}, #7 {c_counts['transpose']}, #3 "
          f"{c_counts['grad']}, #4 {c_counts['fused']}; no exception")

    # ---- the BVH route of the zoo, through the entries by name
    _reset_launches()
    with torch.no_grad():
        img = render_linear(_load(zoo), rw, rh, seed=0, device=dev,
                            engine="bvh")
    render_counts = _launches()
    if (render_counts["fwd"] != 1 or render_counts["brute"] != 0
            or not bool(torch.isfinite(img).all())):
        raise AssertionError(f"the zoo's BVH render launched "
                             f"{render_counts}")
    del img
    dim = _write_scene(zoo, "material_zoo_dim.json", dim=True)
    target_png = os.path.join(OUT_DIR, "zoo_fit_target.png")
    size = ["--width", str(fw), "--height", str(fh)]
    _cli_render(dim, target_png, [*size, "--spp", str(f_spp)], seed=1)
    target = (read_png(target_png)[..., :3].astype(np.float32) / 255.0) ** 2
    steps = CLI_FIT_STEPS
    _reset_launches()
    _, _, history = fit(scene, target, CLI_FIT_PARAMS.split(","), fw, fh,
                        steps=steps, device=dev, engine="bvh")
    fit_counts = _launches()
    first, final = history[0], history[-1]
    if (fit_counts["record"], fit_counts["fetch"], fit_counts["transpose"],
            fit_counts["brute"], fit_counts["fused"]) != (
                steps, steps, steps, 0, 0) or not final < first:
        raise AssertionError(f"the zoo's BVH fit launched {fit_counts}, "
                             f"losses {history}")
    sky_png = os.path.join(OUT_DIR, "sky_zoo.png")
    _reset_launches()
    _cli_render(sky_zoo, sky_png, ["--env-is", *size])
    env_counts = _launches()
    if ((env_counts["record"], env_counts["fetch"]) != (1, 1)
            or not 0 < env_counts["occlusion"] <= depth
            or env_counts["fwd"] or env_counts["brute"]):
        raise AssertionError(f"cli render of sky_zoo launched {env_counts}")
    _check_png(sky_png, fw, fh, "sky_zoo")
    print(f"phase 10 the BVH route by name (engine='bvh'): render_linear "
          f"{zoo} {rw}x{rh}: launches #5 "
          f"{render_counts['fwd']}, #1 {render_counts['brute']}; fit "
          f"{fw}x{fh} spp {f_spp}, {steps} steps of {CLI_FIT_PARAMS}: loss "
          f"{first:.6f} -> {final:.6f}, launches record #5 "
          f"{fit_counts['record']}, #6 {fit_counts['fetch']}, #7 "
          f"{fit_counts['transpose']}; CLI render --env-is sky_zoo "
          f"{fw}x{fh}: "
          f"launches record #5 {env_counts['record']}, #6 "
          f"{env_counts['fetch']}, #8 {env_counts['occlusion']} (of {depth} "
          f"bounces)")

    # ---- warm renders and fit steps at the full shapes
    best, mean = _warm_render(_load(zoo), rw, rh, dev, "zoo", engine="bvh")
    zoo_bvh = {"kernel_ms": fwd["ms"], "render_s": best}
    print(f"phase 10 zoo {rw}x{rh} spp {r_spp} depth {depth}: warm render "
          f"{best:.4f} s, {r_rays / best / 1e6:.1f} primary Mrays/s (#5), "
          f"image mean {mean:.5f}")
    box = {k: ((v - ZOO_FIT_GEO).to(dev), (v + ZOO_FIT_GEO).to(dev))
           for k, v in G.extract_params(
               scene, ["sphere_center", "sphere_radius"]).items()}
    r = _warm_fit(scene, target, ZOO_FIT_PARAMS.split(","), fw, fh, dev,
                  constraints=box, engine="bvh")
    zoo_bvh["fit_ms"] = r["warm_ms"]
    if not r["history"][-1] < r["history"][0]:
        raise AssertionError(f"the warm zoo fit's loss did not fall: "
                             f"{r['history']}")
    print(f"phase 10 zoo {fw}x{fh} spp {f_spp} fit step ({ZOO_FIT_PARAMS}; "
          f"centers and radii within {ZOO_FIT_GEO:g} of their start): warm "
          f"step {r['warm_ms']:.3f} ms, "
          f"{f_rays / r['warm_ms'] / 1e3:.2f} primary Mrays/s fwd+bwd, peak "
          f"memory {r['peak_gb']:.2f} GB; loss {r['history'][0]:.6f} -> "
          f"{r['history'][-1]:.6f}; per step under torch.profiler: "
          + _parts(r["part"], ("record #5", "#6", "#7", "replay and rest",
                               "busy"))
          + f", host (warm step - busy) "
          f"{r['warm_ms'] - r['part']['busy']:.3f} ms")
    best, mean = _warm_render(sky_scene, fw, fh, dev, "sky_zoo")

    def renders(step):
        for _ in range(3):
            render_linear(sky_scene, fw, fh, seed=0, device=dev)
            torch.cuda.synchronize()
            step()

    part = _profile(renders, 2)
    print(f"phase 10 sky_zoo {fw}x{fh} spp {f_spp} depth {depth}: warm render "
          f"{best:.4f} s, {f_rays / best / 1e6:.2f} primary Mrays/s, image "
          f"mean {mean:.5f}; per render under torch.profiler: "
          + _parts(part, ("record #5", "#6", "#8", "replay and rest", "busy"))
          + f", host (warm render - busy) {best * 1e3 - part['busy']:.3f} ms")
    sky_dim = _write_scene(sky_zoo, "sky_zoo_dim.json", dim=True)
    with torch.no_grad():
        s_target = render_linear(_load(sky_dim), fw, fh, seed=1, device=dev)
    r = _warm_fit(sky_scene, s_target, CLI_FIT_PARAMS.split(","), fw, fh, dev)
    if not r["history"][-1] < r["history"][0]:
        raise AssertionError(f"the warm sky_zoo fit's loss did not fall: "
                             f"{r['history']}")
    print(f"phase 10 sky_zoo {fw}x{fh} spp {f_spp} fit step "
          f"({CLI_FIT_PARAMS}): warm step {r['warm_ms']:.3f} ms, "
          f"{f_rays / r['warm_ms'] / 1e3:.2f} primary Mrays/s fwd+bwd, peak "
          f"memory {r['peak_gb']:.2f} GB; loss {r['history'][0]:.6f} -> "
          f"{r['history'][-1]:.6f}; per step under torch.profiler: "
          + _parts(r["part"], ("record #5", "#6", "#8", "#7",
                               "replay and rest", "busy"))
          + f", host (warm step - busy) "
          f"{r['warm_ms'] - r['part']['busy']:.3f} ms; {card}")

    return [
        # render_linear(engine="bvh") of the zoo; times at 1200x800 spp 32
        _entry("bvh_forward_zoo", "bvh_forward.cu", "3001",
               render_counts["fwd"], fwd["err"], fwd["ms"], fwd["plain_ms"],
               fwd["bound"]),
        # fit(engine="bvh") of the zoo; times at 600x400 spp 16
        *_fit_entries(fp, fit_counts, "_zoo"),
        # the CLI render --env-is of sky_zoo; times at 600x400 spp 16
        _entry("occlusion_sky_zoo", "occlusion.cu", "3591",
               env_counts["occlusion"], env["err"], env["ms"],
               env["plain_ms"], env["bound"]),
    ], zoo_bvh


# phase 11: a sky map without importance sampling, and the views
SKY_SIZE = 1000  # the sky renders' and the fit checks' frame
VIEW_SPP = 8
FD_TEXEL_EPS = 0.05  # the texel probe's loss is quadratic in the texel


def sky_scenes() -> list:
    """Phase 11's sky shapes: (label, scene JSON, CLI flags) of
    scenes/bvh_stress.json and phase 7's sheet64 under phase 9's sky,
    importance sampling off, at SKY_SIZE square."""
    if not os.path.exists(SKY):
        procedural_sky(SKY)
    size = ["--width", str(SKY_SIZE), "--height", str(SKY_SIZE)]
    return [(f"sky_{label}", _write_scene(
        path, f"sky_{label}_naive.json", sky=True,
        env_importance_sampling=False), size)
        for label, path, *_ in bvh_scenes() if label != "grid8k"]


def _view_check(label, sc, key, n_pix: int, spp: int, width: int,
                bg_kind: int, sky) -> dict:
    """#5's two views against their plain version on the same rays, bit
    for bit on every ray (the Normal view's plain run tallied, the
    Random view's timed); then each view's time and its bound from the
    one-bounce tally.  -> {view: numbers}."""
    import torch

    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import megakernel as K

    n_rays = n_pix * spp
    ids, px, py = K.prep_rays(torch.arange(n_pix, device=sc.device), spp,
                              width)
    opts = dict(max_depth=1, bg_kind=bg_kind, clay=False, sky=sky)
    tally = collections.Counter()
    out = {}
    for view in ("normal", "random"):
        ker = BK.radiance_bvh_cuda(sc, key, n_rays, spp, width, debug=view,
                                   **opts)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            plain = BK.radiance_bvh_plain(
                sc, key, ids, px, py, debug=view,
                tally=tally if view == "normal" else None, **opts)
        end.record()
        torch.cuda.synchronize()
        err = _bit_equal(f"{label}: #5's {view} view", ker, plain)
        del ker, plain
        ops = _bvh_ops(sc, tally, n_rays, bg_kind, view=view)
        out[view] = dict(
            err=err, plain_ms=start.elapsed_time(end), ops=ops,
            ms=_cuda_time_ms(lambda: BK.radiance_bvh_cuda(
                sc, key, n_rays, spp, width, debug=view, **opts), 5),
            bound=_bound(ops, _scene_bytes(sc) + 12 * n_rays
                         + _texel_bytes(tally)))
    out["tally"] = tally
    return out


def _texel_fd_probe(label, scene, dev, width: int, height: int, key,
                    target) -> tuple:
    """AD against a central difference (eps FD_TEXEL_EPS) of the loss
    mean((image - target)^2), taken in float64, in the sky's texel of
    largest gradient: the loss is quadratic in a texel (but where the
    clamp cuts a sample), so the difference is exact but for rounding.
    -> (texel, AD, FD)."""
    import torch

    from raytracingrust_tpu_torch.render.render import render_linear

    sc_dev = scene.to(dev)
    t64 = target.double()

    def loss(img):
        sky = dataclasses.replace(sc_dev.background, image=img)
        out = render_linear(dataclasses.replace(sc_dev, background=sky),
                            width, height, key=key, device=dev)
        return ((out.double() - t64) ** 2).mean()

    img = sc_dev.background.image.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(img), img)
    at = int(g.abs().reshape(-1).argmax())
    texel = tuple(int(v) for v in torch.unravel_index(torch.tensor(at),
                                                      g.shape))
    with torch.no_grad():
        bump = torch.zeros_like(img).reshape(-1)
        bump[at] = FD_TEXEL_EPS
        bump = bump.view(img.shape)
        fd = (loss(img + bump) - loss(img - bump)).item() / (
            2 * FD_TEXEL_EPS)
    ad = g.reshape(-1)[at].item()
    if not abs(ad - fd) <= 0.05 * max(abs(fd), 1e-12) or fd == 0.0:
        raise AssertionError(f"{label}: texel FD probe at {texel}: AD "
                             f"{ad:.6e} vs FD {fd:.6e}")
    return texel, ad, fd


def sky_phase(dev, card: str) -> list:
    """Phase 11; -> the report entries of #5's sky-map variant and its
    views."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.render.render import (render_linear,
                                                        select_engine)
    from raytracingrust_tpu_torch.utils import rng

    shapes = sky_scenes()
    key = rng.base_key(11)
    gen = np.random.default_rng(11)
    n = SKY_SIZE
    out = {}
    for label, path, _ in shapes:  # #5's sky-map variant at full depth
        scene = SceneBuilder.from_file(path).build()
        if select_engine(scene) != "bvh":
            raise AssertionError(f"{label}: not sent to #5")
        s = scene.settings
        spp, depth = s.samples_per_pixel, s.max_ray_depth
        with torch.no_grad():
            sc = BK.pack(scene, n, n, dev)
        sky = scene.to(dev).background
        opts = dict(max_depth=depth, bg_kind=B.SKYMAP, clay=False, sky=sky)
        out[label] = r = _forward_check(label, sc, key, n * n, spp, n, opts)
        work = (f"per ray {_per_ray(r['tally'], n * n * spp)}, "
                f"{int(r['tally']['sky_texels'].sum())} texels looked up; "
                f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}; "
                f"{r['ops']:.4g} FP32 operations); ")
        print(f"phase 11 {label} {n}x{n} spp {spp} depth {depth} "
              f"({len(scene.spheres)} spheres, {len(scene.triangles)} "
              f"triangles; sky {tuple(sky.image.shape)}, importance "
              f"sampling off): #5's sky-map variant == plain bit for bit "
              f"at depth 1 and depth {depth} on all {n * n * spp} rays; "
              + work + f"#5 {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms")
        del sc

    # the fit's kernels at sky_bvh_stress, and the probes
    label, path, _ = shapes[0]
    scene = SceneBuilder.from_file(path).build()
    with torch.no_grad():
        sc = BK.pack(scene, n, n, dev)
    sky = scene.to(dev).background
    depth = scene.settings.max_ray_depth
    opts = dict(max_depth=depth, bg_kind=B.SKYMAP, clay=False)
    fp = _fit_path(label, scene, sc, key, n, n, opts, gen, ["albedo"],
                   sky=sky)
    _print_fit_path("phase 11", label, f"{n}x{n} spp "
                    f"{scene.settings.samples_per_pixel} depth {depth} "
                    f"(recorded under black; the replay with the sky, held "
                    f"to #5's sky-map variant; gradient in the sky's texels "
                    f"too)", fp, ["albedo"])
    del fp["codes"], sc
    dim = _write_scene(path, "sky_bvh_stress_naive_dim.json", dim=True)
    with torch.no_grad():
        target = render_linear(SceneBuilder.from_file(dim).build(), n, n,
                               seed=1, device=dev)
    texel, t_ad, t_fd = _texel_fd_probe(label, scene, dev, n, n, key,
                                        target)
    print(f"phase 11 {label} texel FD probe (the texel {texel} of largest "
          f"gradient, eps {FD_TEXEL_EPS:g}, float64 loss, rtol 5%): AD "
          f"{t_ad:.6e}, FD {t_fd:.6e}")

    # the views at 1000x1000 spp 8: each kernel against its plain version
    paths = {lab: p for lab, p, *_ in bvh_scenes()}
    views = [("bvh_stress", paths["bvh_stress"]),
             ("sheet64", paths["sheet64"]),
             ("sky_sheet64", shapes[1][1]), ("material_zoo", ZOO)]
    v_out = {}
    for label, path in views:
        scene = _load(path, spp=VIEW_SPP)
        kind = scene.background.kind
        with torch.no_grad():
            sc = BK.pack(scene, n, n, dev)
        sky = scene.to(dev).background if kind == B.SKYMAP else None
        v_out[label] = r = _view_check(label, sc, key, n * n, VIEW_SPP, n,
                                       kind, sky)
        t = r["tally"]
        print(f"phase 11 views of {label} {n}x{n} spp {VIEW_SPP} "
              f"({['uniform', 'gradient', 'sky map'][kind]} background): "
              f"Normal and Random == plain bit for bit on all "
              f"{n * n * VIEW_SPP} rays ({t['view_hits']} hits); per ray "
              f"{_per_ray(t, n * n * VIEW_SPP)}; "
              + "; ".join(f"{v} {r[v]['ms']:.4f} ms (plain "
                          f"{r[v]['plain_ms']:.1f} ms, bound "
                          f"{r[v]['bound'][0]:.5f} ms {r[v]['bound'][1]})"
                          for v in ("normal", "random")))
        del sc

    # the main paths, through the CLI entry: the sky renders, the views
    _reset_launches()
    for label, path, flags in shapes:
        _cli_render(path, os.path.join(OUT_DIR, label + ".png"), flags)
    sky_counts = _launches()
    if sky_counts["sky"] != len(shapes) or any(
            v for k, v in sky_counts.items() if k != "sky"):
        raise AssertionError(f"the CLI sky renders launched {sky_counts}")
    sky_launches = sky_counts["sky"]
    view_flags = ["--width", str(n), "--height", str(n), "--spp",
                  str(VIEW_SPP)]
    _reset_launches()
    for label, path in views:
        for mode in ("Normal", "Random"):
            _cli_render(path, os.path.join(OUT_DIR, f"{label}_{mode}.png"),
                        [*view_flags, "--mode", mode])
    view_counts = _launches()
    if view_counts["view"] != 2 * len(views) or any(
            v for k, v in view_counts.items() if k != "view"):
        raise AssertionError(f"the CLI views launched {view_counts}")
    view_launches = view_counts["view"]
    for label, path, _ in shapes:
        _check_png(os.path.join(OUT_DIR, label + ".png"), n, n, label)
        scene = SceneBuilder.from_file(path).build()
        best, mean = _warm_render(scene, n, n, dev, label)
        spp = scene.settings.samples_per_pixel
        print(f"phase 11 {label} {n}x{n} spp {spp}: warm render {best:.4f} "
              f"s, {n * n * spp / best / 1e6:.1f} primary Mrays/s (#5 sky), "
              f"image mean {mean:.5f}")
    for label, _ in views:
        for mode in ("Normal", "Random"):
            _check_png(os.path.join(OUT_DIR, f"{label}_{mode}.png"), n, n,
                       f"{label} {mode}")
    print(f"phase 11 CLI renders: #5 sky-map variant {sky_launches} "
          f"launches; views {view_launches} launches (Normal and Random of "
          f"{len(views)} scenes); no other kernel")

    # the sky fit: the CLI fit at 512x512, then the warm step at 1000x1000
    label, path, _ = shapes[0]
    target_png = os.path.join(OUT_DIR, "sky_fit_target.png")
    size = str(ENV_CLI_FIT_SIZE)
    _cli_render(dim, target_png, ["--width", size, "--height", size], seed=1)
    steps = CLI_FIT_STEPS
    fit_counts, first, final, text = _cli_fit(path, target_png)
    if ((fit_counts["record"], fit_counts["fetch"], fit_counts["transpose"])
            != (steps,) * 3 or any(fit_counts[k] for k in (
                "occlusion", "fwd", "sky", "view", "brute", "grad",
                "fused"))):
        raise AssertionError(f"cli fit launches {fit_counts}\n{text}")
    print(f"phase 11 cli fit {path} {size}x{size} depth {depth}, {steps} "
          f"steps of {CLI_FIT_PARAMS}: loss {first:.6f} -> {final:.6f}; "
          f"launches record #5 {fit_counts['record']}, #6 "
          f"{fit_counts['fetch']}, #7 {fit_counts['transpose']}, #8 "
          f"{fit_counts['occlusion']}")
    scene = SceneBuilder.from_file(path).build()
    spp = scene.settings.samples_per_pixel
    r = _warm_fit(scene, target, CLI_FIT_PARAMS.split(","), n, n, dev)
    if not r["history"][-1] < r["history"][0]:
        raise AssertionError(f"the warm sky fit's loss did not fall: "
                             f"{r['history']}")
    print(f"phase 11 {label} {n}x{n} fit step ({CLI_FIT_PARAMS}): first "
          f"step {r['first_ms']:.1f} ms, warm step {r['warm_ms']:.3f} ms "
          f"(median of {r['n']}), {n * n * spp / r['warm_ms'] / 1e3:.1f} "
          f"primary Mrays/s fwd+bwd; peak memory {r['peak_gb']:.2f} GB; loss "
          f"{r['history'][0]:.6f} -> {r['history'][-1]:.6f}; per step under "
          f"torch.profiler: " + _parts(r["part"], (
              "record #5", "#6", "#7", "replay and rest", "busy"))
          + f", host (warm step - busy) "
          f"{r['warm_ms'] - r['part']['busy']:.3f} ms; {card}")

    main, view = out["sky_bvh_stress"], v_out["bvh_stress"]
    return [
        # the CLI renders of the sky scenes; times at sky_bvh_stress 1000^2
        _entry("bvh_forward_sky", "bvh_forward.cu", "3122", sky_launches,
               max(o["err"] for o in out.values()), main["ms"],
               main["plain_ms"], main["bound"]),
        # the CLI views; times of the Normal view of bvh_stress 1000^2 spp 8
        _entry("bvh_view", "bvh_forward.cu", "1706", view_launches,
               max(o[v]["err"] for o in v_out.values()
                   for v in ("normal", "random")),
               view["normal"]["ms"], view["normal"]["plain_ms"],
               view["normal"]["bound"]),
    ]


# phase 12: mesh-bounded volumes (fog inside a triangle mesh)
FOG_SIZE = 1000  # the render's frame, the scene's own spp 8 and depth 6
FOG_FIT_SIZE = 512  # the fit's frame
FOG_ICO_SUBDIV = 4  # 8 * 4^4 = 2,048 boundary triangles
CUBE_FACES = ((1, 2, 4), (1, 4, 3), (5, 7, 8), (5, 8, 6), (1, 5, 6),
              (1, 6, 2), (3, 4, 8), (3, 8, 7), (1, 3, 7), (1, 7, 5),
              (2, 6, 8), (2, 8, 4))


def _icosphere_obj(path: str, center, radius: float, subdiv: int,
                   ico: bool = False) -> None:
    """tests/test_mesh_volume.py::_icosphere's recipe (an octahedron
    subdivided ``subdiv`` times onto the sphere, 8 * 4^subdiv triangles;
    with ``ico`` an icosahedron, 20 * 4^subdiv) as an OBJ."""
    import numpy as np

    if ico:
        p = (1 + 5 ** 0.5) / 2
        verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in (
            (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p),
            (0, 1, p), (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1),
            (-p, 0, -1), (-p, 0, 1))]
        faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
                 (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
                 (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
                 (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    else:
        verts = [np.asarray(v, np.float64) for v in (
            (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1))]
        faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5),
                 (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(subdiv):
        cache, new = {}, []

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new
    v = (np.asarray(verts, np.float32) * np.float32(radius)
         + np.asarray(center, np.float32))
    with open(path, "w") as f:
        f.write("".join(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in v))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces))


def _cube_obj(path: str, center, half: float) -> None:
    """tests/test_mesh_volume.py::_cube_mesh's 12 triangles as an OBJ."""
    with open(path, "w") as f:
        for x in (-half, half):
            for y in (-half, half):
                for z in (-half, half):
                    f.write(f"v {center[0] + x:.9g} {center[1] + y:.9g} "
                            f"{center[2] + z:.9g}\n")
        f.write("".join(f"f {a} {b} {c}\n" for a, b, c in CUBE_FACES))


def fog_scene() -> str:
    """"fog_sheet", written as JSON (and OBJs) to OUT_DIR: phase 7's sheet
    of 8,192 triangles with its metal and emissive spheres, under a
    gradient background; an icosphere of 2,048 triangles bounding a fog of
    an isotropic material; a 12-triangle cube bounding a fog whose material
    is a mix of an isotropic and a Lambertian phase
    (tests/test_pallas_bvh_mixn.py's mix/cube combo).  -> its path."""
    from raytracingrust_tpu_torch import (Background, Camera, Emission,
                                          Isotropic, Lambertian, Metal,
                                          MixMaterial, RenderSettings,
                                          SceneBuilder)
    from raytracingrust_tpu_torch.models.mesh import Mesh

    sheet = os.path.join(OUT_DIR, "sheet64.obj")
    if not os.path.exists(sheet):
        _sheet_obj(sheet, 64)
    ico = os.path.join(OUT_DIR, "fog_icosphere.obj")
    _icosphere_obj(ico, (-0.3, 0.9, 0.2), 0.7, FOG_ICO_SUBDIV)
    cube = os.path.join(OUT_DIR, "fog_cube.obj")
    _cube_obj(cube, (1.2, 0.5, -0.9), 0.35)
    b = SceneBuilder()
    b.camera = Camera.create((0, 2.5, 4), (0, 0, 0), (0, 1, 0), 55.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=8, max_ray_depth=6)
    b.background = Background.gradient((0.5, 0.7, 1.0), (1.0, 1.0, 1.0))
    ml = b.add_material(Lambertian((0.6, 0.5, 0.3)))
    mm = b.add_material(Metal((0.9, 0.85, 0.8), 0.05))
    me = b.add_material(Emission((2.5, 2.2, 1.8)))
    iso = b.add_material(Isotropic((0.8, 0.8, 0.9)))
    mix = b.add_material(MixMaterial(Isotropic((0.9, 0.4, 0.3)),
                                     Lambertian((0.2, 0.6, 0.3)), 0.5))
    b.add_mesh(Mesh.from_file(sheet, ml))
    b.add_sphere((0.8, 1.2, 0.0), 0.4, mm)
    b.add_sphere((-1.2, 1.8, 0.5), 0.35, me)
    b.add_volume(b.add_mesh(Mesh.from_file(ico, iso)), 1.5)
    b.add_volume(b.add_mesh(Mesh.from_file(cube, mix)), 3.0)
    path = os.path.join(OUT_DIR, "fog_sheet.json")
    b.save(path)
    return path


def fog_phase(dev, card: str) -> list:
    """Phase 12; -> the report entries of #5's mesh-volume variants (the
    forward, the record walk, the views) and of #6 and #7 on their
    codes."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models import materials as M
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.render.render import select_engine
    from raytracingrust_tpu_torch.utils import rng

    path = fog_scene()
    key = rng.base_key(11)
    gen = np.random.default_rng(12)
    n = FOG_SIZE
    scene = _load(path)
    if select_engine(scene) != "bvh" or select_engine(scene,
                                                      grad=True) != "bvh":
        raise AssertionError("fog_sheet is not sent to #5")
    s = scene.settings
    spp, depth = s.samples_per_pixel, s.max_ray_depth
    n_rays = n * n * spp
    boundary = int((scene.triangles.volume >= 0).sum())
    opts = dict(max_depth=depth, bg_kind=scene.background.kind, clay=False)
    with torch.no_grad():
        sc = BK.pack(scene, n, n, dev)
    if sc.n_mv != 2 or sc.mixes is None:
        raise AssertionError(f"fog_sheet packs {sc.n_mv} mesh volumes")
    fwd = _forward_check("fog_sheet", sc, key, n * n, spp, n, opts)
    t = fwd["tally"]
    print(f"phase 12 fog_sheet {n}x{n} spp {spp} depth {depth} "
          f"({len(scene.spheres)} spheres, {len(scene.triangles)} triangles "
          f"of which {boundary} bound {sc.n_mv} fogs, a mix): #5's "
          f"mesh-volume variant == plain bit for bit at depth 1 and depth "
          f"{depth} on all {n_rays} rays; per ray {_per_ray(t, n_rays)}; "
          f"hits by kind {[t[f'hits_{k}'] for k in range(5)]}; #5 "
          f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.1f} ms, bound "
          f"{fwd['bound'][0]:.5f} ms ({fwd['bound'][1]}; {fwd['ops']:.4g} "
          f"FP32 operations); {card}")

    views = _view_check("fog_sheet", sc, key, n * n, spp, n, opts["bg_kind"],
                        None)
    print(f"phase 12 ptxas: {_ptxas_variants(('bvh_forward',))}")
    print(f"phase 12 views of fog_sheet {n}x{n} spp {spp}: Normal and "
          f"Random == plain bit for bit on all {n_rays} rays "
          f"({views['tally']['view_hits']} hits); "
          + "; ".join(f"{v} {views[v]['ms']:.4f} ms (plain "
                      f"{views[v]['plain_ms']:.1f} ms, bound "
                      f"{views[v]['bound'][0]:.5f} ms {views[v]['bound'][1]})"
                      for v in ("normal", "random")))
    del sc

    # the fit's kernels at the fit's frame, the gradient, the FD probe on
    # the icosphere fog's phase albedo
    fw = FOG_FIT_SIZE
    with torch.no_grad():
        sc = BK.pack(scene, fw, fw, dev)
    iso_row = int((scene.materials.kind == M.ISOTROPIC).nonzero()[0])
    fp = _fit_path("fog_sheet", scene, sc, key, fw, fw, opts, gen,
                   ["albedo"], probe_rows={"albedo": [iso_row]})
    codes = fp["codes"]
    fog_hits = int(((codes >= 0) & ((codes & BK.REC_SLOT) >= sc.mv_base))
                   .sum())
    if fog_hits == 0:
        raise AssertionError("fog_sheet: no fog hit in the record")
    _print_fit_path("phase 12", "fog_sheet", f"{fw}x{fw} spp {spp} depth "
                    f"{depth} (the fit's frame; #6 raw)", fp,
                    [f"albedo of material {iso_row}, the icosphere's phase"],
                    f", {fog_hits} in the fogs")
    del fp["codes"], codes, sc

    # the main path, through the CLI entry: the render, the views, the fit
    png = os.path.join(OUT_DIR, "fog_sheet.png")
    _reset_launches()
    _cli_render(path, png)  # the CLI's default 1000x1000
    render_counts = _launches()
    if (render_counts["fwd"], render_counts["mv"]) != (1, 1) or any(
            v for k, v in render_counts.items() if k not in ("fwd", "mv")):
        raise AssertionError(f"cli render of fog_sheet launched "
                             f"{render_counts}")
    _check_png(png, n, n, "fog_sheet")
    view_flags = ["--width", str(n), "--height", str(n)]
    _reset_launches()
    for mode in ("Normal", "Random"):
        _cli_render(path, os.path.join(OUT_DIR, f"fog_sheet_{mode}.png"),
                    [*view_flags, "--mode", mode])
    view_counts = _launches()
    if (view_counts["view"], view_counts["mv"]) != (2, 2) or any(
            v for k, v in view_counts.items() if k not in ("view", "mv")):
        raise AssertionError(f"the CLI views of fog_sheet launched "
                             f"{view_counts}")
    for mode in ("Normal", "Random"):
        _check_png(os.path.join(OUT_DIR, f"fog_sheet_{mode}.png"), n, n,
                   f"fog_sheet {mode}")
    dim = _write_scene(path, "fog_sheet_dim.json", dim=True)
    target_png = os.path.join(OUT_DIR, "fog_fit_target.png")
    size = ["--width", str(fw), "--height", str(fw)]
    _cli_render(dim, target_png, size, seed=1)
    steps = CLI_FIT_STEPS
    fit_counts, first, final, text = _cli_fit(path, target_png)
    if ((fit_counts["record"], fit_counts["mv"], fit_counts["fetch"],
         fit_counts["transpose"]) != (steps,) * 4 or any(
            fit_counts[k] for k in ("fwd", "sky", "view", "occlusion",
                                    "brute", "grad", "fused"))):
        raise AssertionError(f"cli fit of fog_sheet launched {fit_counts}"
                             f"\n{text}")
    print(f"phase 12 CLI: render {path} {n}x{n}: launches #5 "
          f"{render_counts['fwd']} (mesh-volume variant "
          f"{render_counts['mv']}); Normal and Random views {n}x{n}: "
          f"launches {view_counts['view']}; fit {fw}x{fw}, {steps} steps of "
          f"{CLI_FIT_PARAMS}: loss {first:.6f} -> {final:.6f}, launches "
          f"record #5 {fit_counts['record']}, #6 {fit_counts['fetch']}, #7 "
          f"{fit_counts['transpose']} (mesh-volume variant "
          f"{fit_counts['mv']}); no other kernel")

    # warm render and fit step at the main path's frames
    best, mean = _warm_render(scene, n, n, dev, "fog_sheet")
    print(f"phase 12 fog_sheet {n}x{n} spp {spp} depth {depth}: warm render "
          f"{best:.4f} s, {n_rays / best / 1e6:.1f} primary Mrays/s (#5 "
          f"mesh-volume variant), image mean {mean:.5f}; {card}")
    target = (read_png(target_png)[..., :3].astype(np.float32) / 255.0) ** 2
    r = _warm_fit(scene, target, CLI_FIT_PARAMS.split(","), fw, fw, dev)
    if not r["history"][-1] < r["history"][0]:
        raise AssertionError(f"the warm fog_sheet fit's loss did not fall: "
                             f"{r['history']}")
    print(f"phase 12 fog_sheet {fw}x{fw} fit step ({CLI_FIT_PARAMS}): "
          f"first step {r['first_ms']:.1f} ms, warm step "
          f"{r['warm_ms']:.3f} ms (median of {r['n']}), "
          f"{fw * fw * spp / r['warm_ms'] / 1e3:.1f} primary Mrays/s "
          f"fwd+bwd; peak memory {r['peak_gb']:.2f} GB; loss "
          f"{r['history'][0]:.6f} -> {r['history'][-1]:.6f}; per step under "
          f"torch.profiler: " + _parts(r["part"], (
              "record #5", "#6", "#7", "replay forward", "replay backward",
              "Adam", "busy"))
          + f", host (warm step - busy) "
          f"{r['warm_ms'] - r['part']['busy']:.3f} ms; {card}")

    view = views["normal"]
    return [
        # the CLI render of fog_sheet; times at 1000x1000 spp 8 depth 6
        _entry("bvh_forward_mv", "bvh_forward.cu", "1116",
               render_counts["fwd"], fwd["err"], fwd["ms"], fwd["plain_ms"],
               fwd["bound"]),
        # the CLI fit of fog_sheet; times at 512x512 spp 8 depth 6
        *_fit_entries(fp, fit_counts, "_mv"),
        # the CLI views; times of the Normal view at 1000x1000 spp 8
        _entry("bvh_view_mv", "bvh_forward.cu", "1706", view_counts["view"],
               max(views[v]["err"] for v in ("normal", "random")),
               view["ms"], view["plain_ms"], view["bound"]),
    ]


# phase 13: the brute kernels' mixes, sphere volumes, isotropic lobe and sky
SKY_BENCH = (1000, 1000, 8, 6)  # width, height, spp, depth (CLI defaults)
SKY_BENCH_FIT = 512
SKY_ZOO_NAIVE = (600, 400, 16, 8)
# rays in one autograd graph of the plain version in phase 13's gradient
# checks: each bounce holds ~15 floats a ray and a sphere, ~9 GB here for
# the zoo's 48 spheres
BRUTE_PLAIN_RAYS = 400_000


def brute_scenes() -> list:
    """Phase 13's shapes: (label, scene JSON, render (w, h), fit (w, h,
    spp)); sky_bench and sky_zoo_naive written beside phase 9's sky, with
    importance sampling off."""
    if not os.path.exists(SKY):
        procedural_sky(SKY)
    sky_bench = _write_scene(BENCH, "sky_bench.json", sky=True,
                             env_importance_sampling=False,
                             samples_per_pixel=SKY_BENCH[2],
                             max_ray_depth=SKY_BENCH[3])
    w, h, spp, depth = SKY_ZOO_NAIVE
    sky_zoo = _write_scene(ZOO, "sky_zoo_naive.json", sky=True,
                           env_importance_sampling=False,
                           samples_per_pixel=spp, max_ray_depth=depth)
    fw, fh, f_spp = ZOO_FIT
    return [("zoo_brute", ZOO, ZOO_RENDER, (fw, fh, f_spp)),
            ("sky_bench", sky_bench, SKY_BENCH[:2],
             (SKY_BENCH_FIT, SKY_BENCH_FIT, SKY_BENCH[2])),
            ("sky_zoo_naive", sky_zoo, (w, h), (w, h, spp))]


def _brute_inputs(scene, w: int, h: int, dev) -> tuple:
    """(fparams, kinds, options with the triangles' rows, sky texels or
    None) of a brute scene."""
    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.ops import megakernel as K

    sky = (scene.background.image.to(dev).contiguous()
           if scene.background.kind == B.SKYMAP else None)
    tri = K.pack_tri(scene)
    return (K.pack_fparams(scene, w, h).to(dev),
            K.brute_kinds(scene).to(dev),
            {**K.scene_opts(scene),
             "tri": None if tri is None else tri.to(dev)}, sky)


def _brute_sizes(fp, kinds, opts) -> tuple:
    """(spheres, triangles, the bytes of the scene's inputs) of
    :func:`_brute_inputs`' tensors."""
    n_tri = 0 if opts["tri"] is None else opts["tri"].shape[0]
    return (kinds.shape[0] - opts["n_tm"], n_tri,
            4 * fp.numel() + 4 * kinds.numel() + BYTES_TRI * n_tri)


def _brute_forward_check(label, scene, w: int, h: int, dev, key) -> dict:
    """#1 against its plain version on every ray of the frame: per-ray
    radiance bit for bit at depth 1 and at full depth; #1's time, the
    plain version's (full depth, counting its rays' work as it runs), the
    work of the plain run's rays and #1's bound from it."""
    import torch

    from raytracingrust_tpu_torch.ops import megakernel as K

    fp, kinds, opts, sky = _brute_inputs(scene, w, h, dev)
    spp = scene.settings.samples_per_pixel
    n_rays = w * h * spp
    ids, px, py = K.prep_rays(torch.arange(w * h, device=dev), spp, w)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    count = _Count()
    for d in (1, opts["max_depth"]):
        at = {**opts, "max_depth": d}
        ker = K.radiance_cuda(fp, kinds, key, n_rays, spp, w, sky=sky, **at)
        start.record()
        with torch.no_grad():
            plain = K.radiance_plain(
                fp, kinds, key, ids, px, py, sky=sky,
                observe=count if d == opts["max_depth"] else None, **at)
        end.record()
        torch.cuda.synchronize()
        err = _bit_equal(f"{label}: #1's radiance at depth {d}", ker, plain)
    plain_ms = start.elapsed_time(end)
    mean = ker.mean().item()
    del ker, plain
    ms = _cuda_time_ms(lambda: K.radiance_cuda(
        fp, kinds, key, n_rays, spp, w, sky=sky, **opts), 5)
    n_sph, n_tri, scene_bytes = _brute_sizes(fp, kinds, opts)
    ops = count.forward_ops(n_rays, n_sph, n_tri=n_tri, **opts)
    return dict(ms=ms, plain_ms=plain_ms, err=err, count=count, ops=ops,
                mean=mean, bound=_bound(ops, scene_bytes + 12 * n_rays
                                        + count.texel_bytes()))


def _brute_plain_grads(fp, kinds, key, cts, target, spp: int, w: int,
                       clamp: float, sky, opts: dict, tally=None) -> tuple:
    """Autograd through the plain version over pixel ranges of about
    BRUTE_PLAIN_RAYS rays, summed: #3's gradient (dfparams, and dsky with
    a sky map) for the cotangents ``cts`` and, with ``target``, #4's loss
    and dfparams in its place (each range's squared errors over the whole
    frame's pixel and channel count).  A :class:`_TallySum` ``tally`` gets
    each range's work as it runs.  One graph of the frame would hold every bounce's
    per-sphere temporaries, 88 GB for the zoo at the fit's 3.84M rays."""
    import torch

    from raytracingrust_tpu_torch.ops import megakernel as K

    n_pix = cts.shape[0] // spp if target is None else target.shape[0]
    step = max(1, BRUTE_PLAIN_RAYS // spp)
    fpg = fp.detach().requires_grad_(True)
    skg = None if sky is None else sky.detach().requires_grad_(True)
    leaves = [fpg] if skg is None else [fpg, skg]
    g3 = [torch.zeros_like(v) for v in leaves]
    g4 = torch.zeros_like(fp)
    loss = torch.zeros((), dtype=torch.float64, device=fp.device)
    for p0 in range(0, n_pix, step):
        p1 = min(n_pix, p0 + step)
        ids, px, py = K.prep_rays(torch.arange(p0, p1, device=fp.device),
                                  spp, w)
        seen = None if tally is None else _Tally(opts["max_depth"])
        with torch.enable_grad():
            rad = K.radiance_plain(fpg, kinds, key, ids, px, py, sky=skg,
                                   observe=seen, **opts)
            if target is None:
                grads = torch.autograd.grad(rad, leaves,
                                            cts[p0 * spp:p1 * spp],
                                            allow_unused=True)
                for acc, g in zip(g3, grads):
                    if g is not None:
                        acc += g
            else:
                m = K.clip_samples(rad, clamp).view(-1, spp, 3).mean(dim=1)
                part = ((m - target[p0:p1]) ** 2).sum() / (n_pix * 3)
                g4 += torch.autograd.grad(part, fpg)[0]
                loss += part.detach().double()
        del rad
        if seen is not None:
            tally.add(seen, opts["bg_kind"])
    if target is not None:
        return loss.float(), g4
    return g3[0] if sky is None else tuple(g3)


def _held_grads(label, got, want) -> float:
    """:func:`_grad_check` of the kernels' gradients against the plain
    version's, which must be finite everywhere and nonzero."""
    import torch

    for b in want:
        if not bool(torch.isfinite(b).all()) or b.abs().max() == 0.0:
            raise AssertionError(
                f"{label}: the plain gradient has {int((~torch.isfinite(b)).sum())} "
                f"entries that are not finite, or is 0")
    return _grad_check(label, got, want)


def _brute_grad_check(label, scene, w: int, h: int, dev, key, gen,
                      fused: bool) -> dict:
    """#3 (and with ``fused`` #4) at the frame (w, h) and the scene's own
    spp against autograd through the plain version on the same inputs (over
    pixel ranges, :func:`_brute_plain_grads`), the texels' gradient
    included; each entry within GRAD_RTOL of the plain gradient's or
    GRAD_ATOL of its largest, finite, and each plain gradient finite and
    nonzero.  Then the kernels' times, the plain versions' (#3's counting
    its rays' work as it runs), and their bounds from that count, all at
    that shape."""
    import torch

    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import radiance_grad as RG

    fp, kinds, opts, sky = _brute_inputs(scene, w, h, dev)
    clamp = scene.settings.clamp_indirect
    spp = scene.settings.samples_per_pixel
    n_rays = w * h * spp
    cts = torch.tensor(gen.standard_normal((n_rays, 3)), dtype=torch.float32,
                       device=dev)
    target = torch.tensor(gen.random((w * h, 3)), dtype=torch.float32,
                          device=dev)

    def grad3():
        return RG.radiance_grad_cuda(fp, kinds, key, cts, spp, w, sky=sky,
                                     **opts)

    def loss4():
        return MS.mse_loss_cuda(fp, kinds, key, target, spp, w, clamp=clamp,
                                **opts)

    def plain(with_target: bool, tally=None) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = _brute_plain_grads(fp, kinds, key, cts,
                               target if with_target else None, spp, w,
                               clamp, sky, opts, tally)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    out = {"spp": spp}
    got = grad3()
    torch.cuda.reset_peak_memory_stats()
    tally = _TallySum()
    want, out["plain3_ms"] = plain(False, tally)
    out["plain_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    got, want = (got, want) if sky is not None else ((got,), (want,))
    out["err3"] = _held_grads(f"{label} #3", got, want)
    if sky is not None:
        out["texels"] = int((want[1] != 0).any(-1).sum())
    del got, want
    if fused:
        loss, dfp = loss4()
        (p_loss, p_dfp), out["plain4_ms"] = plain(True)
        if abs(loss.item() - p_loss.item()) > LOSS_RTOL * abs(p_loss.item()):
            raise AssertionError(f"{label}: #4's loss {loss.item()} vs "
                                 f"plain {p_loss.item()}")
        out["err4"] = _held_grads(f"{label} #4", (dfp,), (p_dfp,))
        out["ms4"] = _cuda_time_ms(loss4, 3)
    out["ms3"] = _cuda_time_ms(grad3, 3)
    n_sph, n_tri, scene_bytes = _brute_sizes(fp, kinds, opts)
    k_f = fp.numel()
    fwd = tally.forward_ops(n_rays, n_sph, n_tri=n_tri, **opts)
    adj = tally.adj_ops
    scene_bytes += 2 * tally.texel_bytes()
    out["bound3"] = _bound(fwd + adj, scene_bytes + 12 * n_rays + 4 * k_f)
    out["bound4"] = _bound(
        fwd + adj + n_rays * OPS_LOSS_RAY + w * h * OPS_LOSS_PIXEL,
        scene_bytes + 12 * w * h + 4 * (k_f + 1))
    return out


# phase 5: the fused kernel's lane groups (csrc/mse_loss.cu) where they can
# break: one sample a pixel, groups that leave lanes of a warp idle, fill a
# warp, span warps, and take more than one sample a thread, on a frame
# whose pixels fill no whole warp or block
GROUP_FRAME = (61, 37)
GROUP_SPP = (1, 5, 8, 16, 48, 130)
GROUP_DEPTH = 6


def fused_group_check(dev, card: str) -> float:
    """#4's four variants (benchmark.json's spheres; the zoo, kExt;
    tri_brute, kTri; tri_zoo, both) at GROUP_FRAME and GROUP_DEPTH for each
    spp of GROUP_SPP: the loss within LOSS_RTOL and the gradient within
    GRAD_RTOL/GRAD_ATOL of autograd through the plain version on the same
    inputs, each launch counted as its variant.  -> the largest gradient
    difference."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.utils import rng

    tri = {label: path for label, path, *_ in tri_scenes()}
    variants = (("spheres", BENCH, 0, 0), ("kExt", ZOO, 1, 0),
                ("kTri", tri["tri_brute"], 0, 1),
                ("kExt+kTri", tri["tri_zoo"], 1, 1))
    w, h = GROUP_FRAME
    key = rng.base_key(5)
    gen = np.random.default_rng(5)
    worst = 0.0
    for label, path, ext, with_tri in variants:
        t0 = time.perf_counter()
        parts = []
        for spp in GROUP_SPP:
            scene = _load(path, spp=spp, depth=GROUP_DEPTH)
            fp, kinds, opts, _ = _brute_inputs(scene, w, h, dev)
            target = torch.tensor(gen.random((w * h, 3)),
                                  dtype=torch.float32, device=dev)
            clamp = scene.settings.clamp_indirect
            before = (MS.LAUNCHES, MS.EXT_LAUNCHES, MS.TRI_LAUNCHES)
            loss, dfp = MS.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                         clamp=clamp, **opts)
            if (MS.LAUNCHES, MS.EXT_LAUNCHES, MS.TRI_LAUNCHES) != (
                    before[0] + 1, before[1] + ext, before[2] + with_tri):
                raise AssertionError(f"#4 {label}: not its variant's launch")
            p_loss, p_dfp = _brute_plain_grads(fp, kinds, key, None, target,
                                               spp, w, clamp, None, opts)
            loss_err = abs(loss.item() - p_loss.item())
            if loss_err > LOSS_RTOL * abs(p_loss.item()):
                raise AssertionError(f"#4 {label} spp {spp} at {w}x{h}: loss "
                                     f"{loss.item():.9e} vs plain "
                                     f"{p_loss.item():.9e}")
            err = _held_grads(f"#4 {label} spp {spp} at {w}x{h}", (dfp,),
                              (p_dfp,))
            worst = max(worst, err)
            parts.append(f"spp {spp} loss diff {loss_err:.1e}, dfparams "
                         f"{err:.2e}")
        print(f"phase 5 #4 lane groups, {label} at {w}x{h} depth "
              f"{GROUP_DEPTH} (within {LOSS_RTOL:g} and {GRAD_RTOL:g} rel + "
              f"{GRAD_ATOL:g} of max of the plain version): "
              + "; ".join(parts)
              + f" ({time.perf_counter() - t0:.1f} s); {card}")
    return worst


def brute_phase(dev, card: str, zoo_bvh: dict) -> list:
    """Phase 13; -> the report entries of #1's, #3's and #4's variants
    with mixes, volumes and the isotropic lobe (kExt) and a sky map
    (kSky)."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.diff import grad as G
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import radiance_grad as RG
    from raytracingrust_tpu_torch.render.render import (render_linear,
                                                        select_engine)
    from raytracingrust_tpu_torch.utils import rng

    key = rng.base_key(13)
    gen = np.random.default_rng(13)
    shapes = brute_scenes()
    fwd, grads, cli_counts = {}, {}, {}
    for label, path, (rw, rh), (fw, fh, f_spp) in shapes:
        scene = _load(path)
        opts = K.scene_opts(scene)
        if (select_engine(scene), select_engine(scene, grad=True)) != (
                "brute", "brute"):
            raise AssertionError(f"{label} is not sent to the brute kernels")
        r_spp = scene.settings.samples_per_pixel
        f = _brute_forward_check(label, scene, rw, rh, dev, key)
        fwd[label] = f
        c = f["count"]
        print(f"phase 13 {label} {rw}x{rh} spp {r_spp} depth "
              f"{opts['max_depth']} ({len(scene.spheres)} spheres, "
              f"{opts['n_vol']} volume, mixes {opts['mix']}, isotropic "
              f"{opts['iso']}, sky map {scene.background.kind == 2}): #1 "
              f"radiance == plain bit for bit at depth 1 and depth "
              f"{opts['max_depth']} on all {rw * rh * r_spp} rays; per ray "
              f"{c.bounces / (rw * rh * r_spp):.3f} bounces, hits by kind "
              f"{[c.hits[k] for k in range(5)]}, misses {c.misses}, volume "
              f"windows {c.windows}, texels looked up "
              f"{c.texel_bytes() // 12}; #1 {f['ms']:.4f} ms, plain "
              f"{f['plain_ms']:.1f} ms, bound {f['bound'][0]:.5f} ms "
              f"({f['bound'][1]}; {f['ops']:.4g} FP32 operations); {card}")
        fit_scene = _load(path, spp=f_spp)
        g = _brute_grad_check(label, fit_scene, fw, fh, dev, key, gen,
                              fused=scene.background.kind != 2)
        grads[label] = g
        texels = (f", the texels' gradient ({g['texels']} texels)"
                  if "texels" in g else "")
        fused = (f"; #4 max abs diff {g['err4']:.3e}, {g['ms4']:.3f} ms "
                 f"(plain autograd {g['plain4_ms']:.1f} ms), bound "
                 f"{g['bound4'][0]:.5f} ms ({g['bound4'][1]})"
                 if "err4" in g else "")
        print(f"phase 13 {label} gradients at {fw}x{fh} spp {g['spp']} "
              f"(autograd of the plain version over ranges of "
              f"{BRUTE_PLAIN_RAYS} rays, summed; peak {g['plain_peak_gb']:.1f}"
              f" GB; finite everywhere): #3 max abs diff {g['err3']:.3e}"
              f"{texels} (allowed {GRAD_RTOL:g} rel + {GRAD_ATOL:g} of max), "
              f"finite; #3 {g['ms3']:.3f} ms (plain autograd "
              f"{g['plain3_ms']:.1f} ms), bound {g['bound3'][0]:.5f} ms "
              f"({g['bound3'][1]}){fused}; {card}")

    # FD probes: an albedo of the zoo (make_loss: #4), the texel of
    # largest gradient of sky_bench (#1 forward, #3 backward)
    fw, fh, f_spp = ZOO_FIT
    zoo_fit = _load(ZOO, spp=f_spp)
    mats = zoo_fit.materials
    albedo_rows = [int(i) for i in (mats.albedo.abs().sum(-1) > 0)
                   .nonzero().squeeze(1)[:4]]
    ad, fd = _fd_probe("zoo_brute", zoo_fit, dev, fw, fh, key, ["albedo"],
                       gen, {"albedo": albedo_rows})
    sky_fit = _load(shapes[1][1])
    with torch.no_grad():
        s_target = render_linear(sky_fit, SKY_BENCH_FIT, SKY_BENCH_FIT,
                                 seed=12, device=dev) * 0.9
    texel, t_ad, t_fd = _texel_fd_probe("sky_bench", sky_fit, dev,
                                        SKY_BENCH_FIT, SKY_BENCH_FIT, key,
                                        s_target)
    print(f"phase 13 FD probes (rtol 5%): zoo {fw}x{fh} spp {f_spp} albedo "
          f"rows {albedo_rows} (eps {FD_EPS:g}; #4): AD {ad:.6e}, FD "
          f"{fd:.6e}; sky_bench {SKY_BENCH_FIT}x{SKY_BENCH_FIT} texel "
          f"{texel} (eps {FD_TEXEL_EPS:g}; #1, #3): AD {t_ad:.6e}, FD "
          f"{t_fd:.6e}")

    # ---- the main path, through the CLI entry
    for label, path, (rw, rh), (fw, fh, f_spp) in shapes:
        png = os.path.join(OUT_DIR, f"{label}.png")
        _reset_launches()
        _cli_render(path, png, ["--width", str(rw), "--height", str(rh)])
        cli_counts[label, "render"] = _launches()
        _check_png(png, rw, rh, label)
        dim = _write_scene(path, f"{label}_dim.json", dim=True)
        target_png = os.path.join(OUT_DIR, f"{label}_fit_target.png")
        _cli_render(dim, target_png, ["--width", str(fw), "--height",
                                      str(fh), "--spp", str(f_spp)], seed=1)
        counts, first, final, _ = _cli_fit(path, target_png,
                                           ["--spp", str(f_spp)])
        cli_counts[label, "fit"] = counts
        print(f"phase 13 CLI {label}: render {rw}x{rh}: launches #1 "
              f"{cli_counts[label, 'render']['brute']}, #5 "
              f"{cli_counts[label, 'render']['fwd'] + cli_counts[label, 'render']['sky']}"
              f"; fit {fw}x{fh} spp {f_spp}, {CLI_FIT_STEPS} steps of "
              f"{CLI_FIT_PARAMS}: loss {first:.6f} -> {final:.6f}, launches "
              f"#1 {counts['brute']}, #3 {counts['grad']}, #4 "
              f"{counts['fused']}, record #5 {counts['record']}")
    render = {k[0]: v for k, v in cli_counts.items() if k[1] == "render"}
    fits = {k[0]: v for k, v in cli_counts.items() if k[1] == "fit"}
    steps = CLI_FIT_STEPS
    # (#1 in the render; #1, #3, #4 in the fit): the fused kernel a step,
    # or under a sky map the forward and the radiance gradient kernels
    want = {"zoo_brute": (1, 0, 0, steps), "sky_bench": (1, steps, steps, 0),
            "sky_zoo_naive": (1, steps, steps, 0)}
    for label, (n_render, n_fwd, n_grad, n_fused) in want.items():
        got = (render[label]["brute"], fits[label]["brute"],
               fits[label]["grad"], fits[label]["fused"])
        ext, sky = label != "sky_bench", label != "zoo_brute"
        got += (render[label]["brute_ext"], render[label]["brute_sky"],
                fits[label]["fused_ext"] + fits[label]["grad_ext"],
                fits[label]["grad_sky"])
        if got != (n_render, n_fwd, n_grad, n_fused, int(ext), int(sky),
                   steps * ext, steps * sky) or any(
                cli_counts[k][n] for k in cli_counts
                for n in ("fwd", "sky", "record", "view", "mv")):
            raise AssertionError(f"{label}: the CLI launched {cli_counts}")

    # a loss of the caller's own on the zoo: #1 forward, #3 backward
    zoo_dev = zoo_fit.to(dev)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.extract_params(zoo_dev, ["albedo"]).items()}
    target = torch.zeros((fh, fw, 3), device=dev)
    _reset_launches()
    img = render_linear(G.apply_params(zoo_dev, params), ZOO_FIT[0],
                        ZOO_FIT[1], seed=0, device=dev)
    (img - target).abs().mean().backward()
    l1 = _launches()
    l1_counts = (l1["brute_ext"], l1["grad_ext"], l1["fused"])
    if l1_counts != (1, 1, 0) or not bool(
            torch.isfinite(params["albedo"].grad).all()):
        raise AssertionError(f"the zoo's L1 loss launched {l1_counts}")

    # ---- warm renders and fit steps
    for label, path, (rw, rh), (fw, fh, f_spp) in shapes:
        scene = _load(path)
        best, mean = _warm_render(scene, rw, rh, dev, label)
        r_rays = rw * rh * scene.settings.samples_per_pixel

        def renders(step, scene=scene, rw=rw, rh=rh):
            for _ in range(3):
                render_linear(scene, rw, rh, seed=0, device=dev)
                torch.cuda.synchronize()
                step()

        part = _profile(renders, 2)
        fit_scene = _load(path, spp=f_spp)
        target = (read_png(os.path.join(OUT_DIR, f"{label}_fit_target.png"))
                  [..., :3].astype(np.float32) / 255.0) ** 2
        names = (ZOO_FIT_PARAMS if label == "zoo_brute"
                 else CLI_FIT_PARAMS).split(",")
        box = ({k: ((v - ZOO_FIT_GEO).to(dev), (v + ZOO_FIT_GEO).to(dev))
                for k, v in G.extract_params(
                    fit_scene, ["sphere_center", "sphere_radius"]).items()}
               if label == "zoo_brute" else None)
        r = _warm_fit(fit_scene, target, names, fw, fh, dev,
                      constraints=box)
        if not r["history"][-1] < r["history"][0]:
            raise AssertionError(f"the warm {label} fit's loss did not "
                                 f"fall: {r['history']}")
        beside = (f" (phase 10's #5 route on the same shapes in this run: "
                  f"#5 {zoo_bvh['kernel_ms']:.4f} ms, warm render "
                  f"{zoo_bvh['render_s']:.4f} s; warm fit step on the "
                  f"record walk and replay {zoo_bvh['fit_ms']:.3f} ms)"
                  if label == "zoo_brute" else "")
        print(f"phase 13 {label} {rw}x{rh}: warm render {best:.4f} s, "
              f"{r_rays / best / 1e6:.1f} primary Mrays/s, image mean "
              f"{mean:.5f}; per render under torch.profiler: "
              + _parts(part, ("#1", "replay and rest", "busy"))
              + f", host (warm render - busy) "
              f"{best * 1e3 - part['busy']:.3f} ms; fit step {fw}x{fh} spp "
              f"{f_spp} ({','.join(names)}): warm step {r['warm_ms']:.3f} "
              f"ms (median of {r['n']}), {fw * fh * f_spp / r['warm_ms'] / 1e3:.2f}"
              f" primary Mrays/s fwd+bwd, peak memory {r['peak_gb']:.2f} "
              f"GB; loss {r['history'][0]:.6f} -> {r['history'][-1]:.6f}; "
              f"per step under torch.profiler: "
              + _parts(r["part"], ("#1", "#3", "#4", "replay and rest",
                                   "busy"))
              + f", host (warm step - busy) "
              f"{r['warm_ms'] - r['part']['busy']:.3f} ms{beside}; {card}")
    print(f"phase 13 ptxas: {_ptxas_variants()}")

    z, s, b = fwd["zoo_brute"], fwd["sky_zoo_naive"], fwd["sky_bench"]
    gz, gs, gb = grads["zoo_brute"], grads["sky_zoo_naive"], grads[
        "sky_bench"]
    return [
        # the CLI render of the zoo; times at 1200x800 spp 32 depth 8
        _entry("brute_forward_ext", "megakernel.cu", "2089",
               render["zoo_brute"]["brute_ext"], z["err"], z["ms"],
               z["plain_ms"], z["bound"]),
        # the CLI render of sky_bench; times at 1000x1000 spp 8 depth 6
        _entry("brute_forward_sky", "megakernel.cu", "2089",
               render["sky_bench"]["brute_sky"], b["err"], b["ms"],
               b["plain_ms"], b["bound"]),
        # the CLI render of sky_zoo_naive; times at 600x400 spp 16 depth 8
        _entry("brute_forward_ext_sky", "megakernel.cu", "2089",
               render["sky_zoo_naive"]["brute"], s["err"], s["ms"],
               s["plain_ms"], s["bound"]),
        # the zoo's L1 loss through render_linear; times at 600x400 spp 16
        _entry("radiance_grad_ext", "radiance_grad.cu", "2133", l1_counts[1],
               gz["err3"], gz["ms3"], gz["plain3_ms"], gz["bound3"]),
        # the CLI fit of sky_bench; times at 512x512 spp 8
        _entry("radiance_grad_sky", "radiance_grad.cu", "2133",
               fits["sky_bench"]["grad_sky"], gb["err3"], gb["ms3"],
               gb["plain3_ms"], gb["bound3"]),
        # the CLI fit of sky_zoo_naive; times at 600x400 spp 16
        _entry("radiance_grad_ext_sky", "radiance_grad.cu", "2133",
               fits["sky_zoo_naive"]["grad"], gs["err3"], gs["ms3"],
               gs["plain3_ms"], gs["bound3"]),
        # the CLI fit of the zoo; times at 600x400 spp 16
        _entry("fused_mse_loss_ext", "mse_loss.cu", "2411",
               fits["zoo_brute"]["fused_ext"], gz["err4"], gz["ms4"],
               gz["plain4_ms"], gz["bound4"]),
    ]


def _ptxas_variants(names=("megakernel", "radiance_grad",
                           "mse_loss")) -> str:
    """Registers, stack and spills of each template variant of the kernels
    of the sources ``names``, from the compiler's report: #1, #3 and #4 by
    default (kExt, kSky, kTri as the template's bools; #4 has kExt, kTri,
    kWarp); #5's "bvh_forward" (kRecord, kExt, kSky, kMv; the views kSky,
    kMv)."""
    import re

    from raytracingrust_tpu_torch.ops import _build

    out = []
    for name in names:
        log = _build.library_path(name=name).with_suffix(".log")
        fn = None
        for ln in (log.read_text().splitlines() if log.exists() else []):
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
                continue
            if fn is None:
                continue
            flags = re.search(r"(bvh_radiance_kernel|bvh_view_kernel|"
                              r"radiance_kernel|grad_kernel|mse_kernel)"
                              r"IL?b([01])E((?:L?b[01]E)*)", fn)
            if "stack frame" in ln:
                stack = ln.strip()
            elif "registers" in ln and flags:
                bits = [flags.group(2)] + re.findall(r"b([01])E",
                                                     flags.group(3))
                out.append(f"{flags.group(1)}<{','.join(bits)}>: "
                           f"{ln.split(':', 1)[1].strip()}; {stack}")
                fn = None
    return " | ".join(out)


# phase 14: the brute kernels' triangle branch (scenes built without their
# BVH)
TRI_SHEET = (16, 32)  # quads of the height field: 1,024 triangles
TRI_RENDER = (1000, 1000, 8, 6)  # width, height, spp, depth
TRI_FIT = (512, 512, 8)  # width, height, spp; depth 6
TRI_ZOO_ICO = 2  # an icosahedron subdivided twice: 320 triangles


def _tri_sheet_objs(lam: str, metal: str, seed: int = 14) -> None:
    """A height field of TRI_SHEET quads under benchmark.json's spheres
    (x in [-2, 2], z in [-3, -0.2], its height from a numpy seed), as two
    OBJs: the quads of even (i + j) and their two triangles in ``lam``, the
    others in ``metal``, 1,024 triangles together."""
    import numpy as np

    nz, nx = TRI_SHEET
    xs = np.linspace(-2.0, 2.0, nx + 1)
    zs = np.linspace(-3.0, -0.2, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = -0.55 + 0.08 * np.random.default_rng(seed).random(gx.shape)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    vlines = "".join(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
    faces = ([], [])
    for i in range(nx):
        for j in range(nz):
            a = i * (nz + 1) + j + 1  # 1-based
            faces[(i + j) % 2].extend([(a, a + 1, a + nz + 1),
                                       (a + 1, a + nz + 2, a + nz + 1)])
    for path, fs in zip((lam, metal), faces):
        with open(path, "w") as f:
            f.write(vlines + "".join(f"f {a} {b} {c}\n" for a, b, c in fs))


def tri_scenes() -> list:
    """Phase 14's shapes, written as JSON (and OBJs) to OUT_DIR, each
    built without its BVH: (label, scene JSON, render (w, h), fit (w, h,
    spp)).  "tri_brute": scenes/benchmark.json (its camera, settings at
    spp 8 depth 6, and five spheres) over a 1,024-triangle height field,
    half Lambertian and half metal; "tri_zoo": scenes/material_zoo.json
    with a 320-triangle icosphere of its mix material and a two-triangle
    mirror; "tri_zoo_sky": that under phase 9's sky, importance sampling
    off."""
    lam = os.path.join(OUT_DIR, "tri_sheet_lambertian.obj")
    metal = os.path.join(OUT_DIR, "tri_sheet_metal.obj")
    _tri_sheet_objs(lam, metal)
    with open(BENCH) as f:
        d = json.load(f)
    n_mat = len(d["materials"])
    d["materials"] += [
        {"type": "Lambertian", "albedo": {"r": 0.55, "g": 0.5, "b": 0.45}},
        {"type": "Metal", "albedo": {"r": 0.8, "g": 0.85, "b": 0.9},
         "fuzz": 0.05}]
    d["objects"] += [{"type": "Mesh", "path": lam, "material": n_mat},
                     {"type": "Mesh", "path": metal, "material": n_mat + 1}]
    w, h, spp, depth = TRI_RENDER
    d["settings"].update(samples_per_pixel=spp, max_ray_depth=depth,
                         enable_bvh_tree=False)
    brute = os.path.join(OUT_DIR, "tri_brute.json")
    with open(brute, "w") as f:
        json.dump(d, f)

    ico = os.path.join(OUT_DIR, "tri_zoo_icosphere.obj")
    _icosphere_obj(ico, (-1.0, 0.25, 0.9), 0.3, TRI_ZOO_ICO, ico=True)
    quad = os.path.join(OUT_DIR, "tri_zoo_mirror.obj")
    with open(quad, "w") as f:
        f.write("v -1.5 -0.5 -2.5\nv 1.5 -0.5 -2.5\nv 1.5 1.3 -2.6\n"
                "v -1.5 1.3 -2.6\nf 1 2 3\nf 1 3 4\n")
    with open(ZOO) as f:
        d = json.load(f)
    mix = next(i for i, m in enumerate(d["materials"])
               if m["type"] == "MixMaterial")
    mirror = next(i for i, m in enumerate(d["materials"])
                  if m["type"] == "Metal" and m["fuzz"] == 0.0)
    d["objects"] += [{"type": "Mesh", "path": ico, "material": mix},
                     {"type": "Mesh", "path": quad, "material": mirror}]
    d["settings"]["enable_bvh_tree"] = False
    zoo = os.path.join(OUT_DIR, "tri_zoo.json")
    with open(zoo, "w") as f:
        json.dump(d, f)
    fw, fh, f_spp = ZOO_FIT
    zoo_sky = _write_scene(zoo, "tri_zoo_sky.json", sky=True,
                           env_importance_sampling=False,
                           samples_per_pixel=f_spp)
    return [("tri_brute", brute, (w, h), TRI_FIT),
            ("tri_zoo", zoo, ZOO_RENDER, ZOO_FIT),
            ("tri_zoo_sky", zoo_sky, (fw, fh), ZOO_FIT)]


def tri_phase(dev, card: str) -> list:
    """Phase 14; -> the report entries of #1's, #3's and #4's triangle
    variants (kTri, with kExt and kSky)."""
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.diff import grad as G
    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.render.render import (render_linear,
                                                        select_engine)
    from raytracingrust_tpu_torch.utils import rng

    key = rng.base_key(14)
    gen = np.random.default_rng(14)
    shapes = tri_scenes()
    fwd, grads, cli_counts = {}, {}, {}
    for label, path, (rw, rh), (fw, fh, f_spp) in shapes:
        scene = _load(path)
        opts = K.scene_opts(scene)
        if (select_engine(scene), select_engine(scene, grad=True)) != (
                "brute", "brute"):
            raise AssertionError(f"{label} is not sent to the brute kernels")
        r_spp = scene.settings.samples_per_pixel
        f = _brute_forward_check(label, scene, rw, rh, dev, key)
        fwd[label] = f
        c = f["count"]
        print(f"phase 14 {label} {rw}x{rh} spp {r_spp} depth "
              f"{opts['max_depth']} ({len(scene.spheres)} spheres, "
              f"{len(scene.triangles)} triangles in {opts['n_tm']} "
              f"materials, mixes {opts['mix']}, volumes {opts['n_vol']}, "
              f"isotropic {opts['iso']}, sky map "
              f"{scene.background.kind == 2}): #1 radiance == plain bit for "
              f"bit at depth 1 and depth {opts['max_depth']} on all "
              f"{rw * rh * r_spp} rays; per ray "
              f"{c.bounces / (rw * rh * r_spp):.3f} bounces, triangle hits "
              f"{c.tri_hits}, hits by kind {[c.hits[k] for k in range(5)]}, "
              f"misses {c.misses}; #1 {f['ms']:.4f} ms, plain "
              f"{f['plain_ms']:.1f} ms, bound {f['bound'][0]:.5f} ms "
              f"({f['bound'][1]}; {f['ops']:.4g} FP32 operations); {card}")
        fit_scene = _load(path, spp=f_spp)
        g = _brute_grad_check(label, fit_scene, fw, fh, dev, key, gen,
                              fused=scene.background.kind != 2)
        grads[label] = g
        texels = (f", the texels' gradient ({g['texels']} texels)"
                  if "texels" in g else "")
        fused = (f"; #4 max abs diff {g['err4']:.3e}, {g['ms4']:.3f} ms "
                 f"(plain autograd {g['plain4_ms']:.1f} ms), bound "
                 f"{g['bound4'][0]:.5f} ms ({g['bound4'][1]})"
                 if "err4" in g else "")
        print(f"phase 14 {label} gradients at {fw}x{fh} spp {g['spp']} "
              f"(autograd of the plain version over ranges of "
              f"{BRUTE_PLAIN_RAYS} rays, summed; peak "
              f"{g['plain_peak_gb']:.1f} GB; finite everywhere): #3 max abs "
              f"diff {g['err3']:.3e}{texels} (allowed {GRAD_RTOL:g} rel + "
              f"{GRAD_ATOL:g} of max), finite; #3 {g['ms3']:.3f} ms (plain "
              f"autograd {g['plain3_ms']:.1f} ms), bound "
              f"{g['bound3'][0]:.5f} ms ({g['bound3'][1]}){fused}; {card}")

    # FD probes: the sheet's albedos (make_loss: #4), the zoo's icosphere
    # mix leaves and mirror (#4), the sky's texel of largest gradient (#1,
    # #3)
    probes = []
    for label, path, _, (fw, fh, f_spp) in shapes[:2]:
        sc = _load(path, spp=f_spp)
        tm = K.tri_slots(sc)[0]
        mats = sc.materials
        rows = torch.cat([tm, mats.mix_first[tm].long(),
                          mats.mix_second[tm].long()]).unique().tolist()
        ad, fd = _fd_probe(label, sc, dev, fw, fh, key, ["albedo"], gen,
                           {"albedo": rows})
        probes.append(f"{label} {fw}x{fh} spp {f_spp} albedo rows {rows} "
                      f"(the triangles' materials and leaves; #4): AD "
                      f"{ad:.6e}, FD {fd:.6e}")
    label, path, _, (fw, fh, f_spp) = shapes[2]
    sky_fit = _load(path)
    with torch.no_grad():
        s_target = render_linear(sky_fit, fw, fh, seed=12, device=dev) * 0.9
    texel, t_ad, t_fd = _texel_fd_probe(label, sky_fit, dev, fw, fh, key,
                                        s_target)
    probes.append(f"{label} {fw}x{fh} spp {f_spp} texel {texel} (eps "
                  f"{FD_TEXEL_EPS:g}; #1, #3): AD {t_ad:.6e}, FD {t_fd:.6e}")
    print(f"phase 14 FD probes (eps {FD_EPS:g}, rtol 5%): "
          + "; ".join(probes))

    # ---- the main path, through the CLI entry
    for label, path, (rw, rh), (fw, fh, f_spp) in shapes:
        png = os.path.join(OUT_DIR, f"{label}.png")
        _reset_launches()
        _cli_render(path, png, ["--width", str(rw), "--height", str(rh)])
        cli_counts[label, "render"] = _launches()
        _check_png(png, rw, rh, label)
        dim = _write_scene(path, f"{label}_dim.json", dim=True)
        target_png = os.path.join(OUT_DIR, f"{label}_fit_target.png")
        _cli_render(dim, target_png, ["--width", str(fw), "--height",
                                      str(fh), "--spp", str(f_spp)], seed=1)
        counts, first, final, _ = _cli_fit(path, target_png,
                                           ["--spp", str(f_spp)])
        cli_counts[label, "fit"] = counts
        r = cli_counts[label, "render"]
        print(f"phase 14 CLI {label}: render {rw}x{rh}: launches #1 "
              f"{r['brute']} (triangle variant {r['brute_tri']}), #5 "
              f"{r['fwd'] + r['sky']}; fit {fw}x{fh} spp {f_spp}, "
              f"{CLI_FIT_STEPS} steps of {CLI_FIT_PARAMS}: loss {first:.6f} "
              f"-> {final:.6f}, launches #1 {counts['brute']}, #3 "
              f"{counts['grad']}, #4 {counts['fused']} (triangle variants "
              f"{counts['brute_tri']}, {counts['grad_tri']}, "
              f"{counts['fused_tri']}), record #5 {counts['record']}")
    render = {k[0]: v for k, v in cli_counts.items() if k[1] == "render"}
    fits = {k[0]: v for k, v in cli_counts.items() if k[1] == "fit"}
    steps = CLI_FIT_STEPS
    # (#1 in the render; #1, #3, #4 in the fit), all of them triangle
    # variants: the fused kernel a step, or under a sky map the forward
    # and the radiance gradient kernels
    want = {"tri_brute": (1, 0, 0, steps), "tri_zoo": (1, 0, 0, steps),
            "tri_zoo_sky": (1, steps, steps, 0)}
    for label, counts in want.items():
        r, f = render[label], fits[label]
        got = (r["brute"], f["brute"], f["grad"], f["fused"])
        tri = (r["brute_tri"], f["brute_tri"], f["grad_tri"], f["fused_tri"])
        ext = label != "tri_brute"
        if got != counts or tri != counts or (
                r["brute_ext"], f["fused_ext"] + f["grad_ext"]) != (
                int(ext), steps * ext) or any(
                cli_counts[k][n] for k in cli_counts
                for n in ("fwd", "sky", "record", "view", "mv")):
            raise AssertionError(f"{label}: the CLI launched {cli_counts}")

    # a loss of the caller's own on tri_brute: #1 forward, #3 backward
    fw, fh, f_spp = TRI_FIT
    sc_dev = _load(shapes[0][1], spp=f_spp).to(dev)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.extract_params(sc_dev, ["albedo"]).items()}
    _reset_launches()
    img = render_linear(G.apply_params(sc_dev, params), fw, fh, seed=0,
                        device=dev)
    img.abs().mean().backward()
    l1 = _launches()
    l1_counts = (l1["brute_tri"], l1["grad_tri"], l1["fused"])
    if l1_counts != (1, 1, 0) or not bool(
            torch.isfinite(params["albedo"].grad).all()):
        raise AssertionError(f"tri_brute's L1 loss launched {l1_counts}")

    # ---- warm renders and fit steps; tri_brute with its BVH on #5
    walls = {}
    for label, path, (rw, rh), (fw, fh, f_spp) in shapes:
        scene = _load(path)
        best, mean = _warm_render(scene, rw, rh, dev, label)
        r_rays = rw * rh * scene.settings.samples_per_pixel

        def renders(step, scene=scene, rw=rw, rh=rh):
            for _ in range(3):
                render_linear(scene, rw, rh, seed=0, device=dev)
                torch.cuda.synchronize()
                step()

        part = _profile(renders, 2)
        fit_scene = _load(path, spp=f_spp)
        target = (read_png(os.path.join(OUT_DIR, f"{label}_fit_target.png"))
                  [..., :3].astype(np.float32) / 255.0) ** 2
        names = (BENCH_PARAMS if label == "tri_brute"
                 else CLI_FIT_PARAMS).split(",")
        r = _warm_fit(fit_scene, target, names, fw, fh, dev)
        if not r["history"][-1] < r["history"][0]:
            raise AssertionError(f"the warm {label} fit's loss did not "
                                 f"fall: {r['history']}")
        walls[label] = (best, r["warm_ms"])
        print(f"phase 14 {label} {rw}x{rh}: warm render {best:.4f} s, "
              f"{r_rays / best / 1e6:.1f} primary Mrays/s, image mean "
              f"{mean:.5f}; per render under torch.profiler: "
              + _parts(part, ("#1", "replay and rest", "busy"))
              + f", host (warm render - busy) "
              f"{best * 1e3 - part['busy']:.3f} ms; fit step {fw}x{fh} spp "
              f"{f_spp} ({','.join(names)}): warm step {r['warm_ms']:.3f} "
              f"ms (median of {r['n']}), "
              f"{fw * fh * f_spp / r['warm_ms'] / 1e3:.2f} primary Mrays/s "
              f"fwd+bwd, peak memory {r['peak_gb']:.2f} GB; loss "
              f"{r['history'][0]:.6f} -> {r['history'][-1]:.6f}; per step "
              f"under torch.profiler: "
              + _parts(r["part"], ("#1", "#3", "#4", "replay and rest",
                                   "busy"))
              + f", host (warm step - busy) "
              f"{r['warm_ms'] - r['part']['busy']:.3f} ms; {card}")

    # the route comparison (ROADMAP A10): tri_brute built with its BVH
    # takes #5 (the dispatch's route for it), by name here
    label, path, (rw, rh), (fw, fh, f_spp) = shapes[0]
    b = SceneBuilder.from_file(path)
    with_bvh = b.build(with_bvh=True)
    if select_engine(with_bvh) != "bvh":
        raise AssertionError("tri_brute with its BVH is not sent to #5")
    sc = BK.pack(with_bvh, rw, rh, dev)
    bvh_opts = dict(max_depth=with_bvh.settings.max_ray_depth,
                    bg_kind=with_bvh.background.kind, clay=False)
    spp = with_bvh.settings.samples_per_pixel
    bvh_ms = _cuda_time_ms(lambda: BK.radiance_bvh_cuda(
        sc, key, rw * rh * spp, spp, rw, **bvh_opts), 5)
    bvh_best, _ = _warm_render(with_bvh, rw, rh, dev, label, engine="bvh")
    target = (read_png(os.path.join(OUT_DIR, f"{label}_fit_target.png"))
              [..., :3].astype(np.float32) / 255.0) ** 2
    fit_bvh = SceneBuilder.from_file(path)
    fit_bvh.settings = dataclasses.replace(fit_bvh.settings,
                                           samples_per_pixel=f_spp)
    r = _warm_fit(fit_bvh.build(with_bvh=True), target,
                  BENCH_PARAMS.split(","), fw, fh, dev, engine="bvh")
    print(f"phase 14 route comparison, tri_brute with its BVH on #5 "
          f"(engine='bvh'; the dispatch's route for it): #5 {bvh_ms:.4f} ms "
          f"against #1 kTri {fwd[label]['ms']:.4f} ms at {rw}x{rh} spp "
          f"{spp} depth {bvh_opts['max_depth']}; warm render {bvh_best:.4f}"
          f" s against {walls[label][0]:.4f} s; warm fit step {fw}x{fh} spp "
          f"{f_spp} on the record walk and replay {r['warm_ms']:.3f} ms "
          f"against {walls[label][1]:.3f} ms on #4; {card}")
    print(f"phase 14 ptxas: {_ptxas_variants()}")

    b_, z, s = fwd["tri_brute"], fwd["tri_zoo"], fwd["tri_zoo_sky"]
    gb, gz, gs = (grads[k] for k in ("tri_brute", "tri_zoo",
                                     "tri_zoo_sky"))
    return [
        # the CLI render of tri_brute; times at 1000x1000 spp 8 depth 6
        _entry("brute_forward_tri", "megakernel.cu", "2089",
               render["tri_brute"]["brute_tri"], b_["err"], b_["ms"],
               b_["plain_ms"], b_["bound"]),
        # the CLI render of tri_zoo; times at 1200x800 spp 32 depth 8
        _entry("brute_forward_ext_tri", "megakernel.cu", "2089",
               render["tri_zoo"]["brute_tri"], z["err"], z["ms"],
               z["plain_ms"], z["bound"]),
        # the CLI render of tri_zoo_sky; times at 600x400 spp 16 depth 8
        _entry("brute_forward_ext_sky_tri", "megakernel.cu", "2089",
               render["tri_zoo_sky"]["brute_tri"], s["err"], s["ms"],
               s["plain_ms"], s["bound"]),
        # tri_brute's L1 loss through render_linear; times at 512x512
        _entry("radiance_grad_tri", "radiance_grad.cu", "2133", l1_counts[1],
               gb["err3"], gb["ms3"], gb["plain3_ms"], gb["bound3"]),
        # the CLI fit of tri_zoo_sky; times at 600x400 spp 16
        _entry("radiance_grad_ext_sky_tri", "radiance_grad.cu", "2133",
               fits["tri_zoo_sky"]["grad_tri"], gs["err3"], gs["ms3"],
               gs["plain3_ms"], gs["bound3"]),
        # the CLI fit of tri_brute; times at 512x512 spp 8
        _entry("fused_mse_loss_tri", "mse_loss.cu", "2411",
               fits["tri_brute"]["fused_tri"], gb["err4"], gb["ms4"],
               gb["plain4_ms"], gb["bound4"]),
        # the CLI fit of tri_zoo; times at 600x400 spp 16
        _entry("fused_mse_loss_ext_tri", "mse_loss.cu", "2411",
               fits["tri_zoo"]["fused_tri"], gz["err4"], gz["ms4"],
               gz["plain4_ms"], gz["bound4"]),
    ]


def main() -> int:
    """Every phase; with the one argument "12" or "14", the build and
    that phase alone, with its report entries and no last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from raytracingrust_tpu_torch import cli
    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models.backgrounds import Background
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.render.render import render_linear
    from raytracingrust_tpu_torch.utils import rng

    dev = torch.device("cuda")
    t_run = time.perf_counter()

    # ---- 1. card, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card)
    t0 = time.perf_counter()
    for name in _build.SOURCES:  # the first load builds all of them
        _build.load(name)
    build_s = time.perf_counter() - t0
    regs = " | ".join(f"{name}: {_ptxas(name)}" for name in _build.SOURCES)
    print(f"phase 1 build ({len(_build.SOURCES)} sources in parallel): "
          f"{build_s:.3f} s; {regs}")
    alone = {"12": fog_phase, "14": tri_phase}
    if len(sys.argv) == 2 and sys.argv[1] in alone:  # for working on it
        os.makedirs(OUT_DIR, exist_ok=True)
        if not os.path.exists(SKY):
            procedural_sky(SKY)
        print(json.dumps({"kernels": alone[sys.argv[1]](dev, card)}))
        print(f"phase {sys.argv[1]} alone: "
              f"{time.perf_counter() - t_run:.1f} s")
        return 0

    # ---- 2. RNG bit for bit
    key = rng.base_key(SEED_WORDS_HIGH)
    n_ids = 1 << 16
    ids = torch.cat([torch.arange(n_ids // 2, dtype=torch.int32),
                     (2 ** 31 - 1) - torch.arange(n_ids // 2,
                                                  dtype=torch.int32)]).to(dev)
    for stream in (0, 1, 7):
        got = K.uniforms_cuda(key, ids, stream, 5)
        want = rng.ray_uniforms(key, ids, stream, 5)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"rtrt_uniforms differs from ray_uniforms "
                                 f"(stream {stream})")
    print(f"phase 2 rng: rtrt_uniforms == ray_uniforms bit for bit, "
          f"{n_ids} ids x streams 0/1/7 x 5 columns, key words "
          f"{key[0]:#x} {key[1]:#x}")

    # ---- 3. kernel vs plain on the card
    def scene_of(path, spp, depth, mode="Full", bg=None):
        b = SceneBuilder.from_file(path)
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                         max_ray_depth=depth, mode=mode)
        if bg is not None:
            b.background = bg
        return b.build()

    def launchers(scene, w, h, seed, observe=None):
        """(kernel, plain): closures computing the per-ray radiance of the
        same rays, one through the CUDA kernel, one through the plain
        PyTorch version (which passes its masks to ``observe``)."""
        s = scene.settings
        fp = K.pack_fparams(scene, w, h).to(dev)
        kinds = K.sphere_kinds(scene).to(dev)
        opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                    clay=s.mode == "Clay")
        k = rng.base_key(seed)
        spp = s.samples_per_pixel
        ray_ids, px, py = K.prep_rays(
            torch.arange(w * h, device=dev), spp, w)
        return (lambda: K.radiance_cuda(fp, kinds, k, w * h * spp, spp, w,
                                        **opts),
                lambda: K.radiance_plain(fp, kinds, k, ray_ids, px, py,
                                         observe=observe, **opts))

    def forward_bound(scene, w, h, seed):
        """Kernel #1's least time for this frame: the forward chain over the
        bounces its rays traced, or the scene read once and 12 bytes of
        output a ray written once."""
        count = _Count()
        with torch.no_grad():
            launchers(scene, w, h, seed, observe=count)[1]()
        n_rays = w * h * scene.settings.samples_per_pixel
        n_sph = K.sphere_kinds(scene).shape[0]
        return _bound(count.forward_ops(n_rays, n_sph, scene.background.kind),
                      4 * K.pack_fparams(scene, w, h).numel() + 4 * n_sph
                      + 12 * n_rays)

    def image(rad, scene):
        s = scene.settings
        return rad.clamp(0.0, s.clamp_indirect).view(
            -1, s.samples_per_pixel, 3).mean(dim=1)

    def check_exact(scene, w, h, label):
        """The kernel's per-ray radiance equals the plain version's bit for
        bit; returns the max abs difference (0.0)."""
        ker_fn, plain_fn = launchers(scene, w, h, 11)
        ker, plain = ker_fn(), plain_fn()
        if not torch.equal(ker.view(torch.int32), plain.view(torch.int32)):
            bad = (ker.view(torch.int32)
                   != plain.view(torch.int32)).any(dim=1)
            raise AssertionError(
                f"{label}: kernel != plain in {int(bad.sum())} of "
                f"{bad.numel()} rays (depth {scene.settings.max_ray_depth}), "
                f"max abs diff {(ker - plain).abs().max().item():.3e}")
        return (ker - plain).abs().max().item()

    def seed_noise(scene, w, h):
        """Mean abs diff of the plain version's seed-11 and seed-12 images:
        the Monte-Carlo noise, printed as the scale of a full-depth fault."""
        a = image(launchers(scene, w, h, 11)[1](), scene)
        b = image(launchers(scene, w, h, 12)[1](), scene)
        return (a - b).abs().mean().item()

    def depth1(scene):
        return dataclasses.replace(scene, settings=dataclasses.replace(
            scene.settings, max_ray_depth=1))

    grad = Background.gradient((0.5, 0.7, 1.0), (1.0, 1.0, 1.0))
    check_exact(scene_of(BENCH, 4, 1), 64, 48, "64x48 depth 1")
    parts = []
    for label, sc in (("full", scene_of(BENCH, 4, 6)),
                      ("clay", scene_of(BENCH, 4, 6, mode="Clay")),
                      ("gradient", scene_of(BENCH, 4, 6, bg=grad))):
        check_exact(sc, 64, 48, f"64x48 {label}")
        parts.append(f"{label} (seed noise {seed_noise(sc, 64, 48):.3e})")
    print("phase 3 kernel vs plain at 64x48 spp 4: per-ray radiance bit "
          "for bit equal at depth 1 and at depth 6: " + ", ".join(parts))

    # the same comparison at the main path's shapes, with times
    max_err = 0.0
    radiance_ms = {}  # path -> (kernel ms, plain ms)
    fwd_bound = {}  # path -> (bound ms, what bounds it)
    for path, w, h, spp, depth, reps in ((BENCH, 512, 512, 8, 6, (20, 3)),
                                         (CORNELL, 1000, 1000, 64, 8, (5, 1))):
        sc = scene_of(path, spp, depth)
        label = f"{path} {w}x{h} spp {spp} depth {depth}"
        check_exact(depth1(sc), w, h, label + " (at depth 1)")
        max_err = max(max_err, check_exact(sc, w, h, label))
        noise = seed_noise(sc, w, h)
        ker_fn, plain_fn = launchers(sc, w, h, 0)
        radiance_ms[path] = (_cuda_time_ms(ker_fn, reps[0]),
                             _cuda_time_ms(plain_fn, reps[1], warm=False))
        fwd_bound[path] = forward_bound(sc, w, h, 0)
        print(f"phase 3 {label}: per-ray radiance bit for bit equal at "
              f"depth 1 and depth {depth} (seed noise {noise:.3e}); "
              f"radiance kernel {radiance_ms[path][0]:.4f} ms, plain "
              f"{radiance_ms[path][1]:.3f} ms, bound "
              f"{fwd_bound[path][0]:.5f} ms ({fwd_bound[path][1]})")
    ms, plain_ms = radiance_ms[BENCH]

    # ---- 4. the main path, through the CLI entry
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = [  # (scene, width, height, spp, depth, CLI flags)
        (BENCH, 512, 512, 8, 6, ["--width", "512", "--height", "512",
                                 "--spp", "8", "--depth", "6"]),
        (CORNELL, 1000, 1000, 64, 8, []),  # the CLI's and scene's defaults
    ]

    def png_of(path):
        return os.path.join(OUT_DIR, os.path.basename(path)[:-5] + ".png")

    K.LAUNCHES = 0
    for path, *_, flags in runs:
        rc = cli.main(["render", path, *flags, "-o", png_of(path),
                       "--seed", "0"])
        if rc != 0:
            raise AssertionError(f"cli render {path} returned {rc}")
    launches = K.LAUNCHES
    if launches < len(runs):
        raise AssertionError(f"the CLI renders launched the kernel "
                             f"{launches} times, expected {len(runs)}")
    for path, w, h, spp, depth, _ in runs:
        png = read_png(png_of(path))
        if png.shape != (h, w, 4) or png[..., :3].min() == png[..., :3].max():
            raise AssertionError(f"{path}: PNG {png.shape} is flat or "
                                 f"misshapen")
        scene = scene_of(path, spp, depth)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = render_linear(scene, w, h, seed=0, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(img).all()) or img.std().item() == 0.0:
            raise AssertionError(f"{path}: image not finite or flat")
        best = min(times)
        print(f"phase 4 {path} {w}x{h} spp {spp} depth {depth}: warm render "
              f"{best:.4f} s, {w * h * spp / best / 1e6:.1f} primary "
              f"Mrays/s (kernel), image mean {img.mean().item():.5f}")
    print(f"phase 4 CLI renders: {launches} forward kernel launches")
    print(f"phase 4 plain version at {BENCH} 512x512 spp 8 depth 6: "
          f"radiance {plain_ms / 1e3:.4f} s, "
          f"{512 * 512 * 8 / plain_ms / 1e3:.1f} primary Mrays/s")

    # ---- 5. gradient kernels vs autograd through the plain version
    import numpy as np

    from raytracingrust_tpu_torch.diff import grad as G
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.io.png import write_png
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import radiance_grad as RG
    from raytracingrust_tpu_torch.render.render import render

    def compare(got, want, label):
        """Every entry within GRAD_RTOL of the plain version's or GRAD_ATOL
        of its largest entry; returns the max abs difference."""
        err = (got - want).abs()
        allowed = GRAD_RTOL * want.abs() + GRAD_ATOL * want.abs().max()
        if not bool(torch.isfinite(got).all()) or bool((err > allowed).any()):
            worst = int((err - allowed).argmax())
            raise AssertionError(
                f"{label}: kernel gradient differs from plain autograd at "
                f"entry {worst}: {got[worst].item():.6e} vs "
                f"{want[worst].item():.6e} (allowed {allowed[worst]:.3e}); "
                f"max abs diff {err.max().item():.3e}")
        return err.max().item()

    def groups(scene, names):
        """fparams entries of each named parameter group."""
        kinds = K.sphere_kinds(scene).tolist()
        sph = [K._SPHERES + i * K._SPHERE_STRIDE for i in range(len(kinds))]

        def of(offset, count, kind_ids=(0, 1, 2, 3)):
            return [b + offset + c for b, k in zip(sph, kinds)
                    if k in kind_ids for c in range(count)]

        table = {
            "camera": list(range(K._CAM, K._CAM + 12)),
            "bg_color_a": list(range(K._BG, K._BG + 3)),
            "bg_color_b": list(range(K._BG + 3, K._BG + 6)),
            "albedo": of(K._ALBEDO, 3, (0, 1)),
            "fuzz": of(K._FUZZ, 1, (1,)),
            "ir": of(K._IR, 1, (2,)),
            "emission": of(K._EMISSION, 3, (3,)),
            "sphere_center": of(K._CENTER, 3),
            "sphere_radius": of(K._RADIUS, 1),
        }
        return {n: table[n] for n in names}

    def check_nonzero(dfp, scene, names, label):
        for name, idx in groups(scene, names).items():
            if not idx or dfp[idx].abs().sum().item() == 0.0:
                raise AssertionError(f"{label}: the gradient of {name} is "
                                     f"zero")

    def grad_inputs(scene, w, h, seed):
        s = scene.settings
        fp = K.pack_fparams(scene, w, h).to(dev)
        kinds = K.sphere_kinds(scene).to(dev)
        opts = dict(max_depth=s.max_ray_depth,
                    bg_kind=scene.background.kind, clay=s.mode == "Clay")
        gen = np.random.default_rng(0)
        cts = torch.tensor(gen.standard_normal(
            (w * h * s.samples_per_pixel, 3)), dtype=torch.float32,
            device=dev)
        target = torch.tensor(gen.random((w * h, 3)), dtype=torch.float32,
                              device=dev)
        return fp, kinds, rng.base_key(seed), cts, target, opts

    def fused_plain(fp, kinds, key, target, spp, w, clamp, opts):
        fpg = fp.clone().requires_grad_(True)
        loss = MS.mse_loss_plain(fpg, kinds, key, target, spp, w,
                                 clamp=clamp, **opts)
        (dfp,) = torch.autograd.grad(loss, fpg)
        return loss.detach(), dfp

    all_bg = ["albedo", "emission", "bg_color_a"]
    geometry = ["bg_color_b", "camera", "fuzz", "ir", "sphere_center",
                "sphere_radius"]
    cases = [  # (label, scene, width, height, groups with a gradient)
        ("uniform 64x48", scene_of(BENCH, 5, 6), 64, 48, all_bg),
        ("gradient 64x48", scene_of(BENCH, 5, 6, bg=grad), 64, 48,
         all_bg + geometry),
        ("clay 64x48", scene_of(BENCH, 5, 6, mode="Clay", bg=grad), 64, 48,
         ["bg_color_a", "bg_color_b", "camera", "sphere_center"]),
        ("benchmark 512x512", scene_of(BENCH, 8, 6), 512, 512, all_bg),
    ]
    grad_err = {"mse": 0.0, "grad": 0.0}
    for label, sc, w, h, names in cases:
        s = sc.settings
        spp, clamp = s.samples_per_pixel, s.clamp_indirect
        fp, kinds, key, cts, target, opts = grad_inputs(sc, w, h, 11)
        loss, dfp = MS.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                     clamp=clamp, **opts)
        p_loss, p_dfp = fused_plain(fp, kinds, key, target, spp, w, clamp,
                                    opts)
        loss_err = abs(loss.item() - p_loss.item())
        if loss_err > LOSS_RTOL * abs(p_loss.item()):
            raise AssertionError(f"{label}: fused loss {loss.item():.9e} vs "
                                 f"plain {p_loss.item():.9e}")
        e4 = compare(dfp, p_dfp, f"{label} fused loss kernel")
        g = RG.radiance_grad_cuda(fp, kinds, key, cts, spp, w, **opts)
        p_g = RG.radiance_grad_plain(fp, kinds, key, cts, spp, w, **opts)
        e3 = compare(g, p_g, f"{label} radiance gradient kernel")
        for vec, which in ((dfp, "fused"), (p_dfp, "fused plain"),
                           (g, "radiance grad"), (p_g, "radiance plain")):
            check_nonzero(vec, sc, names, f"{label} {which}")
        grad_err["mse"] = max(grad_err["mse"], e4)
        grad_err["grad"] = max(grad_err["grad"], e3)
        print(f"phase 5 {label} spp {spp} depth {s.max_ray_depth}: fused "
              f"loss {loss.item():.7e} (plain {p_loss.item():.7e}, diff "
              f"{loss_err:.2e}, allowed {LOSS_RTOL:g} rel); dfparams max "
              f"abs diff {e4:.3e} (fused), {e3:.3e} (radiance grad), "
              f"allowed {GRAD_RTOL:g} rel + {GRAD_ATOL:g} of max; nonzero: "
              f"{', '.join(names)}")
    grad_err["mse"] = max(grad_err["mse"], fused_group_check(dev, card))

    # bench.py::run_parity's directional FD probe, on the fused kernel's
    # own loss: AD through the Function vs central differences
    sc = scene_of(BENCH, 5, 6)
    w, h = 64, 48
    fp, kinds, _, _, _, opts = grad_inputs(sc, w, h, 11)
    probe_target = render_linear(sc, w, h, seed=11, device=dev) * 0.9
    key = rng.base_key(3)
    sc_dev = sc.to(dev)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.extract_params(sc_dev, all_bg).items()}
    gen = np.random.default_rng(0)
    v = {k: torch.tensor(gen.standard_normal(tuple(p.shape)),
                         dtype=torch.float32, device=dev)
         for k, p in params.items()}
    value = G.make_loss(sc, probe_target, w, h, device=dev)(params, key)
    value.backward()
    ad = sum((params[k].grad * v[k]).sum().item() for k in params)

    def kernel_loss(p):
        fpp = K.pack_fparams(G.apply_params(sc_dev, p), w, h)
        return MS.mse_loss_cuda(
            fpp, kinds, key, probe_target.reshape(-1, 3), 5, w,
            clamp=sc.settings.clamp_indirect, **opts)[0].item()

    eps = 1e-3
    with torch.no_grad():
        fd = (kernel_loss({k: p + eps * v[k] for k, p in params.items()})
              - kernel_loss({k: p - eps * v[k] for k, p in params.items()})
              ) / (2 * eps)
    if not abs(ad - fd) <= 0.05 * max(abs(fd), 1e-6):
        raise AssertionError(f"FD probe: AD {ad:.6e} vs FD {fd:.6e}")
    print(f"phase 5 FD probe of the fused loss at 64x48 spp 5 depth 6 "
          f"({', '.join(all_bg)}; eps {eps:g}, rtol 5%): AD {ad:.6e}, "
          f"FD {fd:.6e}")

    # times and bounds at the main path's shape
    sc = scene_of(BENCH, 8, 6)
    w = h = 512
    spp = 8
    clamp = sc.settings.clamp_indirect
    fp, kinds, key, cts, target, opts = grad_inputs(sc, w, h, 0)
    tally = _Tally(opts["max_depth"])
    ray_ids, px, py = K.prep_rays(torch.arange(w * h, device=dev), spp, w)
    with torch.no_grad():
        K.radiance_plain(fp, kinds, key, ray_ids, px, py, observe=tally,
                         **opts)
    n_rays, n_sph = w * h * spp, kinds.shape[0]
    k_f = fp.numel()
    fwd_ops = tally.forward_ops(n_rays, n_sph, opts["bg_kind"])
    adj_ops = tally.adjoint_ops(opts["bg_kind"])
    loss_ops = n_rays * OPS_LOSS_RAY + w * h * OPS_LOSS_PIXEL
    scene_bytes = 4 * k_f + 4 * n_sph  # fparams and kinds, read once
    bounds = {  # each function once: one forward, one reverse sweep
        "grad": _bound(fwd_ops + adj_ops,
                       scene_bytes + 12 * n_rays + 4 * k_f),
        "mse": _bound(fwd_ops + adj_ops + loss_ops,
                      scene_bytes + 12 * w * h + 4 * (k_f + 1)),
    }
    times = {
        "grad": (_cuda_time_ms(lambda: RG.radiance_grad_cuda(
            fp, kinds, key, cts, spp, w, **opts), 10),
                 _cuda_time_ms(lambda: RG.radiance_grad_plain(
                     fp, kinds, key, cts, spp, w, **opts), 1, warm=False)),
        "mse": (_cuda_time_ms(lambda: MS.mse_loss_cuda(
            fp, kinds, key, target, spp, w, clamp=clamp, **opts), 10),
                _cuda_time_ms(lambda: fused_plain(
                    fp, kinds, key, target, spp, w, clamp, opts), 1,
                    warm=False)),
    }
    print(f"phase 5 {BENCH} 512x512 spp 8 depth 6: rays traced "
          f"{tally.bounces / n_rays:.3f} bounces each (hits by kind "
          f"{[tally.hits[k] for k in range(4)]}, misses {tally.misses}); "
          f"FP32 operations forward {fwd_ops}, reverse {adj_ops}, loss "
          f"{loss_ops}; "
          f"radiance gradient kernel {times['grad'][0]:.3f} ms (plain "
          f"autograd {times['grad'][1]:.1f} ms), fused loss kernel "
          f"{times['mse'][0]:.3f} ms (plain autograd "
          f"{times['mse'][1]:.1f} ms); bounds "
          + ", ".join(f"{k} {b[0]:.5f} ms ({b[1]})" for k, b in
                      bounds.items()))

    # ---- 6. the fit path, through the CLI entry
    true = scene_of(BENCH, 8, 6)
    perturbed = G.apply_params(true, {
        "albedo": (true.materials.albedo
                   * torch.tensor([0.7, 0.9, 1.2])).clamp(max=1.0)})
    target_png = os.path.join(OUT_DIR, "fit_target.png")
    fitted_png = os.path.join(OUT_DIR, "fit_result.png")
    write_png(target_png, render(perturbed, 512, 512, seed=1, device=dev))
    steps = 6
    K.LAUNCHES = RG.LAUNCHES = MS.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit", BENCH, target_png, "--params", BENCH_PARAMS,
                       "--steps", str(steps), "--spp", "8", "--depth", "6",
                       "--seed", "0", "-o", fitted_png])
    text = buf.getvalue()
    cli_counts = (K.LAUNCHES, RG.LAUNCHES, MS.LAUNCHES)
    if rc != 0 or cli_counts != (1, 0, steps):
        raise AssertionError(f"cli fit returned {rc}, launches (forward, "
                             f"radiance grad, fused) {cli_counts}, expected "
                             f"(1, 0, {steps})\n{text}")
    first = float(text.split("step 0: loss")[1].split()[0])
    final = float(text.split("final loss")[1].split()[0])
    if not (np.isfinite(first) and np.isfinite(final) and final < first):
        raise AssertionError(f"cli fit loss did not fall: {first} -> "
                             f"{final}\n{text}")
    print(f"phase 6 cli fit {BENCH} 512x512 spp 8 depth 6, {steps} steps "
          f"of {BENCH_PARAMS}: loss {first:.6f} -> {final:.6f}; launches "
          f"fused {cli_counts[2]}, forward {cli_counts[0]} (the fitted "
          f"render), radiance grad {cli_counts[1]}")

    # warm step time of the fit entry, on the same target
    target_lin = (read_png(target_png)[..., :3].astype(np.float32)
                  / 255.0) ** 2
    ticks = []

    def tick(i, value, params):
        ticks.append(time.perf_counter())  # after float(loss): synced

    MS.LAUNCHES = 0
    t0 = time.perf_counter()
    _, _, history = fit(true, target_lin, BENCH_PARAMS.split(","), 512, 512,
                        steps=8, device=dev, callback=tick)
    fit_launches = MS.LAUNCHES
    step_s = sorted(b - a for a, b in zip(ticks[1:], ticks[2:]))
    warm = step_s[len(step_s) // 2]
    if fit_launches != 8 or not all(np.isfinite(history)):
        raise AssertionError(f"fit: {fit_launches} fused launches for 8 "
                             f"steps, history {history}")
    print(f"phase 6 fit entry, 8 steps, {fit_launches} fused launches: "
          f"first step "
          f"{(ticks[0] - t0) * 1e3:.2f} ms, warm step {warm * 1e3:.3f} ms "
          f"(median of {len(step_s)}; fused kernel + Adam), "
          f"{512 * 512 * 8 / warm / 1e6:.1f} primary Mrays/s fwd+bwd; loss "
          f"{history[0]:.6f} -> {history[-1]:.6f}")

    # where the warm step's time goes: device time by kernel, 4 steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit(true, target_lin, BENCH_PARAMS.split(","), 512, 512, steps=4,
            device=dev)
    device_ms = collections.Counter()
    for evt in prof.key_averages():
        # user annotations (Optimizer.step#Adam.step) span the kernels
        # they launch: counting them would count those kernels twice
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            device_ms[evt.key] += getattr(evt, "self_device_time_total",
                                          0.0) / 1e3 / 4
    busy = sum(device_ms.values())
    print(f"phase 6 fit step under torch.profiler (per step, 4 steps): "
          f"device {busy:.3f} ms, {busy / (warm * 1e3):.2f} of the warm "
          f"step; " + ", ".join(f"{k[:48]} {v:.4f} ms"
                               for k, v in device_ms.most_common(6)))

    # a loss of the caller's own through render_linear: forward kernel,
    # then the radiance gradient kernel as its backward
    true_dev = true.to(dev)
    params = {k: v.clone().requires_grad_(True) for k, v in
              G.extract_params(true_dev, all_bg).items()}
    target_t = torch.tensor(target_lin, device=dev)
    K.LAUNCHES = RG.LAUNCHES = MS.LAUNCHES = 0
    for i in range(2):
        img = render_linear(G.apply_params(true_dev, params), 512, 512,
                            seed=i, device=dev)
        (img - target_t).abs().mean().backward()
    render_counts = (K.LAUNCHES, RG.LAUNCHES, MS.LAUNCHES)
    if render_counts != (2, 2, 0) or not all(
            bool(torch.isfinite(p.grad).all()) and p.grad.abs().sum() > 0
            for p in params.values()):
        raise AssertionError(f"render_linear backward: launches "
                             f"{render_counts}, expected (2, 2, 0)")
    print(f"phase 6 L1 loss through render_linear under autograd, 2 steps "
          f"at 512x512 spp 8 depth 6: launches forward {render_counts[0]}, "
          f"radiance grad {render_counts[1]}; gradients finite, nonzero")

    # ---- 7-14, each timed: the BVH path (#5); its fit path (record #5,
    # #6, #7); the HDRI importance-sampling path (record #5, #6, #7, #8);
    # volumes, isotropic materials and mixes, the deep fit; a sky map
    # without importance sampling, the views; fog inside a triangle mesh;
    # the brute kernels' mixes, volumes, isotropic lobe and sky; their
    # triangles
    took = {1: build_s, "1-6": time.perf_counter() - t_run}

    def timed(phase, run, *args):
        t0 = time.perf_counter()
        out = run(dev, card, *args)
        took[phase] = time.perf_counter() - t0
        return out

    bvh = timed(7, bvh_phase)
    bvh_fit = timed(8, bvh_fit_phase)
    env = timed(9, env_phase)
    zoo, zoo_bvh = timed(10, zoo_phase)
    sky = timed(11, sky_phase)
    fog = timed(12, fog_phase)
    brute = timed(13, brute_phase, zoo_bvh)
    tri = timed(14, tri_phase)

    report = {"kernels": [
        # the CLI renders of phase 4; times at benchmark 512x512
        _entry("brute_forward_megakernel", "megakernel.cu", "2089", launches,
               max_err, ms, plain_ms, fwd_bound[BENCH]),
        # render_linear under autograd; times at benchmark 512x512
        _entry("radiance_grad", "radiance_grad.cu", "2133", render_counts[1],
               grad_err["grad"], *times["grad"], bounds["grad"]),
        # the CLI fit of phase 6
        _entry("fused_mse_loss", "mse_loss.cu", "2411", cli_counts[2],
               grad_err["mse"], *times["mse"], bounds["mse"]),
        bvh,  # the CLI renders of phase 7; times at bvh_stress 1000x1000
        *bvh_fit,  # the CLI fit of phase 8; times at bvh_stress 1000x1000
        env,  # the CLI renders of phase 9; times at sky_bvh_stress
        *zoo,  # phase 10's CLI runs; times at the zoo's full shapes
        *sky,  # phase 11's CLI runs; times at bvh_stress 1000x1000
        *fog,  # phase 12's CLI runs; times at fog_sheet's frames
        *brute,  # phase 13's CLI runs; times at its shapes
        *tri]}  # phase 14's CLI runs and L1 loss; times at its shapes
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in took.items()))
    print(f"card: {card}; kernel build {build_s:.3f} s; the whole run "
          f"{time.perf_counter() - t_run:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
