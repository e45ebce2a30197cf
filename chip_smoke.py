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
   have a nonzero gradient.  Then bench.py::run_parity's directional
   finite-difference probe of the fused kernel's own loss at 64x48, and
   the kernels' and plain versions' times at 512x512;
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
   library's ``index_select``/``index_add_`` times and bounds; the CLI
   ``fit`` of bvh_stress (albedo, emission; 6 steps) against a target the
   CLI rendered, whose loss must fall, with one launch of each of the
   three kernels a step; and the warm fit step of both shapes with a
   ``torch.profiler`` breakdown into the record kernel, #6, the replay's
   forward and backward, #7, Adam and host.

The line before the last is the kernel report as JSON: each kernel's
launches on its own path (the forward kernel's in the CLI renders of
phase 4, the radiance gradient kernel's under ``render_linear``'s
backward, the fused kernel's in the CLI fit, the BVH kernel's in the CLI
renders of phase 7, the record variant's, #6's and #7's in the CLI fit of
phase 8; the other paths' counts are in the phase lines), and its least
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
OPS_MISS = {0: 6, 1: 25}
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
OPS_ADJ_MISS = {0: 9, 1: 41}
OPS_ADJ_EMIT = 9
OPS_ADJ_ABSORB = 6
OPS_ADJ_HIT = 99
OPS_ADJ_LOBE = {0: 0, 1: 52, 2: 60}
# the loss around it (mse_loss.cu): per sample the clip, the sum and the
# clip's slope times the pixel's cotangent; per pixel the mean, the error,
# its square and the cotangent
OPS_LOSS_RAY = 15
OPS_LOSS_PIXEL = 15
# csrc/bvh_forward.cu, counted from its source: per bounce a ray enters
# (a, 1/d, the uniforms), per node a walk visits (the slab test: 6
# differences, 6 products, 12 min/max, the compare), per sphere and per
# triangle a leaf tests, with the merge's compare; the camera ray, hit,
# lobes and background are radiance.cuh's, counted as above
OPS_BVH_BOUNCE = 12
OPS_NODE = 25
OPS_SPHERE_TEST = 30
OPS_TRI_TEST = 55


def _cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
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
    entering each bounce, hits by the winner's kind, misses.  Sums only,
    so a frame of many tiles adds up."""

    def __init__(self):
        self.bounces = self.misses = 0
        self.hits = collections.Counter()

    def __call__(self, alive, hit, kind):
        self.bounces += int(alive.sum())
        self.misses += int((alive & ~hit).sum())
        for k in range(4):
            self.hits[k] += int((alive & hit & (kind == k)).sum())

    def forward_ops(self, n_rays: int, n_spheres: int, bg_kind: int) -> int:
        """FP32 operations of the forward chain over these rays."""
        return (n_rays * OPS_RAY
                + self.bounces * (OPS_BOUNCE + n_spheres * OPS_SPHERE)
                + sum(self.hits.values()) * OPS_HIT
                + sum(self.hits[k] * OPS_LOBE[k] for k in range(4))
                + self.misses * OPS_MISS[bg_kind])


class _Tally(_Count):
    """A :class:`_Count` that also keeps, for the reverse sweep, which rays
    ended within the depth and their scattering bounces by kind.  A
    Full-mode scene of one tile of rays."""

    def __init__(self, max_depth: int):
        super().__init__()
        self.max_depth = max_depth
        self.calls = 0
        self.prev = None  # rays that hit a scattering kind at the last call

    def __call__(self, alive, hit, kind):
        import torch

        super().__call__(alive, hit, kind)
        if self.prev is None:
            self.ended = torch.zeros_like(alive)
            self.absorbed = torch.zeros_like(alive)
            self.scatter = torch.zeros((3,) + alive.shape, dtype=torch.int32,
                                       device=alive.device)
        else:  # a metal ray reflected below the surface ends there
            self.absorbed |= self.prev & ~alive
            self.scatter[1] -= (self.prev & ~alive).int()
        self.calls += 1
        for k in range(3):
            self.scatter[k] += (alive & hit & (kind == k)).int()
        self.ended |= (alive & ~hit) | (alive & hit & (kind == 3))
        self.prev = alive & hit & (kind != 3)

    def adjoint_ops(self, bg_kind: int) -> int:
        """FP32 operations of the reverse sweep over the same rays."""
        absorbed = self.absorbed.clone()
        if self.calls < self.max_depth:  # nothing was alive after the last
            absorbed |= self.prev
            self.scatter[1] -= self.prev.int()
        ended = self.ended | absorbed
        scatter = [int(self.scatter[k][ended].sum()) for k in range(3)]
        return (int(ended.sum()) * OPS_ADJ_RAY
                + self.misses * OPS_ADJ_MISS[bg_kind]
                + self.hits[3] * OPS_ADJ_EMIT
                + int(absorbed.sum()) * OPS_ADJ_ABSORB
                + sum(n * (OPS_ADJ_HIT + OPS_ADJ_LOBE[k])
                      for k, n in enumerate(scatter)))


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


def bvh_phase(dev, card: str) -> dict:
    """Phase 7; -> kernel #5's entries of the kernel report."""
    import torch

    from raytracingrust_tpu_torch import cli
    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.render.render import (render_linear,
                                                        select_engine)
    from raytracingrust_tpu_torch.utils import rng

    log = _build.library_path(name="bvh_forward").with_suffix(".log")
    regs = " | ".join(ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln)
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
        ids, px, py = K.prep_rays(torch.arange(w * h, device=dev), spp, w)
        opts = dict(bg_kind=scene.background.kind, clay=False)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for d in (1, depth):
            ker = BK.radiance_bvh_cuda(sc, key, n_rays, spp, w, max_depth=d,
                                       **opts)
            start.record()
            plain = BK.radiance_bvh_plain(sc, key, ids, px, py, max_depth=d,
                                          **opts)
            end.record()
            torch.cuda.synchronize()
            if not torch.equal(ker.view(torch.int32),
                               plain.view(torch.int32)):
                bad = (ker.view(torch.int32)
                       != plain.view(torch.int32)).any(dim=1)
                raise AssertionError(
                    f"{label}: kernel #5 != plain in {int(bad.sum())} of "
                    f"{bad.numel()} rays (depth {d}), max abs diff "
                    f"{(ker - plain).abs().max().item():.3e}")
        err = (ker - plain).abs().max().item()
        plain_ms = start.elapsed_time(end)  # the full-depth run above
        tally = collections.Counter()
        with torch.no_grad():
            BK.radiance_bvh_plain(sc, key, ids, px, py, max_depth=depth,
                                  tally=tally, **opts)
        hits = [tally[f"hits_{k}"] for k in range(4)]
        ops = (
            n_rays * OPS_RAY + tally["bounces"] * OPS_BVH_BOUNCE
            + tally["nodes"] * OPS_NODE
            + tally["sphere_tests"] * OPS_SPHERE_TEST
            + tally["triangle_tests"] * OPS_TRI_TEST
            + sum(hits) * OPS_HIT
            + sum(n * OPS_LOBE[k] for k, n in enumerate(hits))
            + tally["misses"] * OPS_MISS[scene.background.kind])
        scene_bytes = sum(t.numel() * t.element_size() for t in (
            sc.head, sc.mats, sc.kinds, *(sc.spheres or ()),
            *(sc.triangles or ())) if isinstance(t, torch.Tensor))
        bound = _bound(ops, scene_bytes + 12 * n_rays)
        ker_ms = _cuda_time_ms(lambda: BK.radiance_bvh_cuda(
            sc, key, n_rays, spp, w, max_depth=depth, **opts), 5)
        out[label] = dict(ms=ker_ms, plain_ms=plain_ms, bound=bound,
                          err=err)
        print(f"phase 7 {label} {w}x{h} spp {spp} depth {depth} "
              f"({len(scene.spheres)} spheres, {len(scene.triangles)} "
              f"triangles): per-ray radiance bit for bit equal at depth 1 "
              f"and depth {depth} on all {n_rays} rays; per ray "
              f"{tally['bounces'] / n_rays:.3f} bounces, "
              f"{tally['nodes'] / n_rays:.2f} node visits, "
              f"{tally['sphere_tests'] / n_rays:.1f} sphere and "
              f"{tally['triangle_tests'] / n_rays:.1f} triangle tests; "
              f"kernel {ker_ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]}; {ops:.4g} FP32 "
              f"operations)")

    # the main path, through the CLI entry
    BK.LAUNCHES = K.LAUNCHES = 0
    for label, path, *_, flags in shapes:
        rc = cli.main(["render", path, *flags, "-o",
                       os.path.join(OUT_DIR, label + ".png"), "--seed", "0"])
        if rc != 0:
            raise AssertionError(f"cli render {path} returned {rc}")
    launches, brute = BK.LAUNCHES, K.LAUNCHES
    if launches < len(shapes) or brute != 0:
        raise AssertionError(f"the CLI renders launched kernel #5 {launches}"
                             f" times and #1 {brute} times, expected "
                             f"{len(shapes)} and 0")
    for label, path, w, h, _ in shapes:
        png = read_png(os.path.join(OUT_DIR, label + ".png"))
        if png.shape != (h, w, 4) or png[..., :3].min() == png[..., :3].max():
            raise AssertionError(f"{label}: PNG {png.shape} is flat or "
                                 f"misshapen")
        scene = SceneBuilder.from_file(path).build()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = render_linear(scene, w, h, seed=0, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(img).all()) or img.std().item() == 0.0:
            raise AssertionError(f"{label}: image not finite or flat")
        best = min(times)
        spp = scene.settings.samples_per_pixel
        print(f"phase 7 {label} {w}x{h} spp {spp}: warm render {best:.4f} s,"
              f" {w * h * spp / best / 1e6:.1f} primary Mrays/s (kernel #5), "
              f"image mean {img.mean().item():.5f}")
    print(f"phase 7 CLI renders: {launches} launches of kernel #5, {brute} "
          f"of #1; {card}; ptxas: {regs}")
    main_shape = out["bvh_stress"]
    return {"launches": launches,
            "max_abs_err": max(o["err"] for o in out.values()),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound"][0],
            "bound_by": main_shape["bound"][1]}


# phase 8: the fitted shapes, their parameters and the CLI fit's
FIT_SHAPES = (("bvh_stress", 1000, 1000,
               "albedo,emission,bg_color_a,bg_color_b,sphere_center,"
               "sphere_radius,cam_lookfrom"),
              ("sheet64", 512, 512, "albedo,emission,bg_color_a,"
                                    "sphere_center"))
CLI_FIT_PARAMS = "albedo,emission"
# #7 vs its plain version in float64: of the sum of the magnitudes added
FETCH_RTOL = 1e-5
REPLAY_ATOL = 1e-4  # the replay's forward vs the kernel's radiance


def _profile_step(prof, steps: int) -> dict:
    """Device ms a step by part of a BVH fit step, from a torch.profiler
    run of ``steps`` steps: the kernels by name, the replay's halves and
    Adam by their ranges (user annotations span their kernels on the
    device; #6 runs inside the replay's forward, #7 inside its
    backward)."""
    import torch

    kernel = collections.Counter()
    ranges = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total", 0.0) / 1e3 / steps
        if getattr(evt, "is_user_annotation", False):
            ranges[evt.key] += ms
        else:
            kernel[evt.key] += ms
    part = collections.Counter()
    for key, ms in kernel.items():
        if "bvh_radiance_kernel" in key:
            record = "<true>" in key or "ILb1E" in key
            part["record #5" if record else "#5"] += ms
        elif "fetch_kernel" in key:
            part["#6"] += ms
        elif "transpose_kernel" in key:
            part["#7"] += ms
        else:
            part["other kernels"] += ms
    fwd = ranges.get("bvh_replay_forward", 0.0)
    bwd = ranges.get("bvh_replay_backward", 0.0)
    adam = sum(v for k, v in ranges.items() if "Adam" in k)
    part["replay forward"] = fwd - part["#6"]
    part["replay backward"] = bwd - part["#7"]
    part["Adam"] = adam
    part["busy"] = sum(kernel.values())
    return part


def bvh_fit_phase(dev, card: str) -> list:
    """Phase 8; -> the report entries of the record variant of #5, #6 and
    #7."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracingrust_tpu_torch import cli
    from raytracingrust_tpu_torch.diff import grad as G
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.io.png import read_png
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import fetch as F
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.render.render import render_linear
    from raytracingrust_tpu_torch.utils import rng

    paths = {label: path for label, path, *_ in bvh_scenes()}
    key = rng.base_key(11)
    gen = np.random.default_rng(0)
    out = {}
    for label, w, h, names in FIT_SHAPES:
        scene = SceneBuilder.from_file(paths[label]).build()
        s = scene.settings
        spp, depth = s.samples_per_pixel, s.max_ray_depth
        n_pix, n_rays = w * h, w * h * spp
        opts = dict(max_depth=depth, bg_kind=scene.background.kind,
                    clay=False)
        with torch.no_grad():
            sc = BK.pack(scene, w, h, dev)
        ids, px, py = K.prep_rays(torch.arange(n_pix, device=dev), spp, w)

        # the record variant against #5 and the plain record walk
        ker = BK.radiance_bvh_cuda(sc, key, n_rays, spp, w, **opts)
        rec, codes = BK.radiance_bvh_cuda(sc, key, n_rays, spp, w,
                                          record=True, **opts)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, plain_codes = BK.radiance_bvh_plain(sc, key, ids, px, py,
                                               record=True, **opts)
        end.record()
        torch.cuda.synchronize()
        rec_plain_ms = start.elapsed_time(end)
        if not torch.equal(rec.view(torch.int32), ker.view(torch.int32)):
            raise AssertionError(f"{label}: the record variant's radiance "
                                 f"differs from #5's")
        if not torch.equal(codes, plain_codes):
            bad = (codes != plain_codes).any(dim=0)
            raise AssertionError(f"{label}: record codes differ from the "
                                 f"plain walk's on {int(bad.sum())} of "
                                 f"{n_rays} rays")
        hits = int((codes >= 0).sum())

        # #6 and #7 against their plain versions
        sph, tri = sc.spheres, sc.triangles
        args = (codes, sc.kinds, sc.tri_base, sph and sph.mat,
                tri and tri.mat, sc.mats, sph and sph.geo, tri and tri.geo)
        rows, kind = F.fetch_rows_cuda(*args)
        p_rows, p_kind = F.fetch_rows_plain(*args)
        if not (torch.equal(rows.view(torch.int32), p_rows.view(torch.int32))
                and torch.equal(kind, p_kind)):
            raise AssertionError(f"{label}: #6 differs from its plain "
                                 f"version")
        del p_rows, p_kind
        g_rows = torch.randn(tuple(rows.shape), device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
        sizes = (sc.kinds.shape[0], sph.geo.shape[0] if sph else 0,
                 tri.geo.shape[0] if tri else 0)
        targs = (codes, g_rows, sc.tri_base, sph and sph.mat,
                 tri and tri.mat, *sizes)
        # #7 against its plain version summed in float64: float32 sums of
        # ~1e5 terms of both signs (the ground sphere, 4 materials) differ
        # from the exact sum, in any order, by more than 1e-5 of the
        # result, so the bound is 1e-5 of the magnitudes an entry adds
        g64 = g_rows.double()
        exact = F.fetch_rows_transpose_plain(codes, g64, *targs[2:])
        scale = F.fetch_rows_transpose_plain(codes, g64.abs(), *targs[2:])
        t_err = p_err = 0.0
        for got, plain, want, mag in zip(
                F.fetch_rows_transpose_cuda(*targs),
                F.fetch_rows_transpose_plain(*targs), exact, scale):
            if want is None:
                continue
            err = (got.double() - want).abs()
            if bool((err > FETCH_RTOL * mag).any()):
                raise AssertionError(f"{label}: #7 differs from the exact "
                                     f"sums by up to {err.max().item():.3e}")
            t_err = max(t_err, err.max().item())
            p_err = max(p_err, (plain.double() - want).abs().max().item())
        del g64, exact, scale

        # the replay's forward against the kernel's radiance
        with torch.no_grad():
            rep = BK.replay(sc, codes, key, n_pix, spp, w, **opts)
        rep_err = (rep - ker).abs().max().item()
        if not rep_err <= REPLAY_ATOL:
            raise AssertionError(f"{label}: the replay's forward is "
                                 f"{rep_err:.3e} from #5's radiance")
        del rep

        # the gradient through the kernels against the plain route
        cts = torch.tensor(gen.standard_normal((n_rays, 3),
                                               dtype=np.float32), device=dev)
        want = BK.radiance_grad_plain(sc, key, cts, n_pix, spp, w, **opts)
        torch.cuda.reset_peak_memory_stats()
        rows_in = [None if v is None else v.detach().requires_grad_(True)
                   for v in BK._rows(sc)]
        rad = BK.radiance(sc.with_rows(*rows_in), key, n_pix, spp, w, **opts)
        live = [v for v in rows_in if v is not None]
        got = torch.autograd.grad(rad, live, cts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        g_err = 0.0
        for part, a, b in zip(("head", "materials", "geometry", "geometry"),
                              got, [v for v in want if v is not None]):
            err = (a - b).abs()
            if not bool(torch.isfinite(a).all()) or bool(
                    (err > GRAD_RTOL * b.abs() + GRAD_ATOL * b.abs().max())
                    .any()):
                raise AssertionError(f"{label}: the {part} gradient differs "
                                     f"from the plain route by up to "
                                     f"{err.max().item():.3e}")
            g_err = max(g_err, err.max().item())
        del rad, got, want

        # FD probe of the loss along a numpy-seeded direction
        sc_dev = scene.to(dev)
        probe = ["albedo", "emission", "bg_color_a"]
        params = {k: v.clone().requires_grad_(True) for k, v in
                  G.extract_params(sc_dev, probe).items()}
        v = {k: torch.tensor(gen.standard_normal(tuple(p.shape)),
                             dtype=torch.float32, device=dev)
             for k, p in params.items()}
        with torch.no_grad():
            target = render_linear(sc_dev, w, h, seed=12, device=dev) * 0.9
        loss = G.make_loss(sc_dev, target, w, h, device=dev)
        loss(params, key).backward()
        ad = sum((params[k].grad * v[k]).sum().item() for k in params)
        eps = 1e-3
        with torch.no_grad():
            fd = (loss({k: p + eps * v[k] for k, p in params.items()}, key)
                  - loss({k: p - eps * v[k] for k, p in params.items()}, key)
                  ).item() / (2 * eps)
        if not abs(ad - fd) <= 0.05 * max(abs(fd), 1e-6):
            raise AssertionError(f"{label}: FD probe AD {ad:.6e} vs FD "
                                 f"{fd:.6e}")

        # times: kernels, plain versions, the library's gather/scatter
        n = codes.numel()
        ms_rec = _cuda_time_ms(lambda: BK.radiance_bvh_cuda(
            sc, key, n_rays, spp, w, record=True, **opts), 5)
        ms_6 = _cuda_time_ms(lambda: F.fetch_rows_cuda(*args), 10)
        ms_7 = _cuda_time_ms(lambda: F.fetch_rows_transpose_cuda(*targs), 10)
        plain_6 = _cuda_time_ms(lambda: F.fetch_rows_plain(*args), 2)
        plain_7 = _cuda_time_ms(lambda: F.fetch_rows_transpose_plain(*targs),
                                2)
        # the first tree's rows (its slots count from 0 in the codes)
        tree = sph if sph is not None else tri
        flat = codes.reshape(-1)
        limit = sc.tri_base if sph is not None else BK.REC_SLOT + 1
        own = (flat >= 0) & ((flat & BK.REC_SLOT) < limit)
        slot = torch.where(own, flat & BK.REC_SLOT, 0).long()
        mid = tree.mat[slot].long()
        hit_idx = own.nonzero().squeeze(1)
        g_geo = g_rows.reshape(g_rows.shape[0], -1)[:tree.geo.shape[1],
                                                    hit_idx].T.contiguous()
        g_mat = g_rows.reshape(g_rows.shape[0], -1)[-8:,
                                                    hit_idx].T.contiguous()
        s_hit, m_hit = slot[hit_idx], mid[hit_idx]
        lib_6 = _cuda_time_ms(lambda: (tree.geo.index_select(0, slot),
                                       sc.mats.index_select(0, mid)), 10)
        lib_7 = _cuda_time_ms(lambda: (
            torch.zeros_like(tree.geo).index_add_(0, s_hit, g_geo),
            torch.zeros_like(sc.mats).index_add_(0, m_hit, g_mat)), 10)

        # bounds: #5's operations (phase 7's tally) plus the record's
        # decisions; bytes in and out once
        tally = collections.Counter()
        with torch.no_grad():
            BK.radiance_bvh_plain(sc, key, ids, px, py, tally=tally, **opts)
        n_hits = [tally[f"hits_{k}"] for k in range(4)]
        ops = (n_rays * OPS_RAY + tally["bounces"] * OPS_BVH_BOUNCE
               + tally["nodes"] * OPS_NODE
               + tally["sphere_tests"] * OPS_SPHERE_TEST
               + tally["triangle_tests"] * OPS_TRI_TEST
               + sum(n_hits) * OPS_HIT
               + sum(c * OPS_LOBE[k] for k, c in enumerate(n_hits))
               + tally["misses"] * OPS_MISS[scene.background.kind]
               + sum(n_hits) * ((OPS_LOBE[1] if sc.rec_mask
                                 & BK.REC_METAL_OK else 0)
                                + (OPS_LOBE[2] if sc.rec_mask
                                   & BK.REC_REFLECT else 0)))
        scene_bytes = sum(t.numel() * t.element_size() for t in (
            sc.head, sc.mats, sc.kinds, *(sc.spheres or ()),
            *(sc.triangles or ())) if isinstance(t, torch.Tensor))
        table_bytes = sum(t.numel() * t.element_size() for t in (
            sc.mats, sc.kinds, *args[3:5], *args[6:8]) if t is not None)
        g = rows.shape[0] - 8
        n_geo_hit = 0
        if sph is not None:
            n_geo_hit += 4 * int((codes >= 0).logical_and(
                (codes & BK.REC_SLOT) < sc.tri_base).sum())
        if tri is not None:
            n_geo_hit += 12 * int((codes >= 0).logical_and(
                (codes & BK.REC_SLOT) >= sc.tri_base).sum())
        bounds = {
            "record": _bound(ops, scene_bytes + 12 * n_rays + 4 * n),
            "fetch": _bound(0, table_bytes + 4 * n + 4 * (g + 9) * n),
            "transpose": _bound(2 * (n_geo_hit + 8 * hits), 4 * n
                                + 4 * (n_geo_hit + 8 * hits) + 4 * hits
                                + table_bytes),
        }
        out[label] = dict(ms=(ms_rec, ms_6, ms_7),
                          plain=(rec_plain_ms, plain_6, plain_7),
                          lib=(None, lib_6, lib_7), bounds=bounds,
                          err=(0.0, 0.0, t_err))
        print(f"phase 8 {label} {w}x{h} spp {spp} depth {depth}: record "
              f"radiance == #5 bit for bit, codes == plain codes on all "
              f"{n_rays} rays x {depth} bounces ({hits} hits); #6 == plain "
              f"bit for bit ({rows.shape[0]} fields); #7 max abs diff "
              f"from the float64 sums {t_err:.3e} (float32 index_add_ "
              f"{p_err:.3e}; allowed {FETCH_RTOL:g} of the magnitudes "
              f"added); replay forward vs #5 max abs diff {rep_err:.3e} "
              f"(allowed {REPLAY_ATOL:g}); gradient vs plain route max abs "
              f"diff {g_err:.3e} (allowed {GRAD_RTOL:g} rel + {GRAD_ATOL:g} "
              f"of max), finite; peak memory of the backward "
              f"{peak_gb:.2f} GB; FD probe ({', '.join(probe)}; eps {eps:g},"
              f" rtol 5%): AD {ad:.6e}, FD {fd:.6e}")
        print(f"phase 8 {label} times: record #5 {ms_rec:.4f} ms (plain "
              f"{rec_plain_ms:.1f} ms, bound {bounds['record'][0]:.5f} ms "
              f"{bounds['record'][1]}); #6 {ms_6:.4f} ms (plain "
              f"{plain_6:.3f}, index_select {lib_6:.4f}, bound "
              f"{bounds['fetch'][0]:.5f} {bounds['fetch'][1]}); #7 "
              f"{ms_7:.4f} ms (plain {plain_7:.3f}, index_add_ {lib_7:.4f},"
              f" bound {bounds['transpose'][0]:.5f} "
              f"{bounds['transpose'][1]})")
        del rows, g_rows, codes, plain_codes, kind

    # the main path: CLI fit of bvh_stress against a CLI-rendered target
    with open(STRESS) as f:
        d = json.load(f)
    for m in d["materials"]:
        if "albedo" in m:
            m["albedo"] = {c: 0.7 * v for c, v in m["albedo"].items()}
    dim = os.path.join(OUT_DIR, "bvh_stress_dim.json")
    with open(dim, "w") as f:
        json.dump(d, f)
    target_png = os.path.join(OUT_DIR, "bvh_fit_target.png")
    if cli.main(["render", dim, "-o", target_png, "--seed", "1"]) != 0:
        raise AssertionError("cli render of the fit target failed")
    steps = 6
    BK.LAUNCHES = BK.RECORD_LAUNCHES = 0
    F.FETCH_LAUNCHES = F.TRANSPOSE_LAUNCHES = K.LAUNCHES = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit", STRESS, target_png, "--params", CLI_FIT_PARAMS,
                       "--steps", str(steps), "--seed", "0", "-o",
                       os.path.join(OUT_DIR, "bvh_fit_result.png")])
    text = buf.getvalue()
    counts = (BK.RECORD_LAUNCHES, F.FETCH_LAUNCHES, F.TRANSPOSE_LAUNCHES,
              BK.LAUNCHES, K.LAUNCHES)
    if rc != 0 or counts != (steps, steps, steps, 1, 0):
        raise AssertionError(f"cli fit returned {rc}, launches (record, #6, "
                             f"#7, #5, #1) {counts}, expected ({steps}, "
                             f"{steps}, {steps}, 1, 0)\n{text}")
    first = float(text.split("step 0: loss")[1].split()[0])
    final = float(text.split("final loss")[1].split()[0])
    if not (np.isfinite(first) and np.isfinite(final) and final < first):
        raise AssertionError(f"cli fit loss did not fall: {first} -> "
                             f"{final}\n{text}")
    print(f"phase 8 cli fit {STRESS} 1000x1000 spp 8 depth 4, {steps} "
          f"steps of {CLI_FIT_PARAMS}: loss {first:.6f} -> {final:.6f}; "
          f"launches record {counts[0]}, #6 {counts[1]}, #7 {counts[2]}, "
          f"#5 {counts[3]} (the fitted render)")

    # the warm fit step of each shape, and where its time goes
    for label, w, h, names in FIT_SHAPES:
        scene = SceneBuilder.from_file(paths[label]).build()
        spp = scene.settings.samples_per_pixel
        target = (read_png(target_png)[..., :3].astype(np.float32) / 255.0
                  ) ** 2 if label == "bvh_stress" else np.full(
            (h, w, 3), 0.25, np.float32)
        ticks = []

        def tick(i, value, params):
            ticks.append(time.perf_counter())  # after float(loss): synced

        t0 = time.perf_counter()
        _, params, history = fit(scene, target, names.split(","), w, h,
                                 steps=6, device=dev, callback=tick)
        step_s = sorted(b - a for a, b in zip(ticks[1:], ticks[2:]))
        warm = step_s[len(step_s) // 2]
        if not all(np.isfinite(history)) or not all(
                bool(torch.isfinite(p).all()) for p in params.values()):
            raise AssertionError(f"{label} fit: not finite, history "
                                 f"{history}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fit(scene, target, names.split(","), w, h, steps=3, device=dev)
        part = _profile_step(prof, 3)
        host = warm * 1e3 - part["busy"]
        print(f"phase 8 {label} fit step ({names}): first step "
              f"{(ticks[0] - t0) * 1e3:.1f} ms, warm step {warm * 1e3:.3f} "
              f"ms (median of {len(step_s)}), {w * h * spp / warm / 1e6:.1f} "
              f"primary Mrays/s fwd+bwd; loss {history[0]:.6f} -> "
              f"{history[-1]:.6f}; per step under torch.profiler: "
              + ", ".join(f"{k} {part[k]:.3f} ms" for k in (
                  "record #5", "#6", "replay forward", "replay backward",
                  "#7", "Adam", "other kernels", "busy"))
              + f", host (warm step - busy) {host:.3f} ms; {card}")

    main_shape = out["bvh_stress"]
    names = (("bvh_record", "bvh_forward.cu", "3001", "record"),
             ("fetch_rows", "fetch_rows.cu", "3179", "fetch"),
             ("fetch_rows_transpose", "fetch_rows.cu", "3179", "transpose"))
    return [{
        "name": name,
        "route": "cuda",
        "source": "raytracingrust_tpu_torch/csrc/" + src,
        "replaces": "raytracingrust_tpu/ops/pallas_megakernel.py:" + line,
        "launches": counts[i],  # the CLI fit above
        "max_abs_err": main_shape["err"][i],
        "ms": main_shape["ms"][i],
        "plain_ms": main_shape["plain"][i],
        "bound_ms": main_shape["bounds"][b][0],
        "bound_by": main_shape["bounds"][b][1],
        "library_ms": main_shape["lib"][i],
    } for i, (name, src, line, b) in enumerate(names)]


def main() -> int:
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
    regs = []
    for name in _build.SOURCES:
        log = _build.library_path(name=name).with_suffix(".log")
        regs += [f"{name}: {ln.strip()}" for ln in (
            log.read_text().splitlines() if log.exists() else [])
            if "registers" in ln or "spill" in ln]
    print(f"phase 1 build ({len(_build.SOURCES)} sources in parallel): "
          f"{build_s:.3f} s; {' | '.join(regs)}")

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
                             _cuda_time_ms(plain_fn, reps[1]))
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
                     fp, kinds, key, cts, spp, w, **opts), 1)),
        "mse": (_cuda_time_ms(lambda: MS.mse_loss_cuda(
            fp, kinds, key, target, spp, w, clamp=clamp, **opts), 10),
                _cuda_time_ms(lambda: fused_plain(
                    fp, kinds, key, target, spp, w, clamp, opts), 1)),
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

    # ---- 7. the BVH path (kernel #5)
    bvh = bvh_phase(dev, card)

    # ---- 8. the BVH fit path (record mode of #5, #6, #7)
    bvh_fit = bvh_fit_phase(dev, card)

    replaces = "raytracingrust_tpu/ops/pallas_megakernel.py:"
    report = {"kernels": [{
        "name": "brute_forward_megakernel",
        "route": "cuda",
        "source": "raytracingrust_tpu_torch/csrc/megakernel.cu",
        "replaces": replaces + "2089",
        "launches": launches,  # the CLI renders of phase 4
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": fwd_bound[BENCH][0],
        "bound_by": fwd_bound[BENCH][1],
        "library_ms": None,
    }, {
        "name": "radiance_grad",
        "route": "cuda",
        "source": "raytracingrust_tpu_torch/csrc/radiance_grad.cu",
        "replaces": replaces + "2133",
        "launches": render_counts[1],  # render_linear under autograd
        "max_abs_err": grad_err["grad"],
        "ms": times["grad"][0],
        "plain_ms": times["grad"][1],
        "bound_ms": bounds["grad"][0],
        "bound_by": bounds["grad"][1],
        "library_ms": None,
    }, {
        "name": "fused_mse_loss",
        "route": "cuda",
        "source": "raytracingrust_tpu_torch/csrc/mse_loss.cu",
        "replaces": replaces + "2411",
        "launches": cli_counts[2],  # the CLI fit
        "max_abs_err": grad_err["mse"],
        "ms": times["mse"][0],
        "plain_ms": times["mse"][1],
        "bound_ms": bounds["mse"][0],
        "bound_by": bounds["mse"][1],
        "library_ms": None,
    }, {
        "name": "bvh_forward",
        "route": "cuda",
        "source": "raytracingrust_tpu_torch/csrc/bvh_forward.cu",
        "replaces": replaces + "3001",
        **bvh,  # the CLI renders of phase 7; times at bvh_stress 1000x1000
        "library_ms": None,
    }, *bvh_fit]}  # the CLI fit of phase 8; times at bvh_stress 1000x1000
    print(f"card: {card}; kernel build {build_s:.3f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
