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
   radiance gradient kernel as its backward).

The line before the last is the kernel report as JSON: each kernel's
launches on its own path (the forward kernel's in the CLI renders of
phase 4, the radiance gradient kernel's under ``render_linear``'s
backward, the fused kernel's in the CLI fit; the other paths' counts are
in the phase lines), and its least possible time for one forward and one
reverse sweep of the FP32 operations the run's rays traced, or for the
bytes it must move; the last line is
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
    }]}
    print(f"card: {card}; kernel build {build_s:.3f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
