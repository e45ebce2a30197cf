#!/usr/bin/env python3
"""The brute forward kernel's sphere path (#1, csrc/megakernel.cu: the
persistent lanes that claim new rays as their paths end; csrc/radiance.cuh
bounce, which #3 csrc/radiance_grad.cu and #4 csrc/mse_loss.cu run through
trace) of checkouts of the port, timed at the shapes of their main path, on
one GPU.

    python3 scripts/profile_brute_sphere.py --parent DIR [--rounds N]
    python3 scripts/profile_brute_sphere.py --root DIR [--label NAME] [--only1]

With ``--parent``, DIR a checkout of another commit (a ``git archive``
unpacked under build/), the script first measures the lane efficiency of
each #1 shape's plain run (one thread a ray, warps of 32 consecutive ray
ids that each run to their longest path; ``chip_smoke._Count``) on SAMPLE
warps spread evenly over the frame, then runs itself once a checkout, in
turns: the parent and this checkout as parent, change, change, parent (N
rounds of that), then variants of this checkout built from copies of its
package under build/variants/, each once (#1 alone, but #3 and #4 too
for those of BOUNCE_VARIANTS, which edit radiance.cuh's bounce): refill
thresholds 1 and 16 (megakernel.cu kRefill; the tree's is 8); the static
form, a grid of blocks for the rays over G and each lane taking its own
rays one after another (grid stride, no counter), G 4, 8 and 16; the
uniforms drawn
once the hit is known, only the pairs its lobe reads, and the sphere
sample only for the lobes that read it ("lazy"); #1's spheres read from
their packed rows ("rows") in place of stage_geo's float4s; and the solid
spheres' roots taken where the discriminant is negative ("roots").  The
tree has no switch for any of them.  Last it prints one JSON object with
every run's times.

With ``--root`` it times one checkout (its package imported and built
into DIR/build/kernels): #1 at benchmark.json 512x512 spp 8 depth 6,
cornell_spheres.json 1000x1000 spp 64 depth 8, zoo_brute (material_zoo
1200x800 spp 32 depth 8, kExt), sky_bench (1000x1000 spp 8 depth 6,
kSky), sky_zoo_naive (600x400 spp 16 depth 8, kExt + kSky), tri_brute
(1000x1000 spp 8 depth 6, kTri), tri_zoo (1200x800 spp 32 depth 8) and
tri_zoo_sky (600x400 spp 16 depth 8); unless ``--only1``, #3 (an L1
loss's cotangents) and #4 at their fit shapes: benchmark 512x512 spp 8,
the zoo 600x400 spp 16, sky_bench 512x512 (#3), sky_zoo_naive (#3),
tri_brute 512x512 spp 8, tri_zoo 600x400 (#4) and tri_zoo_sky (#3).  The
scenes are written as chip_smoke.py writes them, into this checkout's
build/smoke.  Each shape: the kernel's time (CUDA events, the mean of REPS
launches after a warm-up), for #1 a hash of its output's bits (three
launches must give the same bits; parent and change must give the same
hash) and for #3 and #4 a checksum; then the compiler's registers, stack
and spills of every instance of the three kernels, and one JSON line.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS = 5
SAMPLE = 1 << 15  # warps of a plain run's lane efficiency

_REFILL = "constexpr int kRefill = 8;"
_CLAIM_START = "    const unsigned idle = __ballot_sync(kFull, !live);\n"
_CLAIM_END = "    if (drained && !__any_sync(kFull, live)) break;\n"
_GRID = ("const int grid = std::min(blocks_for(n_rays), "
         "std::max(1, sms * per_sm));")
_STATIC = """    if (!live && next_ray < n_rays) {  // the lane's own next ray
      ray = (int)next_ray;
      next_ray += (long long)gridDim.x * blockDim.x;
      b = 0;
      live = true;
      const int pixel = ray / spp;
      start_path(f, k0, k1, (uint32_t)ray, (float)(pixel % width),
                 (float)(pixel / width), p);
    }
    if (!__any_sync(kFull, live)) break;
"""
_DRAINED = "  bool drained = false;"
# the lazy draws: bounce's pairs drawn once the hit is known, only those its
# lobe reads, and scatter's sphere sample only for the lobes that read it
_TOP_DRAW = """  const uint32_t stream = 1u + (uint32_t)b;
  float u1, u2, u_coin, u_r;
  uniform_pair(k0, k1, rid, stream, jl, u1, u2);
  uniform_pair(k0, k1, rid, stream, jl + 1u, u_coin, u_r);
"""
_LOBE = """\n  float at_r, at_g, at_b, ndx, ndy, ndz;
  bool scatters;
  scatter<kExt>(mat,"""
_LAZY_DRAW = """
  float u1 = 0.0f, u2 = 0.0f, u_coin = 0.0f, u_r = 0.0f;
  if (clay || kind == kLambertian || kind == kMetal ||
      (kExt && kind == kIsotropic))
    uniform_pair(k0, k1, rid, stream, jl, u1, u2);
  if (!clay && (kind == kDielectric || (kExt && kind == kIsotropic)))
    uniform_pair(k0, k1, rid, stream, jl + 1u, u_coin, u_r);"""
_SAMPLE = """  float sx, sy, sz;
  sphere_sample(u1, u2, sx, sy, sz);
  float ldx"""
_LAZY_SAMPLE = """  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (clay || kind == kLambertian || kind == kMetal ||
      (kIso && kind == kIsotropic))
    sphere_sample(u1, u2, sx, sy, sz);
  float ldx"""


def _static(g: int) -> dict:
    return {"csrc/megakernel.cu": [
        (_DRAINED, _DRAINED + "\n  long long next_ray = (long long)"
         "blockIdx.x * blockDim.x + threadIdx.x;"),
        ("CLAIM", _STATIC),
        (_GRID, f"const int grid = blocks_for((n_rays + {g - 1}) / {g}); "
         "(void)sms; (void)per_sm;")]}


# variant name -> {file in the package: [(text, replacement)]}; "CLAIM"
# stands for the warp's claim, from _CLAIM_START to _CLAIM_END
VARIANTS = {
    "k1": {"csrc/megakernel.cu": [(_REFILL, "constexpr int kRefill = 1;")]},
    "k16": {"csrc/megakernel.cu": [(_REFILL,
                                    "constexpr int kRefill = 16;")]},
    "g4": _static(4),
    "g8": _static(8),
    "g16": _static(16),
    "lazy": {"csrc/radiance.cuh": [
        (_TOP_DRAW, "  const uint32_t stream = 1u + (uint32_t)b;\n"),
        (_LOBE, _LAZY_DRAW + _LOBE), (_SAMPLE, _LAZY_SAMPLE)]},
    "rows": {"csrc/megakernel.cu": [("bounce<kExt, kSky, kTri, true>",
                                     "bounce<kExt, kSky, kTri, false>")]},
    "roots": {"csrc/radiance.cuh": [
        ("    if (!(disc >= 0.0f)) continue;\n"
         "    const float sq = sqrtf(disc);\n"
         "    const float t1 = (-half_b - sq) * inv_a;\n"
         "    const float t2 = (-half_b + sq) * inv_a;\n"
         "    const bool t1ok",
         "    const float sq = sqrtf(fmaxf(disc, 0.0f));\n"
         "    const float t1 = (-half_b - sq) * inv_a;\n"
         "    const float t2 = (-half_b + sq) * inv_a;\n"
         "    const bool t1ok"),
        ("    if (ti < t_best) {\n      t_best = ti;\n      best = i;\n"
         "      root2 = !t1ok;",
         "    if (disc >= 0.0f && ti < t_best) {\n      t_best = ti;\n"
         "      best = i;\n      root2 = !t1ok;")]},
}


# the variants of radiance.cuh's bounce, which #3 and #4 run too: timed
# at every shape
BOUNCE_VARIANTS = ("lazy", "roots")


def shapes(C) -> tuple:
    """(label, kernel, scene JSON, width, height, spp, depth) of each
    shape, the sky and triangle scenes written by chip_smoke.py (module
    ``C``)."""
    os.makedirs(C.OUT_DIR, exist_ok=True)
    if not os.path.exists(C.SKY):
        C.procedural_sky(C.SKY)
    brute = {label: path for label, path, *_ in C.brute_scenes()}
    tri = {label: path for label, path, *_ in C.tri_scenes()}
    zw, zh = C.ZOO_RENDER
    fw, fh, f_spp = C.ZOO_FIT
    sw, sh, s_spp, s_depth = C.SKY_BENCH
    bw, bh, b_spp, b_depth = C.TRI_RENDER
    tw, th, t_spp = C.TRI_FIT
    sb = C.SKY_BENCH_FIT
    return (("#1 base", 1, C.BENCH, 512, 512, 8, 6),
            ("#1 cornell", 1, C.CORNELL, 1000, 1000, 64, 8),
            ("#1 ext", 1, C.ZOO, zw, zh, 32, 8),
            ("#1 sky", 1, brute["sky_bench"], sw, sh, s_spp, s_depth),
            ("#1 ext+sky", 1, brute["sky_zoo_naive"], fw, fh, f_spp, 8),
            ("#1 tri", 1, tri["tri_brute"], bw, bh, b_spp, b_depth),
            ("#1 ext+tri", 1, tri["tri_zoo"], zw, zh, 32, 8),
            ("#1 ext+sky+tri", 1, tri["tri_zoo_sky"], fw, fh, f_spp, 8),
            ("#3 base", 3, C.BENCH, 512, 512, 8, 6),
            ("#3 ext", 3, C.ZOO, fw, fh, f_spp, 8),
            ("#3 sky", 3, brute["sky_bench"], sb, sb, s_spp, s_depth),
            ("#3 ext+sky", 3, brute["sky_zoo_naive"], fw, fh, f_spp, 8),
            ("#3 tri", 3, tri["tri_brute"], tw, th, t_spp, 6),
            ("#3 ext+sky+tri", 3, tri["tri_zoo_sky"], fw, fh, f_spp, 8),
            ("#4 base", 4, C.BENCH, 512, 512, 8, 6),
            ("#4 ext", 4, C.ZOO, fw, fh, f_spp, 8),
            ("#4 tri", 4, tri["tri_brute"], tw, th, t_spp, 6),
            ("#4 ext+tri", 4, tri["tri_zoo"], fw, fh, f_spp, 8))


def _setup(root: str):
    """Import the checkout under ``root`` (and chip_smoke.py from this
    one); -> (chip_smoke module, card's name and power limit)."""
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_brute_sphere: no CUDA device is available")
    import chip_smoke as C
    import raytracingrust_tpu_torch

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return C, card


def lane_efficiency(C, scene, w: int, h: int, spp: int, dev) -> tuple:
    """(lane efficiency, bounces a ray) of the plain run of SAMPLE warps of
    32 consecutive ray ids, spread evenly over the frame."""
    import torch

    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.utils import rng

    fp, kinds, opts, sky = C._brute_inputs(scene, w, h, dev)
    n_warps = w * h * spp // 32
    warps = torch.linspace(0, n_warps - 1, min(SAMPLE, n_warps),
                           device=dev).long().unique()
    ids = (warps[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)
    pixel = ids // spp
    count = C._Count()
    with torch.no_grad():
        K.radiance_plain(fp, kinds, rng.base_key(0), ids.int(),
                         (pixel % w).float(), (pixel // w).float(), sky=sky,
                         observe=count, **opts)
    return count.lane_efficiency, count.bounces / ids.numel()


def lanes_root() -> int:
    """The lane efficiency of each #1 shape's plain run; one JSON line."""
    C, card = _setup(str(HERE))
    import torch

    dev = torch.device("cuda")
    out = {"card": card, "lanes": {}}
    for name, kernel, path, w, h, spp, depth in shapes(C):
        if kernel != 1:
            continue
        eff, per_ray = lane_efficiency(C, C._load(path, spp=spp,
                                                  depth=depth), w, h, spp,
                                       dev)
        out["lanes"][name] = [eff, per_ray]
        print(f"lanes {name} {w}x{h} spp {spp} depth {depth}: the plain "
              f"run's lane efficiency {eff:.4f} ({per_ray:.3f} bounces a "
              f"ray) on {SAMPLE} warps; {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def time_root(root: str, label: str, only1: bool) -> int:
    """Time one checkout's kernels at every shape; print a JSON line."""
    C, card = _setup(root)
    import numpy as np
    import torch

    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import radiance_grad as RG
    from raytracingrust_tpu_torch.utils import rng

    dev = torch.device("cuda")
    for name in ("megakernel",) if only1 else ("megakernel", "radiance_grad",
                                               "mse_loss"):
        _build.load(name)
    key = rng.base_key(0)
    out = {"root": label, "card": card, "ms": {}, "bits": {}, "checksum": {}}
    for name, kernel, path, w, h, spp, depth in shapes(C):
        if only1 and kernel != 1:
            continue
        scene = C._load(path, spp=spp, depth=depth)
        fp, kinds, opts, sky = C._brute_inputs(scene, w, h, dev)
        gen = np.random.default_rng(0)
        if kernel == 1:
            def run():
                return K.radiance_cuda(fp, kinds, key, w * h * spp, spp, w,
                                       sky=sky, **opts)
        elif kernel == 3:
            sign = np.sign(gen.standard_normal((w * h, 1, 3)))
            cts = torch.tensor(np.broadcast_to(
                sign / (3 * w * h * spp), (w * h, spp, 3)).reshape(-1, 3),
                dtype=torch.float32, device=dev)

            def run():
                g = RG.radiance_grad_cuda(fp, kinds, key, cts, spp, w,
                                          sky=sky, **opts)
                return g if sky is None else g[0]
        else:
            target = torch.tensor(gen.random((w * h, 3)),
                                  dtype=torch.float32, device=dev)

            def run():
                return MS.mse_loss_cuda(
                    fp, kinds, key, target, spp, w,
                    clamp=scene.settings.clamp_indirect, **opts)[1]

        first = run()
        if kernel == 1:
            for _ in range(2):
                again = run()
                if not torch.equal(again.view(torch.int32),
                                   first.view(torch.int32)):
                    raise AssertionError(f"{label} {name}: two launches "
                                         "gave other bits")
            out["bits"][name] = hashlib.sha256(
                first.cpu().numpy().tobytes()).hexdigest()[:16]
        out["checksum"][name] = first.double().abs().sum().item()
        del first
        ms = C._cuda_time_ms(run, REPS)
        out["ms"][name] = ms
        print(f"{label} {name} {w}x{h} spp {spp} depth {depth}: {ms:.4f} ms "
              f"(mean of {REPS}), checksum {out['checksum'][name]:.9e} "
              f"{out['bits'].get(name, '')}; {card}", flush=True)
    out["ptxas"] = C._ptxas_variants(("megakernel",) if only1 else (
        "megakernel", "radiance_grad", "mse_loss"))
    print(out["ptxas"])
    print(json.dumps(out), flush=True)
    return 0


def variant_root(name: str) -> Path:
    """A copy of this checkout's package (and chip_smoke.py) with the
    variant's edits, under build/variants/<name>."""
    root = HERE / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "raytracingrust_tpu_torch",
                    root / "raytracingrust_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", root / "chip_smoke.py")
    for rel, edits in VARIANTS[name].items():
        p = root / "raytracingrust_tpu_torch" / rel
        text = p.read_text()
        for old, new in edits:
            if old == "CLAIM":
                i, j = text.find(_CLAIM_START), text.find(_CLAIM_END)
                if i < 0 or j < i:
                    raise RuntimeError(f"variant {name}: no claim in {rel}")
                text = text[:i] + new + text[j + len(_CLAIM_END):]
                continue
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {rel}")
            text = text.replace(old, new)
        p.write_text(text)
    return root


def run_child(args: list, label: str) -> dict:
    proc = subprocess.run([sys.executable, __file__, *args],
                          capture_output=True, text=True, timeout=1500)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{label} exited with {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root")
    ap.add_argument("--label", default="this")
    ap.add_argument("--only1", action="store_true")
    ap.add_argument("--lanes", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if args.lanes:
        return lanes_root()
    if args.root:
        return time_root(args.root, args.label, args.only1)
    if not args.parent:
        ap.error("give --root (one checkout) or --parent (the comparison)")
    runs = [run_child(["--lanes"], "lanes")]
    for _ in range(args.rounds):
        for root, label in ((args.parent, "P"), (HERE, "C"), (HERE, "C"),
                            (args.parent, "P")):
            runs.append(run_child(["--root", str(root), "--label", label],
                                  label))
    bits = {json.dumps(r["bits"], sort_keys=True) for r in runs[1:]}
    print(f"#1's bits: {'the same' if len(bits) == 1 else 'DIFFERENT'} in "
          f"every parent and change run")
    for name in filter(None, args.variants.split(",")):
        only1 = [] if name in BOUNCE_VARIANTS else ["--only1"]
        r = run_child(["--root", str(variant_root(name)), "--label", name,
                       *only1], name)
        if r["bits"] != runs[2]["bits"]:
            raise AssertionError(f"variant {name} gave other bits")
        runs.append(r)
    print(json.dumps({"runs": runs}))
    return 0 if len(bits) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
