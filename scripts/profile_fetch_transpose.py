#!/usr/bin/env python3
"""Kernel #7, the transpose of the winner-row fetch (csrc/fetch_rows.cu,
ops/fetch.fetch_rows_transpose_cuda), of checkouts of the port, timed on
the record codes of its main path's shapes, on one GPU.

    python3 scripts/profile_fetch_transpose.py --parent DIR [--rounds N]
        [--variants A,B] [--fit]
    python3 scripts/profile_fetch_transpose.py --root DIR [--label NAME]
        [--fit]

The inputs are made once, with this checkout, and saved under
build/fetch_shapes/: #5's record codes at bvh_stress (1000x1000 spp 8
depth 4), sheet64 (512x512 spp 8 depth 6), grid8k (512x512 spp 5 depth 6),
the zoo (600x400 spp 16 depth 8; raw) and fog_sheet (512x512 spp 8 depth
6; raw, with mesh volumes), chip_smoke.py's scenes under its fit path's
key, with standard normal cotangents from a seeded generator, and the
tables' sizes as ops/bvh_kernel.fetch_inputs gives them.

With ``--root`` it times one checkout's #7 (its package imported, its
fetch_rows.cu built into DIR/build/kernels) at each shape: the mean of
REPS launches after a warm-up (CUDA events), whether three launches gave
the same bits, the largest difference from the float64 plain sums and
whether every entry lies within 1e-5 of its summed magnitudes plus 1e-6 of
the largest (chip_smoke.py's bound), the plan where the checkout has one;
then the compiler's registers and spills of the package's kernels of
fetch_rows.cu and one JSON line.  With ``--fit`` it also times the warm
BVH fit step of chip_smoke.py's FIT_SHAPES (bvh_stress 1000x1000 and
sheet64 512x512, their parameters, a flat target of 0.25):
FIT_STEPS steps of ``diff.inverse.fit``, the median of the warm steps'
wall times, the peak memory PyTorch allocated over them, and the
checkout's chip_smoke.py ``_profile`` of three more steps (device busy
time, #7).

With ``--parent``, DIR a checkout of another commit (a ``git archive``
unpacked under build/), it runs ``--root`` in turns: the parent and this
checkout as parent, change, change, parent (N rounds of that); then each
variant once (``--variants``, all by default, '' none), built from a copy
of this checkout's package under build/variants/ with its edits: kBatch
1, 2 and 8 hits a lane a step (4 in the tree); the small path's 264 and
1,056 blocks (528); the small path wherever 7 warps' copies fit (8 in
the tree: bvh_stress's table then takes it); the large path's copies in
half and in twice the bytes (the latter up to 2,112 copies), and 8 warps
a block (4).  The tree has no switch for any of them.  Last it prints
one JSON object with every run's times.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPES_DIR = HERE / "build" / "fetch_shapes"
REPS = 20
PKG = "raytracingrust_tpu_torch"
SHAPES = ("bvh_stress", "sheet64", "grid8k", "zoo", "fog_sheet")
FIT_STEPS = 12
# variant name -> {file in the package: [(text, replacement)]}
VARIANTS = {
    "batch1": {"csrc/fetch_rows.cu": [("constexpr int kBatch = 4;",
                                       "constexpr int kBatch = 1;")]},
    "batch2": {"csrc/fetch_rows.cu": [("constexpr int kBatch = 4;",
                                       "constexpr int kBatch = 2;")]},
    "batch8": {"csrc/fetch_rows.cu": [("constexpr int kBatch = 4;",
                                       "constexpr int kBatch = 8;")]},
    "ranges264": {"ops/fetch.py": [("RANGES = 528", "RANGES = 264")]},
    "ranges1056": {"ops/fetch.py": [("RANGES = 528", "RANGES = 1056")]},
    "small7": {"ops/fetch.py": [("SMALL_WARPS = 8", "SMALL_WARPS = 7")]},
    "copies_half": {"ops/fetch.py": [("COPY_BYTES = 192 << 20",
                                      "COPY_BYTES = 96 << 20")]},
    "copies_double": {"ops/fetch.py": [
        ("COPY_BYTES = 192 << 20", "COPY_BYTES = 384 << 20"),
        ("MAX_COPIES = 1056", "MAX_COPIES = 2112")]},
    "large_warps8": {"ops/fetch.py": [("LARGE_WARPS = 4",
                                       "LARGE_WARPS = 8")]},
}


def prepare() -> None:
    """Make and save every shape's inputs, unless already saved."""
    if all((SHAPES_DIR / f"{s}.pt").exists() for s in SHAPES):
        return
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as C
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.utils import rng

    dev = torch.device("cuda")
    os.makedirs(C.OUT_DIR, exist_ok=True)
    paths = {label: p for label, p, *_ in C.bvh_scenes()}
    fw, fh, f_spp = C.ZOO_FIT
    scenes = {
        "bvh_stress": (SceneBuilder.from_file(paths["bvh_stress"]).build(),
                       1000, 1000),
        "sheet64": (SceneBuilder.from_file(paths["sheet64"]).build(), 512,
                    512),
        "grid8k": (SceneBuilder.from_file(paths["grid8k"]).build(), 512,
                   512),
        "zoo": (C._load(C.ZOO, spp=f_spp), fw, fh),
        "fog_sheet": (C._load(C.fog_scene()), C.FOG_FIT_SIZE,
                      C.FOG_FIT_SIZE)}
    key = rng.base_key(11)
    SHAPES_DIR.mkdir(parents=True, exist_ok=True)
    for i, (label, (scene, w, h)) in enumerate(scenes.items()):
        s = scene.settings
        with torch.no_grad():
            sc = BK.pack(scene, w, h, dev)
            _, codes = BK.radiance_bvh_cuda(
                sc, key, w * h * s.samples_per_pixel, s.samples_per_pixel,
                w, record=True, max_depth=s.max_ray_depth,
                bg_kind=scene.background.kind, clay=False)
        (kinds, tri_base, sph_mat, tri_mat, _, sph_geo, tri_geo, raw,
         mv_base, mv_mat) = BK.fetch_inputs(sc)
        g = 4 if tri_geo is None else 12
        g_rows = torch.randn((g + (0 if raw else 8), *codes.shape),
                             device=dev,
                             generator=torch.Generator(dev).manual_seed(i))
        targs = (codes, g_rows, tri_base, sph_mat, tri_mat, kinds.shape[0],
                 0 if sph_geo is None else sph_geo.shape[0],
                 0 if tri_geo is None else tri_geo.shape[0], raw, mv_base,
                 mv_mat)
        torch.save({"args": [a.cpu() if torch.is_tensor(a) else a
                             for a in targs],
                    "size": f"{w}x{h} spp {s.samples_per_pixel} depth "
                            f"{s.max_ray_depth}"},
                   SHAPES_DIR / f"{label}.pt")
        hit = codes[codes >= 0] & BK.REC_SLOT
        print(f"{label}: {codes.numel()} codes, {hit.numel()} hits, the "
              f"most on one slot {int(torch.bincount(hit).max())}",
              flush=True)
        del sc, codes, g_rows
        torch.cuda.empty_cache()


def time_root(root: str, label: str, fit: bool = False) -> int:
    """Time one checkout's #7 at every shape, and with ``fit`` its fit
    steps; print a JSON line."""
    os.chdir(HERE)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("profile_fetch_transpose: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import fetch as F

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    path = _build.library_path(name="fetch_rows")
    if not path.exists():
        _build.build(path, name="fetch_rows")
    out = {"root": label, "card": card, "ms": {}, "identical": {},
           "err": {}, "within": {}, "path": {}}
    for shape in SHAPES:
        saved = torch.load(SHAPES_DIR / f"{shape}.pt")
        args = tuple(a.to(dev) if torch.is_tensor(a) else a
                     for a in saved["args"])
        runs = [F.fetch_rows_transpose_cuda(*args) for _ in range(3)]
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for run in runs[1:] for a, b in zip(run, runs[0])
                   if a is not None)
        g64 = args[1].double()
        exact = F.fetch_rows_transpose_plain(args[0], g64, *args[2:])
        mag = F.fetch_rows_transpose_plain(args[0], g64.abs(), *args[2:])
        err, within = 0.0, True
        for got, want, m in zip(runs[0], exact, mag):
            if want is None:
                continue
            e = (got.double() - want).abs()
            err = max(err, e.max().item())
            within &= bool((e <= C.FETCH_RTOL * m + 1e-6 * m.max()).all())
        del runs, g64, exact, mag
        ms = C._cuda_time_ms(lambda: F.fetch_rows_transpose_cuda(*args),
                             REPS)
        parts = _by_kernel(torch, lambda: F.fetch_rows_transpose_cuda(*args))
        plan = "none"
        if hasattr(F, "transpose_plan"):
            n_sph, n_tri = (args[6] if args[3] is not None else 0,
                            args[7] if args[4] is not None else 0)
            p = F.transpose_plan(F.table_floats(n_sph, n_tri, args[5],
                                                args[8]))
            plan = C._plan_text(p)
        out["ms"][shape], out["identical"][shape] = ms, same
        out["err"][shape], out["within"][shape] = err, within
        out["path"][shape] = plan
        out.setdefault("kernels", {})[shape] = parts
        print(f"{label} #7 {shape} {saved['size']}: {ms:.4f} ms (mean of "
              f"{REPS}); three launches bit-identical {same}; max abs diff "
              f"from the float64 sums {err:.3e}, within the bound {within}; "
              f"{plan}; {card}", flush=True)
        print(f"{label} #7 {shape} by kernel: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in parts.items()), flush=True)
        del args
        torch.cuda.empty_cache()
    # a parent checkout imports its own chip_smoke.py, which may not have it
    out["ptxas"] = (C._ptxas_fetch() if hasattr(C, "_ptxas_fetch")
                    else "not reported by this checkout's chip_smoke.py")
    print(out["ptxas"])
    if fit:
        out["fit"] = time_fit(C, dev, label, card)
    print(json.dumps(out), flush=True)
    return 0


def time_fit(C, dev, label: str, card: str) -> dict:
    """The warm fit step of each of C.FIT_SHAPES with this checkout's
    package (``--fit``): -> {shape: {warm_ms, steps, peak_gb, busy_ms,
    ms_7}}."""
    import time

    import numpy as np
    import torch

    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.models.scene import SceneBuilder

    paths = {lb: p for lb, p, *_ in C.bvh_scenes()}
    out = {}
    for shape, w, h, names in C.FIT_SHAPES:
        scene = SceneBuilder.from_file(paths[shape]).build()
        target = np.full((h, w, 3), 0.25, np.float32)
        names = names.split(",")
        ticks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fit(scene, target, names, w, h, steps=FIT_STEPS, device=dev,
            callback=lambda *_: ticks.append(time.perf_counter()))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        warm = sorted(b - a for a, b in zip(ticks[1:], ticks[2:]))
        part = C._profile(lambda step: fit(
            scene, target, names, w, h, steps=3, device=dev,
            callback=lambda *_: step()), 2)
        r = out[shape] = dict(
            warm_ms=warm[len(warm) // 2] * 1e3, steps=len(warm),
            warm_range_ms=(warm[0] * 1e3, warm[-1] * 1e3), peak_gb=peak_gb,
            busy_ms=part["busy"], ms_7=part["#7"])
        print(f"{label} fit {shape} {w}x{h}: warm step {r['warm_ms']:.3f} "
              f"ms (median of {r['steps']}, {r['warm_range_ms'][0]:.3f}-"
              f"{r['warm_range_ms'][1]:.3f}), peak memory {peak_gb:.3f} GB; "
              f"under torch.profiler a step: busy {r['busy_ms']:.3f} ms, "
              f"#7 {r['ms_7']:.4f} ms; {card}", flush=True)
        del scene
        torch.cuda.empty_cache()
    return out


def _by_kernel(torch, run, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``run`` launches, under
    torch.profiler over ``calls`` calls after a warm-up."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    part = collections.Counter()
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            name = evt.name()
            for short in ("transpose_compact_kernel",
                          "transpose_reduce_kernel", "transpose_kernel",
                          "memset", "memcpy"):
                if short in name:
                    name = short
                    break
            part[name[:40]] += evt.duration_ns() / 1e6 / calls
    return dict(part)


def variant_root(name: str) -> Path:
    """A copy of this checkout's package with the variant's edits, under
    build/variants/<name>."""
    root = HERE / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, subs in VARIANTS[name].items():
        p = root / PKG / rel
        text = p.read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {rel}")
            text = text.replace(old, new)
        p.write_text(text)
    return root


def run_child(root: Path, label: str, fit: bool = False) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--root", str(root), "--label", label]
        + (["--fit"] if fit else []),
        capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        return {"root": label, "failed": proc.returncode}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root")
    ap.add_argument("--label", default="this")
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="the variants to run, comma-separated ('' none)")
    ap.add_argument("--fit", action="store_true",
                    help="also time each checkout's warm BVH fit steps")
    args = ap.parse_args()
    if args.root:
        return time_root(args.root, args.label, args.fit)
    if not args.parent:
        ap.error("give --root (one checkout) or --parent (the comparison)")
    prepare()
    parent = Path(args.parent).resolve()
    runs = []
    for _ in range(args.rounds):
        for root, label in ((parent, "P"), (HERE, "C"), (HERE, "C"),
                            (parent, "P")):
            runs.append(run_child(root, label, args.fit))
    for name in filter(None, args.variants.split(",")):
        runs.append(run_child(variant_root(name), name))
    print(json.dumps({"runs": runs}))
    return 0 if all("failed" not in r for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
