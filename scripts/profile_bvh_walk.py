#!/usr/bin/env python3
"""Kernel #5's walk (csrc/bvh_forward.cu over csrc/bvh_walk.cuh) of
checkouts of the port, timed at the shapes of its main path, with #8
(csrc/occlusion.cu, which shares the walk's header), on one GPU.

    python3 scripts/profile_bvh_walk.py --parent DIR [--rounds N]
    python3 scripts/profile_bvh_walk.py --root DIR [--label NAME]

With ``--parent``, DIR a checkout of another commit (a ``git archive``
unpacked under build/), the script runs itself once a checkout, in turns:
the parent and this checkout as parent, change, change, parent (N rounds
of that); then variants built from copies of a package under
build/variants/, each once: this checkout with the small trees' leaves of
8 and of 16 slots (ops/bvh.SUB_LEAF edited in the copy), with the dense
loop for chunks of at most 32 and of at most 96 slots (bvh_walk.cuh
kSubDense), with the walk inside a chunk that tightens its bound to the
best candidate found so far (sub_walk's ``entry <= tb``), with a leaf's
slots tested where the walk finds it (one loop, not the while-while),
with the radiance kernel's launch bounds without their 8 blocks an SM
(ptxas then picks the registers), and the parent and this checkout
without the mesh volumes' crossing scan (bvh_forward.cu's ``if (kMv)``
before mesh_volume_scan made false), whose fog_sheet times give the share
of the sheet's walk in the ``kMv`` launches.  The tree has no switch for
any of them.  Last it prints one JSON object with every run's times.

With ``--root`` it times one checkout (its package imported, #5, #8 and
#1 built into DIR/build/kernels): #5 forward and record at bvh_stress
(1000x1000 spp 8 depth 4), grid8k (512x512 spp 5 depth 6), sheet64
(512x512 spp 8 depth 6), the zoo (1200x800 spp 32 depth 8; record at
600x400 spp 16), the sky map variant at sky_bvh_stress and sky_sheet64
(1000x1000 spp 8; their record under a black background), fog_sheet
(``kMv``, 1000x1000 spp 8 depth 6; record at 512x512) and tri_brute built
with its BVH (1000x1000 spp 8 depth 6; record at 512x512); #8 at
sky_bvh_stress (1000x1000 spp 8 depth 4) and sky_sheet64 (512x512 spp 8
depth 6) with importance sampling, on the shadow rays of one env render,
summed over its launches; and #1 ext+sky+tri at tri_zoo_sky (600x400
spp 16 depth 8), whose code the walk does not touch.  The scenes are
written as chip_smoke.py writes them, into this checkout's build/smoke.
Each shape: the kernel's time (CUDA events, the mean of REPS calls after
a warm-up) and a checksum of its output; then the compiler's registers,
stack and spills of every instance of #5 and #8, and one JSON line.
Needs one CUDA device.
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
REPS = 5
PKG = "raytracingrust_tpu_torch"
# variant name -> (the checkout it edits, {file in the package: [(text,
# replacement)]})
VARIANTS = {
    "sub8": ("C", {"ops/bvh.py": [("SUB_LEAF = 4", "SUB_LEAF = 8")]}),
    "sub16": ("C", {"ops/bvh.py": [("SUB_LEAF = 4", "SUB_LEAF = 16")]}),
    "dense32": ("C", {"csrc/bvh_walk.cuh": [
        ("constexpr int kSubDense = 64;", "constexpr int kSubDense = 32;")]}),
    "dense96": ("C", {"csrc/bvh_walk.cuh": [
        ("constexpr int kSubDense = 64;", "constexpr int kSubDense = 96;")]}),
    "tight": ("C", {"csrc/bvh_walk.cuh": [
        ("if (!(entry <= exit_ && entry <= tb && exit_ >= kTMin)) {",
         "if (!(entry <= exit_ && entry <= fminf(tb, c_best) &&\n"
         "            exit_ >= kTMin)) {")]}),
    "lb0": ("C", {"csrc/bvh_forward.cu": [
        ("__launch_bounds__(kThreads, 8)\nbvh_radiance_kernel(",
         "__launch_bounds__(kThreads)\nbvh_radiance_kernel(")]}),
    "oneloop": ("C", {"csrc/bvh_walk.cuh": [
        ("""      if (word >> 16) {
        found = word;
        break;
      }""", """      if (word >> 16) {
        const int start = (word >> 8) & 0xff;
        for (int j = 0; j < (word >> 16); ++j) {
          const int s = base + __ldg(sub.order + base + start + j);
          const float ti = kKind == kSphereTree
                               ? sphere_t(tree.geo, s, r, tb)
                               : triangle_t(tree.geo, s, r, tb);
          if (ti < c_best || (ti == c_best && s < c_win)) {
            c_best = ti;
            c_win = s;
          }
        }
      }""")]}),
    "P_nomv": ("P", {"csrc/bvh_forward.cu": [
        ("if (kMv)\n      mesh_volume_scan(", "if (false)\n"
         "      mesh_volume_scan(")]}),
    "C_nomv": ("C", {"csrc/bvh_forward.cu": [
        ("if (kMv)\n      mesh_volume_scan(", "if (false)\n"
         "      mesh_volume_scan(")]}),
}


def shapes(C, torch, dev):
    """(label, scene, width, height, kernel, options) of every shape; the
    scenes written by chip_smoke.py (module ``C``)."""
    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.models.scene import SceneBuilder

    os.makedirs(C.OUT_DIR, exist_ok=True)
    if not os.path.exists(C.SKY):
        C.procedural_sky(C.SKY)
    out = []
    paths = {label: (p, w, h) for label, p, w, h, _ in C.bvh_scenes()}
    for label, (path, w, h) in paths.items():
        scene = SceneBuilder.from_file(path).build()
        out += [(label, scene, w, h, "#5", {}),
                (label, scene, w, h, "#5 record", {})]
    zoo = C._load(C.ZOO)
    zw, zh = C.ZOO_RENDER
    fw, fh, f_spp = C.ZOO_FIT
    out += [("zoo", zoo, zw, zh, "#5", {}),
            ("zoo", C._load(C.ZOO, spp=f_spp), fw, fh, "#5 record", {})]
    for label, path, _ in C.sky_scenes():
        scene = SceneBuilder.from_file(path).build()
        n = C.SKY_SIZE
        out += [(label, scene, n, n, "#5 sky",
                 {"sky": scene.to(dev).background}),
                (label, scene, n, n, "#5 record", {"bg_kind": B.UNIFORM})]
    fog = C._load(C.fog_scene())
    out += [("fog_sheet", fog, C.FOG_SIZE, C.FOG_SIZE, "#5 mv", {}),
            ("fog_sheet", fog, C.FOG_FIT_SIZE, C.FOG_FIT_SIZE, "#5 record",
             {})]
    tri = {label: path for label, path, *_ in C.tri_scenes()}
    scene = SceneBuilder.from_file(tri["tri_brute"]).build(with_bvh=True)
    bw, bh, _, _ = C.TRI_RENDER
    tw, th, _ = C.TRI_FIT
    out += [("tri_brute bvh", scene, bw, bh, "#5", {}),
            ("tri_brute bvh", scene, tw, th, "#5 record", {})]
    for label, path, w, h, _ in C.env_scenes():
        out.append((label, SceneBuilder.from_file(path).build(), w, h, "#8",
                    {}))
    # #1 ext+sky+tri, which the walk leaves as it is: its time at the
    # shape PERF.md gives two ranges for
    out.append(("tri_zoo_sky", C._load(tri["tri_zoo_sky"]), fw, fh,
                "#1 ext+sky+tri", {}))
    return out


def _shadow_rays(BK, OC, sc, sky, key, n_pix, spp, w, depth):
    """The shadow rays of one env render through the kernels (#8's
    arguments at each of its launches)."""
    import torch

    rays, occluded = [], OC.occluded

    def record(sc_, o, d, ray_ids=None, key=None, stream=0):
        rays.append((o, d, ray_ids, stream))
        return occluded(sc_, o, d, ray_ids, key, stream)

    OC.occluded = record
    try:
        with torch.no_grad():
            BK.env_radiance(sc, sky, key, n_pix, spp, w, max_depth=depth)
    finally:
        OC.occluded = occluded
    return rays


def time_root(root: str, label: str) -> int:
    """Time one checkout's #5 and #8 at every shape; print a JSON line."""
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("profile_bvh_walk: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import occlusion as OC
    from raytracingrust_tpu_torch.utils import rng

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    jobs = [(path, *_build._start(path, _build.NVCC_FLAGS, name))
            for name in ("bvh_forward", "occlusion", "megakernel")
            if not (path := _build.library_path(name=name)).exists()]
    for job in jobs:
        _build._finish(*job)
    key = rng.base_key(11)
    out = {"root": label, "card": card, "ms": {}, "checksum": {}}
    for name, scene, w, h, kernel, extra in shapes(C, torch, dev):
        s = scene.settings
        spp, depth = s.samples_per_pixel, s.max_ray_depth
        n_rays = w * h * spp
        sc = None
        if not kernel.startswith("#1"):
            with torch.no_grad():
                sc = BK.pack(scene, w, h, dev)
        opts = {"max_depth": depth, "bg_kind": scene.background.kind,
                "clay": False, **extra}
        if kernel.startswith("#1"):
            from raytracingrust_tpu_torch.ops import megakernel as K

            fp, kinds, b_opts, sky = C._brute_inputs(scene, w, h, dev)

            def run():
                return K.radiance_cuda(fp, kinds, key, n_rays, spp, w,
                                       sky=sky, **b_opts)

            checksum = float(run().double().sum())
            ms = C._cuda_time_ms(run, REPS)
        elif kernel == "#8":
            sky = scene.to(dev).background
            rays = _shadow_rays(BK, OC, sc, sky, key, w * h, spp, w, depth)

            def run():
                return [OC.occluded(sc, o, d, ids, key, st)
                        for o, d, ids, st in rays]

            checksum = sum(int(v.sum()) for v in run())
            ms = C._cuda_time_ms(run, REPS)
        else:
            record = kernel == "#5 record"

            def run():
                return BK.radiance_bvh_cuda(sc, key, n_rays, spp, w,
                                            record=record, **opts)

            got = run()
            checksum = (float(got[0].double().sum())
                        + float(got[1].double().sum()) if record
                        else float(got.double().sum()))
            ms = C._cuda_time_ms(run, REPS)
        tag = f"{kernel} {name}"
        out["ms"][tag] = ms
        out["checksum"][tag] = checksum
        print(f"{label} {tag} {w}x{h} spp {spp} depth {depth}: {ms:.4f} ms "
              f"(mean of {REPS}), checksum {checksum!r}; {card}", flush=True)
        del sc
        torch.cuda.empty_cache()
    out["ptxas"] = C._ptxas_variants(("bvh_forward", "occlusion"))
    print(out["ptxas"])
    print(json.dumps(out), flush=True)
    return 0


def variant_root(name: str, parent: Path) -> Path:
    """A copy of a checkout's package with the variant's edits, under
    build/variants/<name>."""
    base, edits = VARIANTS[name]
    src = parent if base == "P" else HERE
    root = HERE / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, subs in edits.items():
        p = root / PKG / rel
        text = p.read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {rel}")
            text = text.replace(old, new)
        p.write_text(text)
    return root


def run_child(root: Path, label: str) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--root", str(root), "--label", label],
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
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if args.root:
        return time_root(args.root, args.label)
    if not args.parent:
        ap.error("give --root (one checkout) or --parent (the comparison)")
    parent = Path(args.parent).resolve()
    runs = []
    for _ in range(args.rounds):
        for root, label in ((parent, "P"), (HERE, "C"), (HERE, "C"),
                            (parent, "P")):
            runs.append(run_child(root, label))
    for name in VARIANTS:
        runs.append(run_child(variant_root(name, parent), name))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
