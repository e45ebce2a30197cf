#!/usr/bin/env python3
"""Kernel #5's walk (csrc/bvh_forward.cu over csrc/bvh_walk.cuh) of
checkouts of the port, timed at the shapes of its main path, with #8
(csrc/occlusion.cu, which shares the walk's header), on one GPU.

    python3 scripts/profile_bvh_walk.py --parent DIR [--rounds N]
        [--kernels LIST] [--variants LIST]
    python3 scripts/profile_bvh_walk.py --root DIR [--label NAME]
        [--kernels LIST]

With ``--parent``, DIR a checkout of another commit (a ``git archive``
unpacked under build/), the script runs itself once a checkout, in turns:
the parent and this checkout as parent, change, change, parent (N rounds
of that); then variants built from copies of a package under
build/variants/, each once, timing the kernels of ``--kernels`` (#8
alone if it is not given; ``--variants``, a comma list of VARIANTS'
names, by default #8's: this checkout with the dense loop for
chunks of at most 32 and of at most 96 slots (bvh_walk.cuh kSubDense,
which #5 shares), with the any-hit exit after a small leaf's last slot
rather than at its first candidate, with #8's launch bounds asking for 8
and for 16 blocks an SM (ptxas then caps the registers at 64 and 32), and
with the sphere tree's nodes staged in each block's shared memory before
the walk (where they fit, 255 nodes; the walk's node loads then plain
loads, not __ldg).  The variants of #5's walk stay in VARIANTS: leaves of 8
and 16 slots (ops/bvh.SUB_LEAF), the tightened bound inside a chunk, one
loop, the radiance kernel without its 8 blocks an SM, the parent and this
checkout without the mesh volumes' crossing scan.  The tree has no switch
for any of them.  Last it prints one JSON object with every run's times.
``--kernels``: a comma list of the kernels to time ("#5", "#8", "#1"; a
shape's kernel is kept when it starts with one of them), all by default.

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
summed over its launches, and at sky_zoo (600x400 spp 16 depth 8, its
chunk of 47 spheres under the dense loop); and #1 ext+sky+tri at
tri_zoo_sky (600x400 spp 16 depth 8), whose code the walk does not touch.
#8's time is the kernel's alone: where the checkout's wrapper takes the
small trees' boxes, those of the render are handed to every launch, as
env_radiance does, and their time is printed apart.  The scenes are
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
# #8's variants, the default of --variants
OCC_VARIANTS = ("dense32", "dense96", "leafexit", "lb8", "lb16", "smem")
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
    "leafexit": ("C", {"csrc/bvh_walk.cuh": [
        ("""      if (kAnyHit && ti < tb) {  // the first candidate ends the walk
        c_best = ti;
        c_win = s;
        return;
      }""", """      if (kAnyHit && ti < tb && !(c_best < tb)) {
        c_best = ti;
        c_win = s;
      }"""),
        ("""        c_win = s;
      }
    }
  }
}""", """        c_win = s;
      }
    }
    if (kAnyHit && c_best < tb) return;  // after the leaf's last slot
  }
}""")]}),
    "lb8": ("C", {"csrc/occlusion.cu": [
        ("__launch_bounds__(kThreads)\nocclusion_kernel(",
         "__launch_bounds__(kThreads, 8)\nocclusion_kernel(")]}),
    "lb16": ("C", {"csrc/occlusion.cu": [
        ("__launch_bounds__(kThreads)\nocclusion_kernel(",
         "__launch_bounds__(kThreads, 16)\nocclusion_kernel(")]}),
    "smem": ("C", {
        "csrc/occlusion.cu": [
            ("""  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;  // the ragged last block""",
             """  __shared__ float st_f[6 * 255];
  __shared__ int st_i[3 * 255];
  if (sph.n_nodes <= 255) {
    for (int k = threadIdx.x; k < 6 * sph.n_nodes; k += blockDim.x)
      st_f[k] = __ldg(sph.nodes_f + k);
    for (int k = threadIdx.x; k < 3 * sph.n_nodes; k += blockDim.x)
      st_i[k] = __ldg(sph.nodes_i + k);
    __syncthreads();
    sph.nodes_f = st_f;
    sph.nodes_i = st_i;
  }
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;  // the ragged last block""")],
        "csrc/bvh_walk.cuh": [
            ("""    const float t0x = (__ldg(box + 0) - r.ox) * r.idx;
    const float t0y = (__ldg(box + 1) - r.oy) * r.idy;
    const float t0z = (__ldg(box + 2) - r.oz) * r.idz;
    const float t1x = (__ldg(box + 3) - r.ox) * r.idx;
    const float t1y = (__ldg(box + 4) - r.oy) * r.idy;
    const float t1z = (__ldg(box + 5) - r.oz) * r.idz;""",
             """    const float t0x = (box[0] - r.ox) * r.idx;
    const float t0y = (box[1] - r.oy) * r.idy;
    const float t0z = (box[2] - r.oz) * r.idz;
    const float t1x = (box[3] - r.ox) * r.idx;
    const float t1y = (box[4] - r.oy) * r.idy;
    const float t1z = (box[5] - r.oz) * r.idz;"""),
            ("""    if (!(exit_ > entry)) {
      node = __ldg(links + 1);
      continue;
    }
    const int chunk = __ldg(links + 2);""", """    if (!(exit_ > entry)) {
      node = links[1];
      continue;
    }
    const int chunk = links[2];"""),
            ("""    node = __ldg(links + 0);
  }
}

}  // namespace rtrt""", """    node = links[0];
  }
}

}  // namespace rtrt""")]}),
    "P_nomv": ("P", {"csrc/bvh_forward.cu": [
        ("if (kMv)\n      mesh_volume_scan(", "if (false)\n"
         "      mesh_volume_scan(")]}),
    "C_nomv": ("C", {"csrc/bvh_forward.cu": [
        ("if (kMv)\n      mesh_volume_scan(", "if (false)\n"
         "      mesh_volume_scan(")]}),
}


def shapes(C, torch, dev, kernels=()):
    """(label, scene, width, height, kernel, options) of every shape whose
    kernel starts with one of ``kernels`` (every shape if empty); the
    scenes written by chip_smoke.py (module ``C``)."""
    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.models.scene import SceneBuilder

    def want(kernel):
        return not kernels or any(kernel.startswith(k) for k in kernels)

    os.makedirs(C.OUT_DIR, exist_ok=True)
    if not os.path.exists(C.SKY):
        C.procedural_sky(C.SKY)
    out = []
    fw, fh, f_spp = C.ZOO_FIT
    if want("#5"):
        for label, path, w, h, _ in C.bvh_scenes():
            scene = SceneBuilder.from_file(path).build()
            out += [(label, scene, w, h, "#5", {}),
                    (label, scene, w, h, "#5 record", {})]
        zw, zh = C.ZOO_RENDER
        out += [("zoo", C._load(C.ZOO), zw, zh, "#5", {}),
                ("zoo", C._load(C.ZOO, spp=f_spp), fw, fh, "#5 record", {})]
        for label, path, _ in C.sky_scenes():
            scene = SceneBuilder.from_file(path).build()
            n = C.SKY_SIZE
            out += [(label, scene, n, n, "#5 sky",
                     {"sky": scene.to(dev).background}),
                    (label, scene, n, n, "#5 record",
                     {"bg_kind": B.UNIFORM})]
        fog = C._load(C.fog_scene())
        out += [("fog_sheet", fog, C.FOG_SIZE, C.FOG_SIZE, "#5 mv", {}),
                ("fog_sheet", fog, C.FOG_FIT_SIZE, C.FOG_FIT_SIZE,
                 "#5 record", {})]
    tri = ({label: path for label, path, *_ in C.tri_scenes()}
           if want("#5") or want("#1") else {})
    if want("#5"):
        scene = SceneBuilder.from_file(tri["tri_brute"]).build(with_bvh=True)
        bw, bh, _, _ = C.TRI_RENDER
        tw, th, _ = C.TRI_FIT
        out += [("tri_brute bvh", scene, bw, bh, "#5", {}),
                ("tri_brute bvh", scene, tw, th, "#5 record", {})]
    if want("#8"):
        for label, path, w, h, _ in C.env_scenes():
            out.append((label, SceneBuilder.from_file(path).build(), w, h,
                        "#8", {}))
        sky_zoo = C._write_scene(C.ZOO, "sky_zoo.json", sky=True,
                                 samples_per_pixel=f_spp)
        out.append(("sky_zoo", C._load(sky_zoo), fw, fh, "#8", {}))
    if want("#1"):
        # #1 ext+sky+tri, which the walk leaves as it is: its time at the
        # shape PERF.md gives two ranges for
        out.append(("tri_zoo_sky", C._load(tri["tri_zoo_sky"]), fw, fh,
                    "#1 ext+sky+tri", {}))
    return out


def _shadow_rays(BK, OC, sc, sky, key, n_pix, spp, w, depth):
    """The shadow rays of one env render through the kernels (#8's
    arguments at each of its launches, with the keywords the render
    passed: the small trees' boxes, where the checkout's wrapper takes
    them)."""
    import torch

    rays, occluded = [], OC.occluded

    def record(sc_, o, d, ray_ids=None, key=None, stream=0, **kw):
        rays.append((o, d, ray_ids, stream, kw))
        return occluded(sc_, o, d, ray_ids, key, stream, **kw)

    OC.occluded = record
    try:
        with torch.no_grad():
            BK.env_radiance(sc, sky, key, n_pix, spp, w, max_depth=depth)
    finally:
        OC.occluded = occluded
    return rays


def time_root(root: str, label: str, kernels=None) -> int:
    """Time one checkout's #5, #8 and #1 at every shape (of ``kernels``,
    a list of prefixes, if given); print a JSON line."""
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
    for name, scene, w, h, kernel, extra in shapes(C, torch, dev, kernels):
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
                return [OC.occluded(sc, o, d, ids, key, st, **kw)
                        for o, d, ids, st, kw in rays]

            checksum = sum(int(v.sum()) for v in run())
            ms = C._cuda_time_ms(run, REPS)
            if hasattr(BK, "scene_sub_boxes"):  # the boxes, once a render
                out["ms"][f"#8 boxes {name}"] = C._cuda_time_ms(
                    lambda: BK.scene_sub_boxes(sc), REPS)
                print(f"{label} #8 boxes {name}: "
                      f"{out['ms'][f'#8 boxes {name}']:.4f} ms a render")
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


def run_child(root: Path, label: str, kernels: str) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--root", str(root), "--label", label,
         "--kernels", kernels], capture_output=True, text=True, timeout=1500)
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
    ap.add_argument("--kernels", default="")
    ap.add_argument("--variants", default=",".join(OCC_VARIANTS))
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if args.root:
        return time_root(args.root, args.label, kernels)
    if not args.parent:
        ap.error("give --root (one checkout) or --parent (the comparison)")
    parent = Path(args.parent).resolve()
    runs = []
    for _ in range(args.rounds):
        for root, label in ((parent, "P"), (HERE, "C"), (HERE, "C"),
                            (parent, "P")):
            runs.append(run_child(root, label, args.kernels))
    for name in (v for v in args.variants.split(",") if v):
        runs.append(run_child(variant_root(name, parent), name,
                              args.kernels or "#8"))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
