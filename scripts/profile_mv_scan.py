#!/usr/bin/env python3
"""The mesh-volume variants of the BVH kernel (#5, csrc/bvh_forward.cu
``kMv``) of one checkout of the port, timed at chip_smoke.py's fog_sheet
shapes on one GPU.

    python3 scripts/profile_mv_scan.py [--root DIR] [--label NAME] [--leaf N]

``--root`` names the checkout whose package (``DIR/raytracingrust_tpu_torch``)
is imported and built, into ``DIR/build/kernels``; by default this one.
To compare two versions on one card, unpack the other into a git-ignored
directory and run the script in turns (old, new, new, old) in one call.
``--leaf N`` rebuilds the mesh volumes' trees with leaves of N triangles
(a checkout whose scan walks trees: ops/bvh.build_mv_trees) before timing.

fog_sheet (chip_smoke.py phase 12: the 8,192-triangle sheet, an icosphere
of 2,048 triangles and a 12-triangle cube bounding two fogs, spp 8, depth
6), written as chip_smoke.py writes it (into this checkout's build/smoke):
the forward at 1000x1000, the record variant at the fit's 512x512, the
Normal and Random views at 1000x1000.  Each kernel's time (CUDA events, the
mean of REPS launches after a warm-up), a checksum of its output, and the
compiler's registers, stack and spills of #5's variants.  Prints one line
per kernel and, last, one JSON object with every number and the card's
name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS = 5


def _smoke():
    """This checkout's chip_smoke.py, whatever ``--root`` is: it writes
    the scene and holds the timing helper."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this")
    ap.add_argument("--leaf", type=int, default=0)
    args = ap.parse_args()
    os.chdir(HERE)  # the scene is written and read relative to it
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("profile_mv_scan: no CUDA device is available",
              file=sys.stderr)
        return 1
    C = _smoke()
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.utils import rng

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(args.root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {args.root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    _build.load("bvh_forward")
    os.makedirs(C.OUT_DIR, exist_ok=True)
    scene = C._load(C.fog_scene())
    if args.leaf:
        from raytracingrust_tpu_torch.ops.bvh import build_mv_trees

        scene.cbvh = dataclasses.replace(scene.cbvh, mv_trees=build_mv_trees(
            scene.triangles, leaf_size=args.leaf))
    s = scene.settings
    spp, depth = s.samples_per_pixel, s.max_ray_depth
    opts = dict(max_depth=depth, bg_kind=scene.background.kind, clay=False)
    key = rng.base_key(11)
    out = {"root": args.label, "leaf": args.leaf or None, "card": card,
           "ptxas": C._ptxas_variants(("bvh_forward",)), "ms": {},
           "sum": {}}
    cases = []
    for n in (C.FOG_SIZE, C.FOG_FIT_SIZE):
        with torch.no_grad():
            sc = BK.pack(scene, n, n, dev)
        n_rays = n * n * spp
        if n == C.FOG_SIZE:
            cases += [("forward", sc, n, n_rays, dict(opts)),
                      *((f"view_{v}", sc, n, n_rays,
                         dict(opts, max_depth=1, debug=v))
                        for v in ("normal", "random"))]
        else:
            cases.append(("record", sc, n, n_rays, dict(opts, record=True)))
    for label, sc, n, n_rays, o in cases:
        def run():
            return BK.radiance_bvh_cuda(sc, key, n_rays, spp, n, **o)

        got = run()
        rad = got[0] if o.get("record") else got
        total = float(rad.double().sum())
        if o.get("record"):
            total += float(got[1].double().sum())
        ms = C._cuda_time_ms(run, REPS)
        out["ms"][label] = ms
        out["sum"][label] = total
        print(f"{args.label} #5 mv {label} fog_sheet {n}x{n} spp {spp}"
              f"{'' if label.startswith('view') else f' depth {depth}'}: "
              f"{ms:.4f} ms (mean of {REPS}), checksum {total!r}; {card}")
    print(out["ptxas"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
