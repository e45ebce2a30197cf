#!/usr/bin/env python3
"""The radiance gradient kernel (#3, csrc/radiance_grad.cu) of one checkout
of the port, timed at the six shapes of its main path, on one GPU.

    python3 scripts/profile_radiance_grad.py [--root DIR] [--label NAME]

``--root`` names the checkout whose package (``DIR/raytracingrust_tpu_torch``)
is imported and built, into ``DIR/build/kernels``; by default this one.
To compare two versions on one card, unpack the other into a git-ignored
directory and run the script in turns (old, new, new, old) in one call.

The shapes, the scene JSONs written as chip_smoke.py writes them (into
this checkout's build/smoke): base, benchmark.json 512x512 spp 8 depth 6
(solid spheres); ext, material_zoo.json 600x400 spp 16 depth 8 (kExt);
sky, sky_bench 512x512 spp 8 depth 6 (kSky); ext+sky, sky_zoo_naive
600x400 spp 16 depth 8; tri, tri_brute 512x512 spp 8 depth 6 (kTri);
ext+sky+tri, tri_zoo_sky 600x400 spp 16 depth 8.  The cotangents are
numpy-seeded: an L1 loss's (the sign of a random error over 3 H W spp, the
same for a pixel's samples) at ext and tri, whose #3 launch on the main
path is a loss of the caller's own, and standard normal draws elsewhere.
Each shape: the kernel's time (CUDA events, the mean of REPS launches
after a warm-up), the sum of |dfparams| as a checksum, and the compiler's
registers, stack and spills of each instance.  Prints one line per shape
and, last, one JSON object with every number and the card's name and
power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS = 10


def shapes(C) -> tuple:
    """(label, scene JSON, width, height, spp, depth, L1-style cotangents)
    of #3's six shapes, the sky and triangle scenes written by chip_smoke.py
    (module ``C``)."""
    os.makedirs(C.OUT_DIR, exist_ok=True)
    brute = {label: path for label, path, *_ in C.brute_scenes()}
    tri = {label: path for label, path, *_ in C.tri_scenes()}
    fw, fh, f_spp = C.ZOO_FIT
    return (("base", C.BENCH, 512, 512, 8, 6, False),
            ("ext", C.ZOO, fw, fh, f_spp, 8, True),
            ("sky", brute["sky_bench"], C.SKY_BENCH_FIT, C.SKY_BENCH_FIT,
             C.SKY_BENCH[2], C.SKY_BENCH[3], False),
            ("ext+sky", brute["sky_zoo_naive"], fw, fh, f_spp, 8, False),
            ("tri", tri["tri_brute"], *C.TRI_FIT, 6, True),
            ("ext+sky+tri", tri["tri_zoo_sky"], fw, fh, f_spp, 8, False))


def cotangents(w: int, h: int, spp: int, l1: bool, dev):
    """(w h spp, 3) float32 cotangents from a numpy generator seeded 0."""
    import numpy as np
    import torch

    gen = np.random.default_rng(0)
    if l1:
        sign = np.sign(gen.standard_normal((w * h, 1, 3)))
        cts = np.broadcast_to(sign / (3 * w * h * spp), (w * h, spp, 3))
    else:
        cts = gen.standard_normal((w * h * spp, 3))
    return torch.tensor(cts.reshape(-1, 3), dtype=torch.float32, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("profile_radiance_grad: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import radiance_grad as RG
    from raytracingrust_tpu_torch.utils import rng

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(args.root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {args.root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    _build.load("radiance_grad")
    regs = C._ptxas_variants(("radiance_grad",))
    key = rng.base_key(0)
    out = {"root": args.label, "card": card,
           "ptxas": regs, "ms": {}, "checksum": {}}
    for label, scene_path, w, h, spp, depth, l1 in shapes(C):
        scene = C._load(scene_path, spp=spp, depth=depth)
        fp, kinds, opts, sky = C._brute_inputs(scene, w, h, dev)
        cts = cotangents(w, h, spp, l1, dev)

        def run():
            return RG.radiance_grad_cuda(fp, kinds, key, cts, spp, w,
                                         sky=sky, **opts)

        got = run()
        dfp = got if sky is None else got[0]
        checksum = dfp.abs().sum().item()
        ms = C._cuda_time_ms(run, REPS)
        out["ms"][label] = ms
        out["checksum"][label] = checksum
        print(f"{args.label} #3 {label} {w}x{h} spp {spp} depth {depth}: "
              f"{ms:.4f} ms (mean of {REPS}), sum |dfparams| "
              f"{checksum:.7e}; {card}", flush=True)
    print(regs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
