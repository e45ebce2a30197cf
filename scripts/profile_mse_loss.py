#!/usr/bin/env python3
"""The fused loss kernel (#4, csrc/mse_loss.cu) of one checkout of the
port, timed at the fit shapes of chip_smoke.py and at three more spp, on
one GPU.

    python3 scripts/profile_mse_loss.py [--root DIR] [--label NAME]

``--root`` names the checkout whose package (``DIR/raytracingrust_tpu_torch``)
is imported and built, into ``DIR/build/kernels``; by default this one.
To compare two versions on one card, unpack the other into a git-ignored
directory and run the script in turns (old, new, new, old) in one call.

At each shape #4's four variants take on the main path, the scene JSONs
written as chip_smoke.py writes them (into this checkout's build/smoke):
benchmark.json 512x512 spp 8 depth 6 (spheres), material_zoo.json
600x400 spp 16 depth 8 (kExt), tri_brute 512x512 spp 8 depth 6 (kTri) and
tri_zoo 600x400 spp 16 depth 8 (kExt + kTri); then the kernel's
instance for more than 32 samples a pixel: benchmark.json 512x512 at spp
64 (cornell_spheres.json's own spp) and at spp 130 (more samples than a
block has threads), the zoo 600x400 spp 48 (two pixels a block, a
quarter of its lanes idle).  Each against a numpy-seeded target: the kernel's time (CUDA events, the mean of REPS launches after a
warm-up), its loss, and the compiler's registers, stack and spills of
each variant.  Prints one line per shape and, last, one JSON object with
every number and the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS = 10


def ptxas_rows(log: str) -> list:
    """Registers, stack and spills of each ``mse_kernel`` instance in a
    compiler report, as ``mse_kernel<kExt,kTri,kWarp>: ...``."""
    rows, fn, stack = [], None, ""
    for ln in log.splitlines():
        if "Function properties" in ln:
            m = re.search(r"Function properties for (\S*mse_kernel\S*)", ln)
            fn = m.group(1) if m else None
        elif fn and "stack frame" in ln:
            stack = ln.strip()
        elif fn and "registers" in ln:
            bits = ",".join(re.findall(r"b([01])E", fn))
            rows.append(f"mse_kernel<{bits}>: "
                        f"{ln.split(':', 1)[1].strip()}; {stack}")
            fn = None
    return rows


def shapes(C) -> tuple:
    """(label, scene JSON, width, height, spp, depth) of #4's four fit
    shapes and the three above 32 spp, the triangle scenes written by
    chip_smoke.py (module ``C``)."""
    os.makedirs(C.OUT_DIR, exist_ok=True)
    tri = {label: path for label, path, *_ in C.tri_scenes()}
    return (("benchmark", C.BENCH, 512, 512, 8, 6),
            ("zoo", C.ZOO, 600, 400, 16, 8),
            ("tri_brute", tri["tri_brute"], 512, 512, 8, 6),
            ("tri_zoo", tri["tri_zoo"], 600, 400, 16, 8),
            ("benchmark_spp64", C.BENCH, 512, 512, 64, 6),
            ("benchmark_spp130", C.BENCH, 512, 512, 130, 6),
            ("zoo_spp48", C.ZOO, 600, 400, 48, 8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_mse_loss: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.utils import rng

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(args.root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {args.root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    _build.load("mse_loss")
    regs = ptxas_rows(_build.library_path(name="mse_loss").with_suffix(
        ".log").read_text())
    key = rng.base_key(0)
    out = {"root": args.label, "card": card, "ptxas": regs, "ms": {}}
    for label, path, w, h, spp, depth in shapes(C):
        scene = C._load(path, spp=spp, depth=depth)
        fp, kinds, opts, _ = C._brute_inputs(scene, w, h, dev)
        target = torch.tensor(np.random.default_rng(0).random((w * h, 3)),
                              dtype=torch.float32, device=dev)
        clamp = scene.settings.clamp_indirect

        def run():
            return MS.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                    clamp=clamp, **opts)

        loss = run()[0].item()
        ms = C._cuda_time_ms(run, REPS)
        out["ms"][label] = ms
        print(f"{args.label} #4 {label} {w}x{h} spp {spp} depth {depth}: "
              f"{ms:.4f} ms (mean of {REPS}), loss {loss:.7e}; {card}")
    print(" | ".join(regs))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
