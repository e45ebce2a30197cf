#!/usr/bin/env python3
"""What the small trees' any-hit twin adds to chip_smoke.py phase 9: the
seconds of #8's plain version (ops/occlusion.occluded_plain) over the
shadow rays of one plain-route env render, without a tally and with one
(whose ``_twin_check`` walks the small trees of every leaf the dense walk
tests), twice each in turns, at sky_bvh_stress 1000x1000 spp 8 depth 4
and sky_sheet64 512x512 spp 8 depth 6 (the scenes as chip_smoke.py writes
them, under build/smoke).  Prints one line a run, with the seconds of the
plain route's render that gave the rays.  ``--root DIR`` imports the
package of another checkout (a ``git archive`` unpacked under build/):
run parent, change, change, parent to compare them.  Needs one CUDA
device; builds no kernel.

    python3 scripts/profile_occlusion_twin.py [--root DIR]
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    root = Path(ap.parse_args().root).resolve()
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("profile_occlusion_twin: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import bvh_kernel as BK
    from raytracingrust_tpu_torch.ops import occlusion as OC
    from raytracingrust_tpu_torch.utils import rng

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    dev = torch.device("cuda")
    os.makedirs(C.OUT_DIR, exist_ok=True)
    key = rng.base_key(11)
    for label, path, w, h, _ in C.env_scenes():
        scene = SceneBuilder.from_file(path).build()
        s = scene.settings
        with torch.no_grad():
            sc = BK.pack(scene, w, h, dev)
        sky = scene.to(dev).background
        t0 = time.perf_counter()
        _, rays = C._shadow_rays(sc, sky, key, w * h, s.samples_per_pixel, w,
                                 s.max_ray_depth)
        torch.cuda.synchronize()
        route_s = time.perf_counter() - t0
        for tally in (None, collections.Counter(), None,
                      collections.Counter()):
            t0 = time.perf_counter()
            for o, d, ids, stream in rays:
                OC.occluded_plain(sc, o, d, ids, key, stream, tally=tally)
            torch.cuda.synchronize()
            print(f"{root.name} {label} route {route_s:.3f} s, "
                  f"{'tally' if tally is not None else 'plain'} "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
