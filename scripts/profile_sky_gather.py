#!/usr/bin/env python3
"""The sky map's texel gather under autograd, on one GPU: ``image[y, x]``,
the form ``models/backgrounds.Background.sample`` takes (its backward,
``index_put_`` with accumulation, sorts the indices), against
``index_select`` of the flat (H * W, 3) texels (whose backward is
``index_add_``, atomics).

    python3 scripts/profile_sky_gather.py [--out FILE.json]

Under chip_smoke.py's procedural 1024x2048 sky, for each form in the order
A (``image[y, x]``), B (``index_select``), B, A:

- the gather alone: forward and backward of 8M lookups along seeded
  directions, timed with CUDA events (mean of 5 after a warm-up);
- the warm fit step (albedo, emission; median of 4) of bvh_stress at
  1000x1000 spp 8 depth 4 under the sky, with importance sampling (the env
  path: the replay's MIS estimator and #8) and without (the record walk
  and the replay with the sky at weight 1), on the host clock between
  step callbacks (each after a device sync).

Prints one line per measurement and, last, one JSON object with every
number and the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_DIRS = 8_000_000
SIZE = 1000


def _gather_ms(sky, reps: int = 5) -> float:
    import torch

    gen = torch.Generator(sky.image.device).manual_seed(0)
    d = torch.randn((N_DIRS, 3), device=sky.image.device, generator=gen)
    ct = torch.randn((N_DIRS, 3), device=sky.image.device, generator=gen)
    img = sky.image.detach().requires_grad_(True)
    sky = dataclasses.replace(sky, image=img)

    def step():
        torch.autograd.grad(sky.sample(d), img, ct)

    step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fit_step_ms(scene, target, dev) -> float:
    from raytracingrust_tpu_torch.diff.inverse import fit

    ticks = []
    fit(scene, target, ["albedo", "emission"], SIZE, SIZE, steps=5,
        device=dev, callback=lambda *_: ticks.append(time.perf_counter()))
    return statistics.median(b - a for a, b in zip(ticks, ticks[1:])) * 1e3


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_sky_gather: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as CS
    from raytracingrust_tpu_torch.models import backgrounds as B
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.render.render import render_linear
    from raytracingrust_tpu_torch.utils import vec

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    CS.procedural_sky(CS.SKY)
    scenes = {}
    for label, env_is in (("env", True), ("naive", False)):
        path = CS._write_scene(CS.STRESS, f"gather_{label}.json", sky=True,
                               env_importance_sampling=env_is)
        dim = CS._write_scene(path, f"gather_{label}_dim.json", dim=True)
        scene = SceneBuilder.from_file(path).build()
        with torch.no_grad():
            target = render_linear(SceneBuilder.from_file(dim).build(), SIZE,
                                   SIZE, seed=1, device=dev)
        scenes[label] = (scene, target)
    sky = scenes["env"][0].to(dev).background

    indexed = B.Background.sample

    def flat(self, directions):
        if self.kind != B.SKYMAP:
            return indexed(self, directions)
        y, x = self._texel(vec.to_spherical_coords(vec.normalize(directions)))
        w = self.image.shape[1]
        return self.image.reshape(-1, 3).index_select(
            0, (y * w + x).reshape(-1)).reshape(y.shape + (3,))

    forms = {"image[y, x]": indexed, "index_select": flat}
    out = {"card": card, "runs": []}
    for name in ("image[y, x]", "index_select", "index_select",
                 "image[y, x]"):
        B.Background.sample = forms[name]
        run = {"form": name, "gather_ms": _gather_ms(sky)}
        for label, (scene, target) in scenes.items():
            run[f"fit_step_{label}_ms"] = _fit_step_ms(scene, target, dev)
        out["runs"].append(run)
        print(f"{name}: gather of {N_DIRS} texels fwd+bwd "
              f"{run['gather_ms']:.3f} ms; warm fit step at bvh_stress "
              f"{SIZE}x{SIZE} spp 8 d4 under the sky: env-IS "
              f"{run['fit_step_env_ms']:.1f} ms, without "
              f"{run['fit_step_naive_ms']:.1f} ms; {card}")
    B.Background.sample = indexed
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
