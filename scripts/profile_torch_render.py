#!/usr/bin/env python3
"""Where a warm render of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/profile_torch_render.py [--out FILE.json]

For each of the two shapes chip_smoke.py drives (scenes/benchmark.json at
512x512 spp 8 depth 6, scenes/cornell_spheres.json at 1000x1000 spp 64
depth 8) it measures:

- the radiance kernel alone: three windows of launches timed with CUDA
  events;
- a warm ``render_linear`` on the host clock (ended by a synchronize):
  median and best of 10;
- one warm ``render_linear`` under ``torch.profiler``: device time per
  kernel and copy, and the device's busy share of the call (the sum of
  device times over the wall time, with and without the profiler);
- the same kernel built with ``--fmad=true`` (contracted multiply-adds):
  its windows, and the share of per-ray values that differ from the strict
  (``--fmad=false``) build.

Prints one line per measurement and, last, one JSON object with every
number; ``--out`` writes that object to a file too.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = (  # (name, scene, width, height, spp, depth, launches per window)
    ("benchmark", "scenes/benchmark.json", 512, 512, 8, 6, 20),
    ("cornell", "scenes/cornell_spheres.json", 1000, 1000, 64, 8, 5),
)


def _windows_ms(fn, launches: int, n_windows: int = 3) -> list[float]:
    import torch

    fn()  # warm
    out = []
    for _ in range(n_windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / launches)
    return out


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


@contextlib.contextmanager
def _library(lib):
    """Route the wrappers' launches through another build of the kernels."""
    from raytracingrust_tpu_torch.ops import _build

    saved = _build.load
    _build.load = lambda: lib
    try:
        yield
    finally:
        _build.load = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON summary here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_render: no CUDA device is available",
              file=sys.stderr)
        return 1
    from raytracingrust_tpu_torch.models.scene import SceneBuilder
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.render.render import render_linear
    from raytracingrust_tpu_torch.utils import rng

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    _build.load()  # the strict build, which the wrappers use
    fmad_flags = tuple("--fmad=true" if f == "--fmad=false" else f
                       for f in _build.NVCC_FLAGS)
    fmad_path = _build.library_path(fmad_flags)
    if not fmad_path.exists():
        _build.build(fmad_path, fmad_flags)
    contracted = _build.bind(fmad_path)
    summary = {"card": card, "shapes": {}}

    for name, path, w, h, spp, depth, launches in SHAPES:
        b = SceneBuilder.from_file(path)
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                         max_ray_depth=depth)
        scene = b.build()
        fp = K.pack_fparams(scene, w, h).to(dev)
        kinds = K.sphere_kinds(scene).to(dev)
        key = rng.base_key(0)

        def kernel():
            return K.radiance_cuda(
                fp, kinds, key, w * h * spp, spp, w, max_depth=depth,
                bg_kind=scene.background.kind,
                clay=scene.settings.mode == "Clay")

        def render():
            img = render_linear(scene, w, h, seed=0, device=dev)
            torch.cuda.synchronize()
            return img

        strict_ms = _windows_ms(kernel, launches)
        ref = kernel()
        with _library(contracted):
            fmad_ms = _windows_ms(kernel, launches)
            fma_out = kernel()
        torch.cuda.synchronize()
        changed = (fma_out.view(torch.int32)
                   != ref.view(torch.int32)).float().mean().item()

        render()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            render()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        device = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                us = _device_us(evt)
                if us > 0:
                    device[evt.key] = us / 1e3
        device_ms = sum(device.values())
        rec = {
            "shape": f"{path} {w}x{h} spp {spp} depth {depth}",
            "kernel_ms_windows": strict_ms,
            "kernel_fmad_ms_windows": fmad_ms,
            "fmad_changed_share": changed,
            "render_wall_ms_median": wall_ms,
            "render_wall_ms_best": min(walls),
            "profiled_wall_ms": prof_wall_ms,
            "device_ms": device,
            "busy_share_profiled": device_ms / prof_wall_ms,
            "busy_share": device_ms / wall_ms,
        }
        summary["shapes"][name] = rec
        print(f"{name}: kernel windows {strict_ms} ms; --fmad=true "
              f"{fmad_ms} ms, {changed:.4%} of per-ray values change")
        print(f"{name}: warm render_linear median {wall_ms:.4f} ms, best "
              f"{min(walls):.4f} ms (10 runs); profiled {prof_wall_ms:.4f} "
              f"ms; device busy {device_ms / wall_ms:.3f} of the median "
              f"wall, {device_ms / prof_wall_ms:.3f} under the profiler")
        for k, v in sorted(device.items(), key=lambda kv: -kv[1]):
            print(f"{name}:   {v:9.4f} ms  {k}")

    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
