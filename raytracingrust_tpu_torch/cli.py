"""Command-line interface of the port: ``render`` and ``info``.

    rtrt-torch render scenes/benchmark.json -o out.png --width 512 --height 512
    rtrt-torch render scene.json --spp 64 --depth 8 --mode Clay --device cpu
    rtrt-torch info scene.json

``--device cuda`` (the default) renders with the CUDA kernel and fails when
no GPU is present; ``--device cpu`` runs its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

_MODES = ["Full", "Clay", "Normal", "Random"]


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="scene JSON (reference-compatible schema)")
    p.add_argument("--spp", type=int, help="override samples_per_pixel")
    p.add_argument("--depth", type=int, help="override max_ray_depth")
    p.add_argument("--clamp", type=float, help="override clamp_indirect")
    p.add_argument("--mode", choices=_MODES)


def _load(args):
    from .models.scene import SceneBuilder

    builder = SceneBuilder.from_file(args.scene)
    overrides = {}
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.depth is not None:
        overrides["max_ray_depth"] = args.depth
    if args.clamp is not None:
        overrides["clamp_indirect"] = args.clamp
    if args.mode is not None:
        overrides["mode"] = args.mode
    builder.settings = dataclasses.replace(builder.settings, **overrides)
    return builder


def cmd_render(args) -> int:
    from .io.png import write_png
    from .metrics import RenderStats
    from .render.render import render

    scene = _load(args).build()
    stats = RenderStats(args.width, args.height,
                        scene.settings.samples_per_pixel,
                        scene.settings.max_ray_depth)
    t0 = time.perf_counter()
    img = render(scene, args.width, args.height, seed=args.seed,
                 device=args.device)
    elapsed = time.perf_counter() - t0
    write_png(args.output, img)
    print(f"Last render took {elapsed:.3f}s "
          f"({stats.mrays_per_s(elapsed):.2f} Mrays/s) -> {args.output}")
    return 0


def cmd_info(args) -> int:
    builder = _load(args)
    scene = builder.build()
    print(json.dumps({
        "objects": len(builder.objects),
        "spheres": len(scene.spheres),
        "volumes": scene.spheres.num_volumes,
        "triangles": 0,  # mesh objects are refused at load
        "materials": len(builder.materials),
        "settings": builder.settings.to_json(),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rtrt-torch",
        description="path tracer on PyTorch and CUDA (sphere scenes)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render a scene to PNG")
    _add_scene_args(p_render)
    p_render.add_argument("-o", "--output", default="render.png")
    p_render.add_argument("--width", type=int, default=1000)
    p_render.add_argument("--height", type=int, default=1000)
    p_render.add_argument("--seed", type=int, default=0)
    p_render.add_argument("--device", choices=["cuda", "cpu"],
                          default="cuda",
                          help="cuda: the CUDA kernel (default); cpu: its "
                               "plain PyTorch version")
    p_render.set_defaults(fn=cmd_render)

    p_info = sub.add_parser("info", help="print scene statistics")
    _add_scene_args(p_info)
    p_info.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
