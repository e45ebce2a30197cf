"""Command-line interface of the port: ``render``, ``fit`` and ``info``.

    rtrt-torch render scenes/benchmark.json -o out.png --width 512 --height 512
    rtrt-torch render scene.json --spp 64 --depth 8 --mode Clay --device cpu
    rtrt-torch render sky_scene.json            # SkyMap background
    rtrt-torch render sky_scene.json --env-is   # ... importance-sampled
    rtrt-torch render scene.json --mode Normal  # the normals view
    rtrt-torch fit scene.json target.png --params albedo,emission --steps 50
    rtrt-torch info scene.json

``--device cuda`` (the default) runs the CUDA kernels and fails when no GPU
is present; ``--device cpu`` runs their plain PyTorch versions.
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
    p.add_argument("--env-is", action="store_true",
                   help="importance-sample the HDRI environment (one-sample "
                        "MIS; only meaningful with a SkyMap background)")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernels (default); cpu: their plain "
                        "PyTorch versions")


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
    if args.env_is:
        overrides["env_importance_sampling"] = True
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


def cmd_fit(args) -> int:
    """Inverse rendering: optimize scene parameters to match a target PNG."""
    import numpy as np

    from .diff.inverse import fit
    from .io.png import read_png, write_png
    from .render.render import render

    scene = _load(args).build()
    target_u8 = read_png(args.target)[..., :3].astype(np.float32) / 255.0
    target = target_u8 ** 2  # invert the sqrt gamma -> linear radiance
    h, w = target.shape[:2]

    def log(i, value, params):
        if i % 10 == 0:
            print(f"step {i}: loss {value:.6f}")

    out_scene, params, history = fit(
        scene, target, args.params.split(","), w, h, steps=args.steps,
        learning_rate=args.lr, seed=args.seed, device=args.device,
        callback=log)
    print(f"final loss {history[-1]:.6f}")
    for name, value in params.items():
        print(f"{name}: {np.round(value.cpu().numpy(), 4).tolist()}")
    if args.output:
        write_png(args.output, render(out_scene, w, h, seed=args.seed,
                                      device=args.device))
    return 0


def _engines(scene) -> tuple[str, str]:
    """(render engine, fit engine) the scene would take, or the reason it
    is refused: ``select_engine`` without and with a gradient."""
    from .models.backgrounds import SKYMAP
    from .ops.bvh_kernel import VIEWS
    from .ops.megakernel import scene_opts
    from .ops.mse_loss import supports_fused_mse
    from .render.render import select_engine

    view = VIEWS.get(scene.settings.mode)
    sky = scene.background.kind == SKYMAP
    scan = (f" with the crossing scan of {scene.num_mesh_volumes} mesh "
            "volumes" if scene.num_mesh_volumes else "")
    opts = scene_opts(scene)
    ext = ("mixes, volumes, isotropic" if opts["mix"] or opts["n_vol"]
           or opts["iso"] else "")
    tri = "triangles" if len(scene.triangles) else ""
    brute = ", ".join(v for v in (ext, "sky map" if sky else "", tri) if v)
    brute = f" ({brute} variant)" if brute else ""
    names = {"env": ("env: record mode of #5, then the replay over #6 with "
                     "#8's shadow rays",
                     "env: the same, with #7 under the replay's backward"),
             "bvh": (f"bvh: the {view} view of kernel #5{scan}" if view
                     else f"bvh: kernel #5, its sky-map variant{scan}" if sky
                     else f"bvh: kernel #5{scan}",
                     "bvh: record mode of #5 under a black background, then "
                     "the replay with the sky over #6 and #7" if sky else
                     "bvh: record mode of #5, then the replay over #6 and "
                     "#7"),
             "brute": ("brute: kernel #1" + brute,
                       "fused: kernel #4" + brute if supports_fused_mse(scene)
                       else "brute: #1 forward, #3 backward" + brute)}
    out = []
    for i, grad in enumerate((False, True)):
        try:
            out.append(names[select_engine(scene, grad=grad)][i])
        except (NotImplementedError, ValueError) as e:
            out.append(f"unsupported: {e}")
    return out[0], out[1]


def cmd_info(args) -> int:
    builder = _load(args)
    scene = builder.build()
    render_engine, fit_engine = _engines(scene)
    trees = {}  # the chunk-leaf BVH's size, where it was built
    for kind in ("spheres", "volumes", "triangles"):
        tree = getattr(scene.cbvh, kind, None)
        trees[f"bvh_{kind}_nodes"] = tree.n_nodes if tree else 0
        trees[f"bvh_{kind}_chunks"] = tree.n_chunks if tree else 0
    boundary = int((scene.triangles.volume >= 0).sum())
    print(json.dumps({
        "objects": len(builder.objects),
        "spheres": len(scene.spheres),
        "volumes": scene.spheres.num_volumes,
        "triangles": len(scene.triangles),
        "mesh_volumes": scene.num_mesh_volumes,
        "mesh_volume_triangles": boundary,
        "materials": len(builder.materials),
        **trees,
        "render_engine": render_engine,
        "fit_engine": fit_engine,
        "settings": builder.settings.to_json(),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rtrt-torch",
        description="path tracer on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render a scene to PNG")
    _add_scene_args(p_render)
    p_render.add_argument("-o", "--output", default="render.png")
    p_render.add_argument("--width", type=int, default=1000)
    p_render.add_argument("--height", type=int, default=1000)
    p_render.add_argument("--seed", type=int, default=0)
    _add_device_arg(p_render)
    p_render.set_defaults(fn=cmd_render)

    p_fit = sub.add_parser("fit",
                           help="inverse rendering against a target PNG")
    _add_scene_args(p_fit)
    p_fit.add_argument("target", help="target PNG (as written by `render`)")
    p_fit.add_argument("--params", default="albedo",
                       help="comma list: albedo,fuzz,ir,emission,"
                            "bg_color_a,cam_lookfrom,cam_fov,...")
    p_fit.add_argument("--steps", type=int, default=100)
    p_fit.add_argument("--lr", type=float, default=5e-2)
    p_fit.add_argument("-o", "--output", help="render the fitted scene here")
    p_fit.add_argument("--seed", type=int, default=0)
    _add_device_arg(p_fit)
    p_fit.set_defaults(fn=cmd_fit)

    p_info = sub.add_parser("info", help="print scene statistics")
    _add_scene_args(p_info)
    p_info.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
