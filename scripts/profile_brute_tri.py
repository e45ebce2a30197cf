#!/usr/bin/env python3
"""The brute kernels' triangle variants (kTri: #1 csrc/megakernel.cu, #3
csrc/radiance_grad.cu, #4 csrc/mse_loss.cu, whose triangle loop is
csrc/radiance.cuh trace's) of checkouts of the port, timed at the shapes of
their main path, on one GPU.

    python3 scripts/profile_brute_tri.py --parent DIR [--rounds N]
    python3 scripts/profile_brute_tri.py --root DIR [--label NAME]

With ``--parent``, DIR a checkout of another commit (a ``git archive``
unpacked under build/), the script runs itself once a checkout, in turns:
the parent and this checkout as parent, change, change, parent (N rounds
of that), then variants of this checkout built from copies of its package
under build/variants/, each once: clusters of 16 and of 64 rows
(radiance.cuh kTriCluster and megakernel.TRI_CLUSTER edited in the copy),
the cluster loop with a warp vote (the warp walks the union of its lanes'
rows in index order, each lane testing its own, in place of each lane
walking its own rows), without the half-precision row
filter (every row of a cluster whose box says skip takes tri_hit's
determinant), and with the pad BOX_PAD of the extent alone.  The tree has
no switch for any of them.  Last it prints one JSON object with every
run's times.

With ``--root`` it times one checkout (its package imported and built
into DIR/build/kernels): #1 tri (tri_brute 1000x1000 spp 8 depth 6), ext+tri
(tri_zoo 1200x800 spp 32 depth 8), ext+sky+tri (tri_zoo_sky 600x400 spp
16 depth 8); #3 tri (tri_brute 512x512 spp 8, an L1 loss's cotangents),
ext+sky+tri (tri_zoo_sky); #4 tri (tri_brute 512x512 spp 8), ext+tri
(tri_zoo 600x400 spp 16); and, to show that the variants without
triangles kept their time, #1 base (benchmark.json 512x512 spp 8 depth 6)
and ext (material_zoo 1200x800 spp 32 depth 8), #3 ext and #4 ext (the
zoo at 600x400 spp 16).  The scenes are written as chip_smoke.py writes
them, into this checkout's build/smoke.  Each shape: the kernel's time
(CUDA events, the mean of REPS launches after a warm-up) and a checksum
of its output; then the compiler's registers, stack and spills of every
instance of the three kernels, and one JSON line.  Needs one CUDA device.
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
# variant name -> {file in the package: [(text, replacement)]}
VARIANTS = {
    "c16": {"csrc/radiance.cuh": [("constexpr int kTriCluster = 32;",
                                   "constexpr int kTriCluster = 16;")],
            "ops/megakernel.py": [("TRI_CLUSTER = 32", "TRI_CLUSTER = 16")]},
    "c64": {"csrc/radiance.cuh": [("constexpr int kTriCluster = 32;",
                                   "constexpr int kTriCluster = 64;"),
                                  ("typedef uint32_t RowMask;",
                                   "typedef unsigned long long RowMask;"),
                                  ("return __ffs(m);", "return __ffsll(m);")],
            "ops/megakernel.py": [("TRI_CLUSTER = 32", "TRI_CLUSTER = 64")]},
    "vote": {"csrc/radiance.cuh": [
        ("for (RowMask m = cluster_rows(bx, tr, thr, rows.n_tri - j0); m;\n"
         "             m &= m - 1u) {\n"
         "          const int j = j0 + row_ffs(m) - 1;\n",
         "const RowMask mine = cluster_rows(bx, tr, thr, rows.n_tri - j0);\n"
         "for (RowMask m = __reduce_or_sync(__activemask(), mine); m;\n"
         "     m &= m - 1u) {\n"
         "  const int j = j0 + row_ffs(m) - 1;\n"
         "  if (!((mine >> (j - j0)) & 1u)) continue;\n")]},
    "no_half": {"csrc/radiance.cuh": [
        ("if (!(thr < INFINITY && scale >= 0x1p-126f && scale <= 0x1p126f))",
         "if (scale == scale)")]},
    "pad6": {"ops/megakernel.py": [("BOX_PAD_FLAT = 2.0 ** -7",
                                    "BOX_PAD_FLAT = 0.0")]},
}


def shapes(C) -> tuple:
    """(label, kernel, scene JSON, width, height, spp, depth) of each
    shape, the triangle scenes written by chip_smoke.py (module ``C``)."""
    os.makedirs(C.OUT_DIR, exist_ok=True)
    if not os.path.exists(C.SKY):
        C.procedural_sky(C.SKY)
    tri = {label: path for label, path, *_ in C.tri_scenes()}
    zw, zh = C.ZOO_RENDER
    fw, fh, f_spp = C.ZOO_FIT
    bw, bh, b_spp, b_depth = C.TRI_RENDER
    tw, th, t_spp = C.TRI_FIT
    return (("#1 tri", 1, tri["tri_brute"], bw, bh, b_spp, b_depth),
            ("#1 ext+tri", 1, tri["tri_zoo"], zw, zh, 32, 8),
            ("#1 ext+sky+tri", 1, tri["tri_zoo_sky"], fw, fh, f_spp, 8),
            ("#3 tri", 3, tri["tri_brute"], tw, th, t_spp, 6),
            ("#3 ext+sky+tri", 3, tri["tri_zoo_sky"], fw, fh, f_spp, 8),
            ("#4 tri", 4, tri["tri_brute"], tw, th, t_spp, 6),
            ("#4 ext+tri", 4, tri["tri_zoo"], fw, fh, f_spp, 8),
            ("#1 base", 1, C.BENCH, 512, 512, 8, 6),
            ("#1 ext", 1, C.ZOO, zw, zh, 32, 8),
            ("#3 ext", 3, C.ZOO, fw, fh, f_spp, 8),
            ("#4 ext", 4, C.ZOO, fw, fh, f_spp, 8))


def time_root(root: str, label: str) -> int:
    """Time one checkout's kernels at every shape; print a JSON line."""
    os.chdir(HERE)  # the scenes are written and read relative to it
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_brute_tri: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    import raytracingrust_tpu_torch
    from raytracingrust_tpu_torch.ops import _build
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.ops import mse_loss as MS
    from raytracingrust_tpu_torch.ops import radiance_grad as RG
    from raytracingrust_tpu_torch.utils import rng

    pkg = Path(raytracingrust_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda")
    for name in ("megakernel", "radiance_grad", "mse_loss"):
        _build.load(name)
    key = rng.base_key(0)
    out = {"root": label, "card": card, "ms": {}, "checksum": {}}
    for name, kernel, path, w, h, spp, depth in shapes(C):
        scene = C._load(path, spp=spp, depth=depth)
        fp, kinds, opts, sky = C._brute_inputs(scene, w, h, dev)
        gen = np.random.default_rng(0)
        if kernel == 1:
            def run():
                return K.radiance_cuda(fp, kinds, key, w * h * spp, spp, w,
                                       sky=sky, **opts)
        elif kernel == 3:
            sign = np.sign(gen.standard_normal((w * h, 1, 3)))
            cts = torch.tensor(np.broadcast_to(
                sign / (3 * w * h * spp), (w * h, spp, 3)).reshape(-1, 3),
                dtype=torch.float32, device=dev)

            def run():
                g = RG.radiance_grad_cuda(fp, kinds, key, cts, spp, w,
                                          sky=sky, **opts)
                return g if sky is None else g[0]
        else:
            target = torch.tensor(gen.random((w * h, 3)),
                                  dtype=torch.float32, device=dev)

            def run():
                return MS.mse_loss_cuda(
                    fp, kinds, key, target, spp, w,
                    clamp=scene.settings.clamp_indirect, **opts)[1]

        checksum = run().double().abs().sum().item()
        ms = C._cuda_time_ms(run, REPS)
        out["ms"][name] = ms
        out["checksum"][name] = checksum
        print(f"{label} {name} {w}x{h} spp {spp} depth {depth}: {ms:.4f} ms "
              f"(mean of {REPS}), checksum {checksum:.9e}; {card}",
              flush=True)
    out["ptxas"] = C._ptxas_variants()
    print(out["ptxas"])
    print(json.dumps(out), flush=True)
    return 0


def variant_root(name: str) -> Path:
    """A copy of this checkout's package (and chip_smoke.py) with the
    variant's edits, under build/variants/<name>."""
    root = HERE / "build" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "raytracingrust_tpu_torch",
                    root / "raytracingrust_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "chip_smoke.py", root / "chip_smoke.py")
    for rel, edits in VARIANTS[name].items():
        p = root / "raytracingrust_tpu_torch" / rel
        text = p.read_text()
        for old, new in edits:
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
    runs = []
    for _ in range(args.rounds):
        for root, label in ((args.parent, "P"), (HERE, "C"), (HERE, "C"),
                            (args.parent, "P")):
            runs.append(run_child(Path(root), label))
    for name in VARIANTS:
        runs.append(run_child(variant_root(name), name))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
