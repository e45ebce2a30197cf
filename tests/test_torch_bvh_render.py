"""The port's BVH render path (kernel #5's plain version, the dispatch and
the CLI) against the JAX package: bitwise at depth 1 against its XLA engine
and its packet-traversal kernel (interpret mode), within the JAX tests' own
bounds deeper.

On the CPU the port runs the kernel's plain version; the CUDA kernel is
held to that plain version on the card by tests/test_torch_gpu.py.
"""

import collections
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu import cli as j_cli
from raytracingrust_tpu.io.png import read_png
from raytracingrust_tpu.render.render import render_linear as j_render_linear
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models import backgrounds as TBg
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    resolve_engine,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import rng
from test_torch_bvh_build import STRESS, grid_builder, mesh_builder
from test_torch_scene import assert_takes_xla


def both(make, **kw):
    """(JAX scene, port scene) of one builder function, with their BVH."""
    return tuple(make(m, **kw).build(with_bvh=True) for m in (J, T))


def stress(spp=None, depth=None):
    out = []
    for mod in (J, T):
        b = mod.SceneBuilder.from_file(STRESS)
        b.settings = dataclasses.replace(
            b.settings, samples_per_pixel=spp or b.settings.samples_per_pixel,
            max_ray_depth=depth or b.settings.max_ray_depth)
        out.append(b.build(with_bvh=True))
    return out


def port_image(scene, w, h, seed=0):
    assert select_engine(scene) == "bvh"
    return render_linear(scene, w, h, seed=seed, device="cpu").numpy()


@pytest.mark.parametrize("name,w,h", [("grid7", 24, 24), ("sheet10", 20, 20)])
def test_depth1_bitwise_vs_jax(name, w, h):
    """Primary visibility shares every operation with both JAX engines
    (jitter, camera basis, the direct quadratic and Moller-Trumbore,
    background), so the images are equal bit for bit: any difference would
    be a traversal fault, as test_bvh_kernel_depth1_exact_vs_xla holds it
    on the JAX side."""
    if name == "grid7":
        j, t = both(grid_builder, n=7, depth=1, spp=2)
    else:
        j, t = both(mesh_builder, n_side=10, depth=1, spp=2)
    got = port_image(t, w, h)
    assert (got > 0).any()
    for engine in ("xla", "pallas_bvh"):
        want = np.asarray(j_render_linear(j, w, h, seed=0, engine=engine))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=engine)


def assert_within_jax_bounds(want, got, frac=0.06, mean_tol=4e-2):
    """tests/test_pallas_bvh.py::assert_matches_xla's bounds: at most
    ``frac`` of the channels outside atol 1e-4 + rtol 1e-3, and a mean abs
    diff under ``mean_tol``.  The spread comes from transcendental ulps
    (sin/cos, and the gradient background's rsqrt) between PyTorch and
    XLA, which flip discrete path decisions now and then."""
    mismatched = (~np.isclose(want, got, atol=1e-4, rtol=1e-3)).mean()
    assert mismatched <= frac, f"{mismatched:.4f} channels differ"
    assert np.abs(want - got).mean() < mean_tol


def test_stress_scene_full_depth_within_jax_bounds():
    """scenes/bvh_stress.json at its own spp 8 and depth 4 (gradient
    background), against the JAX packet-traversal kernel.  The flipped
    fraction is held to 0.08, the bound of the port's brute path against
    JAX's brute kernel (test_torch_megakernel.py), not JAX's engine-to-
    engine 0.06: measured 0.077 here (seed 0; seed 1 0.087), with a mean
    abs diff of 0.0074 against a seed-to-seed noise of 0.040.  The spread
    is the lobes' transcendentals (XLA's rsqrt is one ulp off the rounded
    1/sqrt on 14% of inputs, its sin/cos differ from PyTorch's on 5%), which
    the brute path shares: on a grid both paths take, the port's brute and
    BVH paths differ from JAX's by the same 17-19% of channels at spp 8
    depth 4, and from each other on a handful of rays
    (test_bvh_plain_vs_brute_plain)."""
    j, t = stress()
    want = np.asarray(j_render_linear(j, 16, 16, seed=0,
                                      engine="pallas_bvh"))
    assert_within_jax_bounds(want, port_image(t, 16, 16), frac=0.08)


def test_sheet_full_depth_within_jax_bounds():
    j, t = both(mesh_builder, n_side=10, depth=3)
    want = np.asarray(j_render_linear(j, 20, 20, seed=0,
                                      engine="pallas_bvh"))
    assert_within_jax_bounds(want, port_image(t, 20, 20))


def test_clay_mode_vs_jax():
    """Clay on the 216-sphere grid at depth 1 is bitwise (a hit is black,
    a miss the background); on the sheet at depth 3 within JAX's bounds
    (a uniform background makes the radiance 0.8^bounces times it, so only
    a flipped path could move it)."""
    j, t = both(grid_builder, n=6, depth=1, spp=2, mode="Clay")
    want = np.asarray(j_render_linear(j, 16, 16, seed=0, engine="pallas_bvh"))
    np.testing.assert_array_equal(port_image(t, 16, 16), want)
    def clay_sheet(mod):
        b = mesh_builder(mod, n_side=10, depth=3, spp=2)
        b.settings = dataclasses.replace(b.settings, mode="Clay")
        return b

    j, t = both(clay_sheet)
    want = np.asarray(j_render_linear(j, 20, 20, seed=0, engine="pallas_bvh"))
    assert_within_jax_bounds(want, port_image(t, 20, 20))


def test_gradient_background_depth1_within_four_ulp():
    """The gradient background normalizes with rsqrt in the JAX kernel and
    1/sqrt here (PyTorch's CPU sqrt is itself not correctly rounded on
    0.7% of inputs), one ulp or two a sample; a pixel's mean of two samples
    adds them: at most four ulp apart."""
    j, t = stress(spp=2, depth=1)
    want = np.asarray(j_render_linear(j, 12, 12, seed=3,
                                      engine="pallas_bvh"))
    np.testing.assert_array_max_ulp(port_image(t, 12, 12, seed=3), want,
                                    maxulp=4)


@pytest.mark.parametrize("mode", ["Full", "Clay"])
def test_bvh_plain_vs_brute_plain(mode):
    """On a scene both kernels take, the BVH path finds the brute path's
    winners: the brute root multiplies by 1/a and its normal by 1/r, the
    BVH path divides, so a borderline root may flip a few pixels; every
    other pixel is equal bit for bit (test_bvh_kernel_bitwise_vs_brute_
    kernel_spheres on the JAX side)."""
    scene = grid_builder(T, n=4, depth=6, spp=2, spacing=1.4, radius=0.5,
                         mode=mode).build(with_bvh=True)
    assert select_engine(scene) == "brute"
    brute = render_linear(scene, 16, 16, seed=0, device="cpu").numpy()
    sc = BK.pack(scene, 16, 16, "cpu")
    rad = BK.radiance(sc, rng.base_key(0), 256, 2, 16, max_depth=6,
                      bg_kind=0, clay=mode == "Clay")
    bvh = rad.clamp(0, 10).view(16, 16, 2, 3).mean(dim=2).numpy()
    neq = (brute != bvh).any(-1)
    assert neq.sum() <= 3, f"{neq.sum()} pixels differ"
    np.testing.assert_array_equal(brute[~neq], bvh[~neq])


def _per_ray(scene, w, h, seed, **kw):
    s = scene.settings
    ids, px, py = TK.prep_rays(torch.arange(w * h), s.samples_per_pixel, w)
    return BK.radiance_bvh_plain(
        BK.pack(scene, w, h, "cpu"), rng.base_key(seed), ids, px, py,
        max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
        clay=False, **kw)


def test_tiles_equal_one_pass(monkeypatch):
    _, t = both(mesh_builder, n_side=10, depth=3, spp=2)
    whole = _per_ray(t, 8, 6, 4)
    monkeypatch.setattr(BK, "TILE_RAYS", 7)
    np.testing.assert_array_equal(_per_ray(t, 8, 6, 4), whole)


def test_tally_counts_the_work_and_changes_nothing():
    """``radiance_bvh_plain(tally=...)`` (chip_smoke.py's count of the work
    the rays did) leaves the radiance as it was."""
    _, t = both(mesh_builder, n_side=10, depth=3, spp=2)
    tally = collections.Counter()
    got = _per_ray(t, 8, 6, 4, tally=tally)
    np.testing.assert_array_equal(got, _per_ray(t, 8, 6, 4))
    assert tally["bounces"] >= 8 * 6 * 2  # every ray enters bounce 0
    assert tally["nodes"] >= tally["bounces"]  # each walk visits the root
    assert tally["triangle_tests"] > 0 and tally["sphere_tests"] > 0
    hits = sum(tally[f"hits_{k}"] for k in range(4))
    assert hits + tally["misses"] == tally["bounces"]


def test_cpu_dispatch_and_cuda_wrapper_checks():
    _, t = both(mesh_builder, n_side=10, depth=3, spp=2)
    sc = BK.pack(t, 8, 6, "cpu")
    got = BK.radiance(sc, rng.base_key(4), 48, 2, 8, max_depth=3,
                      bg_kind=0, clay=False)
    np.testing.assert_array_equal(got.numpy(), _per_ray(t, 8, 6, 4))
    with pytest.raises(ValueError, match="CUDA"):
        BK.radiance_bvh_cuda(sc, (0, 0), 96, 2, 8, max_depth=3, bg_kind=0,
                             clay=False)


def _refusal(make):
    """The kernels' reasons for refusing the scene ``make()`` builds, which
    takes the generic engine ("xla") instead, an 8x6 frame of it finite."""
    scene = make()
    assert_takes_xla(scene)
    return " ".join(why for why in (TK.unsupported(scene),
                                    BK.unsupported_bvh(scene)) if why)


def test_select_engine_and_refusals(tmp_path):
    """1 to 128 spheres without triangles take the brute kernel at any
    depth, single-level mixes, isotropic materials and sphere volumes
    included (as in the JAX package); so does a scene with triangles built
    without its BVH, a triangle-only one too; other scenes the BVH gate
    admits take #5, mixes, isotropic materials and sphere volumes
    included; the rest take the generic engine ("xla"), the kernels' gates
    naming why (129 spheres without the BVH, the JAX package's limits of 8
    volumes and mixes nested 4 deep, a mesh volume without the BVH).
    ``engine="xla"`` forces the generic engine on a scene a kernel takes;
    an unknown engine raises ValueError."""
    small = grid_builder(T, n=3, depth=40)
    assert select_engine(small.build()) == "brute"  # a deep sphere chain
    assert select_engine(grid_builder(T, n=6).build()) == "bvh"
    assert select_engine(mesh_builder(T).build()) == "bvh"
    assert select_engine(mesh_builder(T).build(with_bvh=False)) == "brute"
    row = T.SceneBuilder()
    lam = row.add_material(T.Lambertian((0.5, 0.5, 0.5)))
    for i in range(129):
        row.add_sphere((0.1 * i, 0, -3), 0.04, lam)
    for many in (lambda: grid_builder(T, n=6).build(with_bvh=False),
                 lambda: row.build(with_bvh=False)):
        why = _refusal(many)
        assert '"xla"' in why and "with_bvh=True" in why
    assert select_engine(row.build(with_bvh=True)) == "bvh"
    tri = T.SceneBuilder()
    tri.add_mesh(T.models.mesh.Mesh.from_buffers(
        np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32),
        np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32),
        tri.add_material(T.Lambertian((0.5, 0.5, 0.5)))))
    for grad in (False, True):
        assert select_engine(tri.build(with_bvh=False), grad=grad) == "brute"

    def with_material(m, n=6):
        b = grid_builder(T, n=n)
        b.add_sphere((0, 9, 0), 1.0, b.add_material(m))
        return b.build()

    mix = T.MixMaterial(T.Lambertian((1, 0, 0)), T.Metal((1, 1, 1), 0.0),
                        0.5)
    assert select_engine(with_material(mix)) == "bvh"
    assert select_engine(with_material(T.Isotropic((1, 1, 1)))) == "bvh"
    # a scene of the brute kernel's size takes the brute kernels, with or
    # without its BVH (as in the JAX package)
    assert select_engine(with_material(mix, n=2)) == "brute"
    b = grid_builder(T, n=2)
    b.add_sphere((0, 9, 0), 1.0, b.add_material(mix))
    assert select_engine(b.build(with_bvh=False)) == "brute"

    def with_volumes(n_vol):
        d = grid_builder(T, n=6).to_json()
        for i in range(n_vol):
            d["objects"].append({"type": "Volume", "neg_inv_density": -2.0,
                                 "boundary": d["objects"][i]})
        return T.SceneBuilder.from_json(d).build()

    assert select_engine(with_volumes(1)) == "bvh"
    assert select_engine(with_volumes(8)) == "bvh"
    # the JAX package's limits: 8 volumes, mixes nested 4 deep
    assert "at most 8" in _refusal(lambda: with_volumes(9))
    deep = T.Lambertian((1, 0, 0))
    for _ in range(4):
        deep = T.MixMaterial(deep, T.Metal((1, 1, 1), 0.0), 0.5)
    assert select_engine(with_material(deep)) == "bvh"
    deeper = T.MixMaterial(deep, T.Metal((1, 1, 1), 0.0), 0.5)
    assert "deeper than 4" in _refusal(lambda: with_material(deeper))
    # a sky map without importance sampling and the views take #5
    skymap = grid_builder(T, n=6).build()
    skymap.background = TBg.Background.skymap_from_array(
        np.ones((4, 8, 3), np.float32))
    assert select_engine(skymap) == "bvh"
    assert select_engine(grid_builder(T, n=6, mode="Normal").build()) == "bvh"
    # a mesh-bounded volume loads and takes #5's crossing scan; without
    # its BVH the generic engine
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    d = mesh_builder(T).to_json()
    d["objects"][0] = {"type": "Volume", "neg_inv_density": -1.0,
                       "boundary": {"type": "Mesh", "path": str(obj),
                                    "material": 0}}
    b = T.SceneBuilder.from_json(d)
    assert select_engine(b.build(with_bvh=True)) == "bvh"
    assert "without its BVH" in _refusal(lambda: b.build(with_bvh=False))
    # engine="xla" forces the generic engine; an unknown engine raises
    assert select_engine(small.build()) == "brute"
    assert resolve_engine(small.build(), "xla") == "xla"
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine(small.build(), "pallas_bvh")


def test_bvh_path_refuses_gradients():
    """The BVH path refuses no gradient: a leaf that requires
    grad gets a finite, nonzero gradient through render_linear and
    make_loss (the record walk, then the replay); with no gradient asked
    for it renders forward only, with no record."""
    _, t = both(mesh_builder, n_side=10, depth=2)
    t.materials.albedo.requires_grad_(True)
    img = render_linear(t, 8, 6, device="cpu")
    (g,) = torch.autograd.grad(img.sum(), t.materials.albedo)
    assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0
    with torch.no_grad():  # no gradient asked for: renders
        assert render_linear(t, 8, 6, device="cpu").shape == (6, 8, 3)
    target = np.zeros((6, 8, 3), np.float32)
    params = {"albedo": t.materials.albedo.detach().clone()
              .requires_grad_(True)}
    loss = TG.make_loss(t, target, 8, 6, device="cpu")(params)
    (g,) = torch.autograd.grad(loss, params["albedo"])
    assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0


def test_cli_render_and_info_stress(tmp_path, capsys):
    out = str(tmp_path / "stress.png")
    assert cli.main(["render", STRESS, "--width", "24", "--height", "24",
                     "--device", "cpu", "-o", out]) == 0
    assert "Last render took" in capsys.readouterr().out
    img = read_png(out)  # the JAX package's reader
    assert img.shape == (24, 24, 4) and img[..., :3].std() > 0

    class Args:
        scene = STRESS
        spp = depth = clamp = mode = None
        bvh = no_bvh = False

    assert j_cli.cmd_info(Args()) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["info", STRESS]) == 0
    got = json.loads(capsys.readouterr().out)
    for k in ("objects", "spheres", "volumes", "triangles", "materials",
              "settings"):
        assert got[k] == want[k], k
    assert (got["bvh_spheres_nodes"], got["bvh_spheres_chunks"]) == (31, 16)
    assert (got["bvh_triangles_nodes"], got["bvh_triangles_chunks"]) == (0, 0)
