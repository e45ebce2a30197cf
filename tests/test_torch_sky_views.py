"""The port's last forward branches of the BVH kernel (#5) on the CPU
against the JAX package: a sky map without importance sampling (the
reference's default for an HDRI scene, and its demo-scene class: meshes
under a SkyMap), rendered and fitted, and the Normal and Random inspection
views on every background.

On the CPU the port runs the kernel's plain version (the sky lookup of
``Background.sample`` on a miss; the view's single intersection) and, for
a gradient, the record walk and the replay with the sky on a miss; the
CUDA kernel is held to that plain version on the card by
tests/test_torch_gpu.py.  The JAX references (its packet-traversal kernel
in interpret mode, whose compiles are slow) run once, in module fixtures.
Mirrors tests/test_pallas_bvh.py::test_bvh_kernel_skymap_demo_scene_class
and ::test_bvh_grad_skymap, and tests/test_debug_modes.py.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.models.mesh import Mesh as JMesh
from raytracingrust_tpu.render.render import render_linear as j_render
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.io.exr import write_exr
from raytracingrust_tpu_torch.io.png import read_png
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.render.render import (render, render_linear,
                                                    select_engine)
from test_torch_bvh_build import grid_builder, mesh_builder, sheet_buffers
from test_torch_bvh_render import assert_within_jax_bounds
from test_torch_zoo import ZOO, _ulps

W, H = 16, 12


def demo_sky():
    """test_bvh_kernel_skymap_demo_scene_class's numpy-seeded 8x16 sky,
    with a bright patch above the clamp."""
    rs = np.random.RandomState(2)
    sky = (0.1 + 0.5 * rs.rand(8, 16, 3)).astype(np.float32)
    sky[0:2, 4:6] = (6.0, 5.0, 4.0)
    return sky


def sky_builder(mod, depth=3, spp=2, mode="Full", sky=None):
    """tests/test_pallas_bvh.py::mesh_builder's sheet (72 triangles), its
    metal and emissive spheres, under the sky, importance sampling off."""
    b = mesh_builder(mod, n_side=6, depth=depth, spp=spp)
    b.background = mod.Background.skymap_from_array(
        demo_sky() if sky is None else sky)
    b.settings = dataclasses.replace(b.settings, mode=mode)
    return b


def pair(**kw):
    return tuple(sky_builder(m, **kw).build(with_bvh=True) for m in (J, T))


def _with(scene, albedo, sky, mod):
    """The scene with material 0's albedo and the sky's texels replaced."""
    a = (scene.materials.albedo.at[0].set(albedo) if mod is J else
         torch.cat([albedo[None], scene.materials.albedo[1:]]))
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, albedo=a),
        background=dataclasses.replace(scene.background, image=sky))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX packet-traversal kernel (interpret mode) at 16x12 spp 2: at
    depth 3 the image and the gradient of sum(image^2) in material 0's
    albedo and the sky's texels, in one jitted VJP; at depth 1 the
    image."""
    j, _ = pair()

    def image(albedo, sky):
        return j_render(_with(j, albedo, sky, J), W, H, seed=0,
                        engine="pallas_bvh")

    def image_and_grads(albedo, sky):
        img, vjp = jax.vjp(image, albedo, sky)
        return img, vjp(2.0 * img)

    img, (g_a, g_s) = jax.jit(image_and_grads)(j.materials.albedo[0],
                                               j.background.image)
    j1, _ = pair(depth=1)
    return {3: np.asarray(img), "albedo": np.asarray(g_a),
            "sky": np.asarray(g_s),
            1: np.asarray(j_render(j1, W, H, seed=0, engine="pallas_bvh"))}


# ------------------------------------------------------------- the render

def test_sky_render_depth1_within_ulps(jax_refs):
    """At depth 1 a miss is one texel lookup: the images agree within 4 ulp
    but where an ulp of acos/atan2 (PyTorch's CPU functions and XLA's are
    different implementations, ROADMAP C) moves a direction across a
    texel edge (measured: bit for bit on every channel; allowed 1%)."""
    _, t = pair(depth=1)
    assert select_engine(t) == "bvh"
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[1]
    far = _ulps(got, want) > 4
    print(f"depth 1: {int(far.sum())} of {far.size} channels beyond 4 ulp, "
          f"{int((got == want).sum())} equal")
    assert far.mean() <= 0.01
    assert got.max() > 0  # the sky, where the scene does not cover it


def test_sky_render_depth3_within_jax_bounds(jax_refs):
    """At depth 3 within the JAX BVH tests' engine-to-engine bounds
    (measured: 3 of 192 pixels differ)."""
    _, t = pair()
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    assert_within_jax_bounds(jax_refs[3], got)
    rgba = render(t, W, H, seed=0, device="cpu")
    assert rgba.shape == (H, W, 4) and rgba[..., :3].std() > 0


# ----------------------------------------------------------- the gradient

def _port_grads(t):
    """The port's d sum(image^2) in material 0's albedo and the sky's
    texels, and the loss as a function of both."""
    def loss(albedo, sky):
        img = render_linear(_with(t, albedo, sky, T), W, H, seed=0,
                            device="cpu")
        return (img ** 2).sum()

    albedo = t.materials.albedo[0].clone().requires_grad_(True)
    sky = t.background.image.clone().requires_grad_(True)
    g_a, g_s = torch.autograd.grad(loss(albedo, sky), [albedo, sky])
    return g_a.numpy(), g_s.numpy(), loss


def test_sky_gradients_match_jax(jax_refs):
    """The gradient through the record walk and the replay (the sky added
    on a miss at weight 1) against JAX's ``jax.grad`` of its kernel: in
    material 0's albedo within 0.1 relative (of each entry plus 1% of the
    largest), in the texels within 0.15 in L2 (tests/test_torch_env.py's
    bounds: one flipped path moves its cotangent to another texel)."""
    _, t = pair()
    g_a, g_s, _ = _port_grads(t)
    want_a, want_s = jax_refs["albedo"], jax_refs["sky"]
    assert np.abs(g_a).sum() > 0 and np.abs(g_s).sum() > 0
    rel = np.abs(g_a - want_a) / (np.abs(want_a)
                                  + 1e-2 * np.abs(want_a).max())
    l2 = np.linalg.norm(g_s - want_s) / np.linalg.norm(want_s)
    print(f"albedo rel err {rel.max():.2e}, sky L2 rel err {l2:.2e}")
    assert rel.max() < 0.1
    assert l2 < 0.15


def test_sky_gradients_match_fd():
    """test_bvh_grad_skymap's check on the port: the albedo's three entries
    and the three texels of largest gradient against central differences
    of the port's own loss (eps 1e-3, rtol 3e-2, atol 5e-3)."""
    _, t = pair()
    g_a, g_s, loss = _port_grads(t)
    albedo0, sky0 = t.materials.albedo[0], t.background.image
    eps = 1e-3

    def fd(which, idx):
        def bump(sign):
            a, s = albedo0.clone(), sky0.clone()
            (a if which == "albedo" else s)[idx] += sign * eps
            with torch.no_grad():
                return float(loss(a, s))
        return (bump(+1) - bump(-1)) / (2 * eps)

    for i in range(3):
        np.testing.assert_allclose(g_a[i], fd("albedo", i), rtol=3e-2,
                                   atol=5e-3)
    top = np.argsort(-np.abs(g_s).reshape(-1))[:3]
    for flat in top:
        idx = np.unravel_index(flat, g_s.shape)
        np.testing.assert_allclose(g_s[idx], fd("sky", idx), rtol=3e-2,
                                   atol=5e-3)


def test_sky_fit_replay_has_no_mis():
    """Without importance sampling the replay adds the sky at weight 1 and
    runs no shadow ray: its forward equals the plain record walk's
    radiance within the replay's tolerance, and the loss of make_loss
    falls over fit's steps."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import megakernel as K

    _, t = pair()
    sc = BK.pack(t, W, H, "cpu")
    sky = t.background
    key = (1, 2)
    ids, px, py = K.prep_rays(torch.arange(W * H), 2, W)
    walk = BK.radiance_bvh_plain(sc, key, ids, px, py, max_depth=3,
                                 bg_kind=sky.kind, clay=False, sky=sky)
    rep = BK.env_radiance(sc, sky, key, W * H, 2, W, max_depth=3, mis=False)
    assert (rep - walk).abs().max().item() < 1e-4
    target = render_linear(_with(t, t.materials.albedo[0] * 0.5,
                                 sky.image, T), W, H, seed=1, device="cpu")
    _, _, history = fit(t, target, ["albedo"], W, H, steps=4,
                        device="cpu", learning_rate=0.05)
    assert np.isfinite(history).all() and history[-1] < history[0]


# -------------------------------------------------------------- the views

def _bg(mod, kind):
    if kind == "uniform":
        return mod.Background.uniform((0.6, 0.7, 0.9))
    if kind == "gradient":
        return mod.Background.gradient((0.9, 0.9, 1.0), (0.4, 0.55, 0.9))
    return mod.Background.skymap_from_array(demo_sky())


def view_builder(mod, mode, bg):
    """tests/test_debug_modes.py::scene for either package: a triangle fan,
    a ground sphere and a metal sphere, spp 2 depth 6, under ``bg``."""
    b = mod.SceneBuilder()
    ml = b.add_material(mod.Lambertian((0.7, 0.35, 0.2)))
    mm = b.add_material(mod.Metal((0.85, 0.85, 0.9), 0.15))
    n = 9
    ang = np.linspace(0, 2 * np.pi, n, dtype=np.float32)
    rim = np.stack([0.7 * np.cos(ang), 0.25 + 0.12 * np.sin(3 * ang),
                    -1.0 + 0.7 * np.sin(ang)], 1)
    verts = np.concatenate([[[0, 0.45, -1.0]], rim]).astype(np.float32)
    faces = np.stack([np.zeros(n - 1, np.int32),
                      np.arange(1, n, dtype=np.int32),
                      1 + (np.arange(1, n, dtype=np.int32) % (n - 1))], -1)
    mesh = JMesh if mod is J else TMesh
    b.add_mesh(mesh.from_buffers(verts, verts, faces, ml))
    b.add_sphere((0, -100.35, -1), 100.0, ml)
    b.add_sphere((0.55, 0.0, -0.6), 0.18, mm)
    b.camera = mod.Camera.create((0, 0.4, 1.6), (0, 0.1, -1), (0, 1, 0),
                                 60.0, 4 / 3)
    b.settings = mod.RenderSettings(samples_per_pixel=2, max_ray_depth=6,
                                    mode=mode)
    b.background = _bg(mod, bg)
    return b


def _check_view(j, t, engine, atol=1e-5):
    """test_debug_modes.py::_check_mode's bound: at most 4 pixels of 320
    differ by more than ``atol`` (the engines' winner arithmetic differs at
    an ulp on borderline rays, and the normal's normalization: 1 / sqrt
    here, rsqrt in the JAX kernel, a division in its XLA integrator)."""
    assert select_engine(t) == "bvh"
    got = render_linear(t, 20, 16, seed=3, device="cpu").numpy()
    want = np.asarray(j_render(j, 20, 16, seed=3, engine=engine))
    neq = (np.abs(got - want) > atol).any(-1)
    assert neq.sum() <= 4, f"{neq.sum()} pixels differ"
    return got


@pytest.mark.parametrize("bg", ["uniform", "gradient", "sky"])
@pytest.mark.parametrize("mode", ["Normal", "Random"])
def test_views_match_jax(mode, bg):
    """The views against the JAX packet-traversal kernel's (uniform and
    gradient backgrounds) and, for a sky map, which the JAX gate keeps on
    its XLA integrator, against that integrator's."""
    j, t = (view_builder(m, mode, bg).build(with_bvh=True) for m in (J, T))
    got = _check_view(j, t, "xla" if bg == "sky" else "pallas_bvh")
    if mode == "Random":  # a hit is black, a miss the background
        assert (got == 0).all(-1).any() and (got > 0).all(-1).any()
    else:
        assert got.std() > 0


def test_zoo_view_matches_jax():
    """The Normal view of scenes/material_zoo.json (a fog sphere, whose
    free flight draws from bounce stream 1, and a mix) and its Random view
    against the JAX XLA integrator's.  The zoo's spheres of radius 0.12
    scale an ulp of a hit distance into ~1e-4 of its normal: beyond 1e-5,
    14 pixels differ from the XLA integrator, 15 from the JAX kernel, and
    the two JAX engines differ on 6; beyond 1e-4 none (measured), and a
    wrong winner's normal differs by far more, so the bound is 4 pixels
    beyond 1e-4."""
    def zoo(mod, mode):
        b = mod.SceneBuilder.from_file(ZOO)
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=2,
                                         mode=mode)
        return b.build(with_bvh=True)

    _check_view(zoo(J, "Normal"), zoo(T, "Normal"), "xla", atol=1e-4)
    got = _check_view(zoo(J, "Random"), zoo(T, "Random"), "xla")
    assert (got == 0).all(-1).any()


# ------------------------------------------------------ the gate, the CLI

def test_gate_routes_sky_and_views():
    """A non-IS sky map (Full, Clay) and every view take #5 with the
    scene's BVH; a sky scene of the brute kernels' size takes #1 (Full,
    Clay) with or without it, a view #5 with it and without it names A6;
    a view asked for a gradient raises; a mesh-bounded volume under the
    sky takes #5 without importance sampling and raises naming A6 with it
    (the JAX package renders it with its XLA integrator)."""
    for mode in ("Full", "Clay", "Normal", "Random"):
        b = sky_builder(T, mode=mode)
        scene = b.build(with_bvh=True)
        assert BK.unsupported_bvh(scene) is None
        assert select_engine(scene) == "bvh"
        small = grid_builder(T, n=2, depth=2)  # brute-kernel size
        small.background = b.background
        small.settings = dataclasses.replace(small.settings, mode=mode)
        if mode in ("Full", "Clay"):
            assert select_engine(small.build(with_bvh=True)) == "brute"
            assert select_engine(small.build(with_bvh=False)) == "brute"
        else:
            assert select_engine(small.build(with_bvh=True)) == "bvh"
            with pytest.raises(NotImplementedError, match="ROADMAP A6"):
                select_engine(small.build(with_bvh=False))
    for bg in ("uniform", "gradient"):
        b = grid_builder(T, n=2, depth=2, mode="Normal")
        b.background = _bg(T, bg)
        assert select_engine(b.build(with_bvh=True)) == "bvh"
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            select_engine(b.build(with_bvh=False))
    view = sky_builder(T, mode="Normal").build(with_bvh=True)
    with pytest.raises(ValueError, match="no gradient"):
        select_engine(view, grad=True)
    view.materials.albedo.requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        render_linear(view, 4, 4, device="cpu")
    b = sky_builder(T)
    b.add_volume(next(i for i, o in enumerate(b.objects)
                      if o["kind"] == "mesh"), 1.0)
    assert select_engine(b.build(with_bvh=True)) == "bvh"
    b.settings = dataclasses.replace(b.settings, env_importance_sampling=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        select_engine(b.build(with_bvh=True))


def test_cli_views_and_sky(tmp_path, capsys):
    """CLI ``render --mode Normal``, and ``render`` and ``fit`` of a sky
    map without ``--env-is``, on the CPU; ``info`` names their engines."""
    sky = str(tmp_path / "sky.exr")
    write_exr(sky, demo_sky())
    verts, faces = sheet_buffers(6)
    obj = str(tmp_path / "sheet.obj")
    with open(obj, "w") as f:
        f.writelines([f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts]
                     + [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces])
    b = sky_builder(T, depth=2)  # the sheet from the OBJ, which JSON names
    b.objects = [o for o in b.objects if o["kind"] == "sphere"]
    b.add_mesh(TMesh.from_file(obj, 0))
    b.background = T.Background.skymap(sky)
    scene = str(tmp_path / "scene.json")
    b.save(scene)
    png = str(tmp_path / "sky.png")
    assert cli.main(["render", scene, "--width", "12", "--height", "10",
                     "--device", "cpu", "-o", png]) == 0
    assert "Last render took" in capsys.readouterr().out
    assert read_png(png)[..., :3].std() > 0
    normal = str(tmp_path / "normal.png")
    assert cli.main(["render", scene, "--mode", "Normal", "--width", "12",
                     "--height", "10", "--device", "cpu", "-o",
                     normal]) == 0
    capsys.readouterr()
    assert read_png(normal)[..., :3].std() > 0
    assert cli.main(["info", scene]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "sky-map variant" in info["render_engine"]
    assert "the replay with the sky" in info["fit_engine"]
    assert cli.main(["info", scene, "--mode", "Random"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "random view" in info["render_engine"]
    assert "no gradient" in info["fit_engine"]
    assert cli.main(["fit", scene, png, "--params", "albedo,emission",
                     "--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split("final loss")[1].split()[0]))
