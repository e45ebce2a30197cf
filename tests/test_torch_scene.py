"""Scene intake of the port against the JAX package: the JSON loader, the
array hand-over, the packed kernel constants and the ray fan-out."""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.models.scene import SceneBuilder as JBuilder
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render.render import render_linear as j_render_linear
from raytracingrust_tpu_torch.io.exr import write_exr
from raytracingrust_tpu_torch.models import backgrounds as TB
from raytracingrust_tpu_torch.models.convert import scene_from_arrays
from raytracingrust_tpu_torch.models.scene import RenderSettings
from raytracingrust_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENES = {name: os.path.join(ROOT, "scenes", f"{name}.json")
          for name in ("benchmark", "cornell_spheres", "material_zoo")}
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "benchmark.npz")


def scene_arrays(scene) -> dict:
    """The leaves of a Scene of either package, under scene_from_arrays'
    names (both packages name the fields alike)."""
    c, bg, s, m = scene.camera, scene.background, scene.spheres, \
        scene.materials
    return {
        "camera.lookfrom": c.lookfrom, "camera.lookat": c.lookat,
        "camera.vertical": c.vertical, "camera.vertical_fov": c.vertical_fov,
        "camera.aspect_ratio": c.aspect_ratio,
        "background.color_a": bg.color_a, "background.color_b": bg.color_b,
        "spheres.center": s.center, "spheres.radius": s.radius,
        "spheres.material": s.material,
        "spheres.neg_inv_density": s.neg_inv_density,
        "materials.kind": m.kind, "materials.albedo": m.albedo,
        "materials.fuzz": m.fuzz, "materials.ir": m.ir,
        "materials.emission": m.emission, "materials.mix_first": m.mix_first,
        "materials.mix_second": m.mix_second,
        "materials.mix_factor": m.mix_factor,
    }


def assert_same_arrays(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    for k in ref:
        want = np.asarray(ref[k])
        got = np.asarray(port[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def gradient_builders():
    """(JAX builder, port builder) of one gradient-background scene."""
    def fill(mod, b):
        # the benchmark camera: its basis is exact in both packages (see
        # test_camera_basis_within_4_ulp for other cameras)
        b.camera = mod.Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0),
                                     90.0, 1.2)
        b.background = mod.Background.gradient((0.5, 0.7, 1.0),
                                               (1.0, 1.0, 1.0))
        lam = b.add_material(mod.Lambertian((0.7, 0.4, 0.2)))
        met = b.add_material(mod.Metal((0.9, 0.9, 0.9), 0.1))
        b.add_sphere((0, -0.3, -1.2), 0.4, lam)
        b.add_sphere((0.8, 0.2, -1.5), 0.4, met)
        return b
    import raytracingrust_tpu_torch as T
    return fill(J, JBuilder()), fill(T, TBuilder())


@pytest.mark.parametrize("name", ["benchmark", "cornell_spheres",
                                  "material_zoo"])
def test_loader_matches_jax(name):
    j = JBuilder.from_file(SCENES[name]).build(with_bvh=False)
    t = TBuilder.from_file(SCENES[name]).build()
    assert_same_arrays(scene_arrays(t), scene_arrays(j))
    assert t.background.kind == j.background.kind
    assert t.settings.to_json() == j.settings.to_json()
    assert t.spheres.num_volumes == j.spheres.num_volumes
    assert t.materials.has_mix == j.materials.has_mix


@pytest.mark.parametrize("name", ["benchmark", "cornell_spheres"])
def test_json_round_trip(name, tmp_path):
    b = TBuilder.from_file(SCENES[name])
    b.save(str(tmp_path / "s.json"))
    with open(SCENES[name]) as f:
        assert TBuilder.from_file(str(tmp_path / "s.json")).to_json() == \
            TBuilder.from_json(json.load(f)).to_json()


def test_scene_from_arrays_equals_loader():
    j = JBuilder.from_file(SCENES["cornell_spheres"]).build(with_bvh=False)
    arrays = {k: np.asarray(v) for k, v in scene_arrays(j).items()}
    settings = RenderSettings.from_json(j.settings.to_json())
    via = scene_from_arrays(arrays, settings, j.background.kind)
    loaded = TBuilder.from_file(SCENES["cornell_spheres"]).build()
    assert_same_arrays(scene_arrays(via), scene_arrays(loaded))
    assert via.settings == loaded.settings
    assert via.background.kind == loaded.background.kind


def test_envelope_refusals(tmp_path):
    zoo = TBuilder.from_file(SCENES["material_zoo"]).build()  # loads
    # its volume, isotropic material and mix take the brute kernels (as in
    # the JAX package), with or without its BVH
    assert select_engine(zoo) == "brute"
    img = render_linear(zoo, 8, 6, device="cpu")
    assert img.shape == (6, 8, 3) and bool(torch.isfinite(img).all())
    img = render_linear(TBuilder.from_file(SCENES["material_zoo"]).build(
        with_bvh=False), 8, 6, device="cpu")
    assert bool(torch.isfinite(img).all())
    # a small sphere scene built with its BVH still takes the brute kernel
    bench = TBuilder.from_file(SCENES["benchmark"]).build(with_bvh=True)
    assert bench.cbvh is not None and select_engine(bench) == "brute"
    # a SkyMap loads; without importance sampling the brute kernel's
    # naive lookup takes the small scene, with or without the BVH
    sky = str(tmp_path / "sky.exr")
    write_exr(sky, np.full((4, 8, 3), 0.5, np.float32))
    bench.background = TB.Background.from_json({"type": "SkyMap",
                                                 "path": sky})
    assert select_engine(bench) == "brute"
    img = render_linear(bench, 8, 6, device="cpu")
    assert img.shape == (6, 8, 3) and bool(torch.isfinite(img).all())
    img = render_linear(dataclasses.replace(bench, cbvh=None), 8, 6,
                        device="cpu")
    assert bool(torch.isfinite(img).all()) and img.max() > 0
    # fog inside a mesh loads and takes the BVH kernel's crossing scan;
    # without the BVH it needs the XLA integrator (ROADMAP A6)
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 -2\nv 1 0 -2\nv 0 1 -2\nv 0 0 -3\n"
                   "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    mesh = {"camera": {}, "settings": {}, "background": {}, "objects": [
        {"type": "Volume", "neg_inv_density": -1.0, "boundary": {
            "type": "Mesh", "path": str(obj), "material": 0}}],
        "materials": [{"type": "Isotropic",
                       "color": {"r": 0.5, "g": 0.5, "b": 0.5}}]}
    b = TBuilder.from_file(SCENES["benchmark"]).to_json()
    mesh.update(camera=b["camera"], settings=b["settings"],
                background=b["background"])
    fog = TBuilder.from_json(mesh)
    assert select_engine(fog.build(with_bvh=True)) == "bvh"
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        render_linear(fog.build(with_bvh=False), 8, 6, device="cpu")
    # cornell_spheres sets enable_bvh_tree; the brute path takes it
    cornell = TBuilder.from_file(SCENES["cornell_spheres"]).build()
    assert cornell.settings.enable_bvh_tree and TK.supports(cornell)
    assert select_engine(cornell) == "brute"


@pytest.mark.parametrize("kind", ["uniform", "gradient"])
def test_background_sample_matches_jax(kind):
    import raytracingrust_tpu_torch as T

    colors = [(0.5, 0.7, 1.0), (1.0, 0.9, 0.2)]
    if kind == "uniform":
        j, t = J.Background.uniform(colors[0]), T.Background.uniform(colors[0])
    else:
        j, t = J.Background.gradient(*colors), T.Background.gradient(*colors)
    d = np.random.RandomState(0).standard_normal((64, 3)).astype(np.float32)
    want = np.asarray(j.sample(jnp.asarray(d)))
    got = t.sample(torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert t.to_json() == j.to_json()


def _fparams_cases():
    jg, tg = gradient_builders()
    out = {"gradient": (jg.build(with_bvh=False), tg.build())}
    for name in ("benchmark", "cornell_spheres"):
        out[name] = (JBuilder.from_file(SCENES[name]).build(with_bvh=False),
                     TBuilder.from_file(SCENES[name]).build())
    return out


@pytest.mark.parametrize("name", ["benchmark", "cornell_spheres", "gradient"])
@pytest.mark.parametrize("size", [(32, 26), (1000, 1000)])
def test_pack_fparams_bitwise(name, size):
    j, t = _fparams_cases()[name]
    want = np.asarray(PK._pack_fparams(j, *size))
    got = TK.pack_fparams(t, *size).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(TK.sphere_kinds(t).numpy(),
                                  np.asarray(PK._sphere_kinds(j)))


def test_camera_basis_within_4_ulp():
    """Other cameras agree within a few ulps: float32 tan differs by an ulp
    between PyTorch and XLA (measured), and the basis carries it on."""
    import raytracingrust_tpu_torch as T

    rs = np.random.RandomState(0)
    for _ in range(50):
        args = (rs.uniform(-5, 5, 3), rs.uniform(-5, 5, 3), (0, 1, 0),
                rs.uniform(20, 120), rs.uniform(0.5, 2.0))
        want = np.concatenate([np.asarray(v) for v in
                               J.Camera.create(*args).ray_origin()])
        got = torch.cat(T.Camera.create(*args).ray_origin()).numpy()
        np.testing.assert_array_max_ulp(got, want, maxulp=4)


@pytest.mark.parametrize("spp,width,n_pix", [(5, 32, 32 * 26), (3, 17, 100)])
def test_prep_rays_bitwise(spp, width, n_pix):
    pid = np.arange(n_pix, dtype=np.int32)
    jr, jx, jy, _, n = PK._prep_rays(jnp.asarray(pid), spp, width)
    tr, tx, ty = TK.prep_rays(torch.as_tensor(pid), spp, width)
    assert tr.dtype == torch.int32 and n == n_pix * spp
    for g, w in ((tr, jr), (tx, jx), (ty, jy)):
        w = np.asarray(w).reshape(-1)[:n]
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))


def test_vendored_benchmark_scene_renders_golden():
    """scenes/benchmark.json is the benchmark scene of the goldens: the JAX
    XLA render at the golden's size and seed equals it bit for bit."""
    rec = np.load(GOLDEN)
    scene = JBuilder.from_file(SCENES["benchmark"]).build()
    img = np.asarray(j_render_linear(scene, int(rec["width"]),
                                     int(rec["height"]),
                                     seed=int(rec["seed"]), engine="xla"))
    np.testing.assert_array_equal(img, rec["img"])


def test_vendored_benchmark_scene_is_the_demo_scene():
    import __graft_entry__

    b = __graft_entry__._demo_builder()
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=5,
                                     max_ray_depth=6, enable_bvh_tree=False)
    b.background = J.Background.uniform((0.6, 0.6, 0.6))
    with open(SCENES["benchmark"]) as f:
        assert json.loads(json.dumps(b.to_json())) == json.load(f)
