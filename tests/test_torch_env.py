"""The port's HDRI importance-sampling path on the CPU against the JAX
package: the EXR reader and writer, the sky map and its sampler, the
occlusion test's plain version, the env render and its gradients, the CLI.

On the CPU the port runs the plain versions (the record walk, the fetch's
gathers, ops/occlusion.occluded_plain); the CUDA kernels are held to them
on the card by tests/test_torch_gpu.py.  One scene serves every test: the
JAX env-IS test's three spheres with a small triangle sheet through the
ground, under its sun sky, so the walks cross a sphere tree and a triangle
tree.  The JAX references (the interpret-mode hybrid, whose compiles are
slow) run once, in module-scoped fixtures.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import raytracingrust_tpu as J
import raytracingrust_tpu.ops.pallas_megakernel as PK
from raytracingrust_tpu.io import exr as jexr
from raytracingrust_tpu.models import backgrounds as JB
from raytracingrust_tpu.models.mesh import Mesh as JMesh
from raytracingrust_tpu.render.integrator import nee_stream
from raytracingrust_tpu.render.render import render_linear as j_render
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.io import exr as texr
from raytracingrust_tpu_torch.models import backgrounds as TB
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import occlusion as OC
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import rng as trng
from test_torch_bvh_build import sheet_buffers

def sun_sky(h=16, w=32):
    """tests/test_env_is_kernel.py::sun_sky: a dim sky, a small bright sun."""
    img = np.full((h, w, 3), 0.05, np.float32)
    img[2:4, 5:8] = 25.0
    return img


def env_builder(mod, spp=8, depth=3, sky=None):
    """tests/test_env_is_kernel.py::env_scene with a 32-triangle sheet of
    tests/test_pallas_bvh.py::mesh_builder, for either package."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 1.2, 4), (0, 0.6, 0), (0, 1, 0), 55.0,
                                 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth,
                                    env_importance_sampling=True)
    lam = b.add_material(mod.Lambertian((0.7, 0.6, 0.5)))
    met = b.add_material(mod.Metal((0.9, 0.9, 0.9), 0.1))
    b.add_sphere((0, -100, 0), 100.0, lam)
    b.add_sphere((0.8, 0.5, 0), 0.5, met)
    b.add_sphere((-0.8, 0.4, 0), 0.4, lam)
    verts, faces = sheet_buffers(4)
    b.add_mesh((JMesh if mod is J else TMesh).from_buffers(verts, verts,
                                                           faces, lam))
    b.background = mod.Background.skymap_from_array(
        sun_sky() if sky is None else sky)
    return b


def pair(**kw):
    return tuple(env_builder(m, **kw).build(with_bvh=True) for m in (J, T))


def random_sky(h=64, w=128, seed=0):
    """Distinct texels (so equal radiance means the same texel) with a
    small bright sun."""
    img = np.random.default_rng(seed).uniform(0.05, 1.0, (h, w, 3)).astype(
        np.float32)
    img[10:13, 40:44] *= 40.0
    return img


# ---------------------------------------------------------------- (a) EXR

def test_exr_round_trip_both_ways(tmp_path):
    """The port writes what the JAX package reads, and reads what it
    writes, bit for bit; the two writers write the same bytes."""
    img = np.random.default_rng(1).standard_normal((7, 11, 3)).astype(
        np.float32) * 100.0
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    texr.write_exr(a, img)
    jexr.write_exr(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for got in (jexr.read_exr(a), texr.read_exr(b), texr.read_exr(a)):
        np.testing.assert_array_equal(got.view(np.int32),
                                      img.view(np.int32))


# ---------------------------------------------------------------- (b) sky

@pytest.fixture(scope="module")
def skies():
    img = random_sky()
    return JB.Background.skymap_from_array(img), \
        TB.Background.skymap_from_array(img)


def test_skymap_cdfs_bitwise(skies):
    j, t = skies
    for name in ("image", "cdf_rows", "cdf_cols"):
        want = np.asarray(getattr(j, name))
        got = getattr(t, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_skymap_lookup_and_pdf_match_jax(skies):
    """``sample`` and ``pdf`` on 4,096 seeded directions: the same texel but
    where acos/atan2 differ by an ulp at a texel edge (measured: 0 of
    4,096; allowed 0.1%), and the pdf within rtol 1e-5 where it agrees."""
    j, t = skies
    d = np.random.default_rng(2).standard_normal((4096, 3)).astype(
        np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(j.sample(jnp.asarray(d)))
    got = t.sample(torch.tensor(d)).numpy()
    same = (got == want).all(axis=1)
    print(f"texels differ on {int((~same).sum())} of {len(d)} directions")
    assert (~same).mean() <= 1e-3
    p_want = np.asarray(j.pdf(jnp.asarray(d)))
    p_got = t.pdf(torch.tensor(d)).numpy()
    np.testing.assert_allclose(p_got[same], p_want[same], rtol=1e-5)


def _edge_uniforms(cdf_rows, n=4096, seed=3):
    """Seeded uniforms, then values on the CDF's own entries, 0 and the
    largest float32 below 1 (the ties a search gets wrong first)."""
    u = np.random.default_rng(seed).uniform(0, 1, (2, n)).astype(np.float32)
    edge = np.concatenate([cdf_rows[::7], [0.0, np.float32(1 - 2 ** -24)]])
    u[0, :edge.size] = edge
    u[1, -edge.size:] = edge
    return u


def test_skymap_sampler_indices_equal_jax(skies):
    """The row by searchsorted and the column by the binary search equal
    the JAX compare-and-count on every draw, ties on CDF entries included;
    the directions within atol 1e-5, the pdfs within rtol 1e-5."""
    j, t = skies
    rows = np.asarray(j.cdf_rows)
    cols = np.asarray(j.cdf_cols)
    h, w = cols.shape
    u1, u2 = _edge_uniforms(rows)
    y_want = np.clip((rows[None, :] < u1[:, None]).sum(1), 0, h - 1)
    x_want = np.clip((cols[y_want] < u2[:, None]).sum(1), 0, w - 1)
    tu1, tu2 = torch.tensor(u1), torch.tensor(u2)
    y = torch.clamp(torch.searchsorted(t.cdf_rows, tu1), 0, h - 1)
    x = torch.clamp(TB._lower_bound(t.cdf_cols.reshape(-1), y, w, tu2),
                    0, w - 1)
    np.testing.assert_array_equal(y.numpy(), y_want)
    np.testing.assert_array_equal(x.numpy(), x_want)
    d_want, p_want = JB.sample_skymap_direction(j, jnp.asarray(u1),
                                                jnp.asarray(u2))
    d_got, p_got = TB.sample_skymap_direction(t, tu1, tu2)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), atol=1e-5)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), rtol=1e-5)


def test_skymap_json_forms(tmp_path):
    """Both JSON forms load as the JAX package loads them; ``to_json``
    writes the path form and refuses an array-built map."""
    img = random_sky(8, 16, seed=4)
    path = str(tmp_path / "sky.exr")
    texr.write_exr(path, img)
    inline = {"type": "SkyMap", "width": 16, "height": 8, "image": [
        {"r": float(p[0]), "g": float(p[1]), "b": float(p[2])}
        for p in img.reshape(-1, 3)]}
    for d in ({"type": "SkyMap", "path": path}, inline):
        t = TB.Background.from_json(d)
        j = JB.Background.from_json(d)
        assert t.kind == j.kind == TB.SKYMAP
        for name in ("image", "cdf_rows", "cdf_cols"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))
    assert TB.Background.skymap(path).to_json() == {
        "type": "SkyMap", "path": path, "width": 16, "height": 8}
    with pytest.raises(ValueError, match="not JSON-serializable"):
        TB.Background.from_json(inline).to_json()


def test_scene_from_arrays_carries_the_sky(skies):
    """models/convert.py hands a JAX sky map's texels and CDFs across."""
    from raytracingrust_tpu_torch.models.convert import scene_from_arrays
    from test_torch_scene import scene_arrays

    j_sky, t_sky = skies
    j, _ = pair(spp=2, depth=2)
    j = dataclasses.replace(j, background=j_sky)
    arrays = {k: np.asarray(v) for k, v in scene_arrays(j).items()}
    arrays.update({f"background.{k}": np.asarray(getattr(j_sky, k))
                   for k in ("image", "cdf_rows", "cdf_cols")})
    got = scene_from_arrays(arrays, T.RenderSettings(), j.background.kind)
    assert got.background.kind == TB.SKYMAP
    for k in ("image", "cdf_rows", "cdf_cols"):
        assert torch.equal(getattr(got.background, k), getattr(t_sky, k))


# ---------------------------------------------------------- (c) occlusion

def test_occluded_plain_matches_jax_kernel():
    """``occluded_plain`` against the JAX occlusion kernel (interpret
    mode) on 512 seeded rays through the sphere and the triangle tree, bit
    for bit, with both outcomes present; the any-hit walk does no more
    tests than the closest-hit walk would."""
    import collections

    j, t = pair(spp=1, depth=2)
    r = 512
    gen = np.random.default_rng(7)
    o = gen.uniform(-2.0, 2.0, (r, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.05  # above the ground sphere
    d = gen.standard_normal((r, 3)).astype(np.float32)
    key = trng.base_key(3)
    words = jnp.asarray(np.array(key, np.uint32).view(np.int32))
    want = np.asarray(PK.occlusion_bvh(
        j, jnp.asarray(o), jnp.asarray(d), nee_stream(0, 2), words,
        jnp.arange(r, dtype=jnp.int32), interpret=True))
    sc = BK.pack(t, 8, 8, "cpu")
    tally = collections.Counter()
    got = OC.occluded(sc, torch.tensor(o.T.copy()), torch.tensor(d.T.copy()))
    np.testing.assert_array_equal(
        OC.occluded_plain(sc, torch.tensor(o.T.copy()),
                          torch.tensor(d.T.copy()), tally=tally).numpy(),
        want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9
    assert tally["sphere_tests"] > 0 and tally["triangle_tests"] > 0
    closest = collections.Counter()
    BK._walk(sc.spheres, BK._sphere_leaf, list(torch.tensor(o.T)),
             list(torch.tensor(d.T)), [1.0 / v for v in torch.tensor(d.T)],
             torch.tensor((d * d).sum(1)), torch.ones(r, dtype=torch.bool),
             torch.full((r,), float("inf")),
             torch.full((r,), -1, dtype=torch.long), closest, "sphere_tests")
    assert tally["sphere_tests"] < closest["sphere_tests"]


def test_occlusion_refusals():
    """The kernel's wrapper refuses CPU tensors; through a volume the test
    needs the rays' ids and the key (their free-flight uniforms), and with
    them it answers."""
    _, t = pair(spp=1, depth=2)
    sc = BK.pack(t, 8, 8, "cpu")
    rays = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        OC.occluded_cuda(sc, rays, rays)
    fog = env_builder(T, spp=1, depth=2)
    fog.objects.append({"kind": "sphere", "center": (0, 0.5, 0),
                        "radius": 0.3, "material": 0,
                        "neg_inv_density": -2.0})
    fsc = BK.pack(fog.build(with_bvh=True), 8, 8, "cpu")
    assert fsc.volumes is not None
    o = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.5, 0.5, 3.0, 3.0],
                      [2.0, 2.0, 2.0, 2.0]])
    d = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0],
                      [-1.0, -1.0, 0.0, 0.0]])
    with pytest.raises(ValueError, match="ids"):
        OC.occluded_plain(fsc, o, d)
    got = OC.occluded_plain(fsc, o, d, torch.arange(4, dtype=torch.int32),
                            trng.base_key(3), 5)
    assert got.shape == (4,) and not got[2:].any()  # upward: the sky


# ------------------------------------------------- (d) render, (e) gradients

W, H = 10, 10


def _with(scene, albedo, sky, mod):
    """The scene with material 0's albedo and the sky's texels replaced."""
    a = (scene.materials.albedo.at[0].set(albedo) if mod is J else
         torch.cat([albedo[None], scene.materials.albedo[1:]]))
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, albedo=a),
        background=dataclasses.replace(scene.background, image=sky))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX hybrid (interpret mode) at 10x10 spp 8: at depth 3 the image
    and the gradient of sum(image^2) in material 0's albedo and the sky's
    texels, in one jitted VJP; at depth 1 the image."""
    j, _ = pair(spp=8, depth=3)

    def image(albedo, sky):
        return j_render(_with(j, albedo, sky, J), W, H, seed=0,
                        engine="pallas_bvh")

    def image_and_grads(albedo, sky):
        img, vjp = jax.vjp(image, albedo, sky)
        return img, vjp(2.0 * img)

    img, (g_a, g_s) = jax.jit(image_and_grads)(j.materials.albedo[0],
                                               j.background.image)
    j1, _ = pair(spp=8, depth=1)
    return {3: np.asarray(img), "albedo": np.asarray(g_a),
            "sky": np.asarray(g_s),
            1: np.asarray(j_render(j1, W, H, seed=0, engine="pallas_bvh"))}


def test_env_render_matches_jax(jax_refs):
    """The port's plain route against the JAX hybrid at 10x10 spp 8 depth
    3, within the hybrid-vs-XLA tolerance of tests/test_env_is_kernel.py:
    at most 10% of channels outside atol 1e-4 / rtol 1e-3, mean abs diff
    below 1e-2."""
    _, t = pair(spp=8, depth=3)
    assert select_engine(t) == "env"
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[3]
    off = (~np.isclose(got, want, atol=1e-4, rtol=1e-3)).mean()
    print(f"depth 3: {off:.4f} of channels outside, mean abs diff "
          f"{np.abs(got - want).mean():.2e}")
    assert off <= 0.1
    assert np.abs(got - want).mean() < 1e-2


def test_env_render_depth1_matches_jax(jax_refs):
    """At depth 1 (the sky on a miss, the emission or one NEE term on a
    hit) the images agree but for the ulps of the sampler's and lookup's
    transcendentals (ROADMAP C): every channel within rtol 1e-5 except
    where an ulp moves a direction across a texel edge or a shadow ray's
    cosine (measured 3 of 300 channels, 212 bitwise; allowed 2%)."""
    _, t = pair(spp=8, depth=1)
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[1]
    off = ~np.isclose(got, want, rtol=1e-5, atol=0.0)
    print(f"depth 1: {int(off.sum())} of {off.size} channels outside rtol "
          f"1e-5, {int((got == want).sum())} equal")
    assert off.mean() <= 0.02


def test_env_gradients_match_jax(jax_refs):
    """d sum(image^2) in material 0's albedo within 0.1 relative (of each
    entry plus 1% of the largest) and in the sky's texels within 0.15 in L2
    (tests/test_env_is_kernel.py's tolerances: one flipped path moves its
    whole cotangent to another texel)."""
    _, t = pair(spp=8, depth=3)
    albedo = t.materials.albedo[0].clone().requires_grad_(True)
    sky = t.background.image.clone().requires_grad_(True)
    img = render_linear(_with(t, albedo, sky, T), W, H, seed=0,
                        device="cpu")
    g_a, g_s = (g.numpy() for g in torch.autograd.grad((img ** 2).sum(),
                                                       [albedo, sky]))
    want_a, want_s = jax_refs["albedo"], jax_refs["sky"]
    assert np.abs(g_a).sum() > 0 and np.abs(g_s).sum() > 0
    rel = np.abs(g_a - want_a) / (np.abs(want_a)
                                  + 1e-2 * np.abs(want_a).max())
    l2 = np.linalg.norm(g_s - want_s) / np.linalg.norm(want_s)
    print(f"albedo rel err {rel.max():.2e}, sky L2 rel err {l2:.2e}")
    assert rel.max() < 0.1
    assert l2 < 0.15


# ------------------------------------------------- the gate and refusals

def test_env_gate_and_refusals():
    """Env-IS scenes with their BVH take the env path at any size, fog
    included; env-IS without a BVH raises, naming its ROADMAP item; a sky
    map without importance sampling (or in Clay mode, where the flag does
    not apply) takes #5's sky-map variant."""
    b = env_builder(T)
    assert select_engine(b.build(with_bvh=True)) == "env"
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        select_engine(b.build(with_bvh=False))
    naive = env_builder(T)
    naive.settings = dataclasses.replace(naive.settings,
                                         env_importance_sampling=False)
    assert select_engine(naive.build(with_bvh=True)) == "bvh"
    clay = env_builder(T)
    clay.settings = dataclasses.replace(clay.settings, mode="Clay")
    assert select_engine(clay.build(with_bvh=True)) == "bvh"
    fog = env_builder(T)
    fog.objects.append({"kind": "sphere", "center": (0, 0.5, 0),
                        "radius": 0.3, "material": 0,
                        "neg_inv_density": -2.0})
    assert select_engine(fog.build(with_bvh=True)) == "env"


# ------------------------------------------------------------- (f) CLI

def test_cli_env_render_and_fit(tmp_path, capsys):
    """CLI ``render --env-is`` and ``fit --env-is`` on the CPU, reading a
    sky the port's EXR writer wrote."""
    sky = str(tmp_path / "sky.exr")
    texr.write_exr(sky, sun_sky())
    b = env_builder(T, spp=2, depth=2)
    b.background = TB.Background.skymap(sky)
    b.settings = dataclasses.replace(b.settings,
                                     env_importance_sampling=False)
    b.objects = [o for o in b.objects if o["kind"] == "sphere"]
    scene = str(tmp_path / "scene.json")
    b.save(scene)
    with open(scene) as f:
        assert json.load(f)["background"] == {
            "type": "SkyMap", "path": sky, "width": 32, "height": 16}
    png = str(tmp_path / "env.png")
    assert cli.main(["render", scene, "--env-is", "--width", "12",
                     "--height", "10", "--device", "cpu", "-o", png]) == 0
    assert "Last render took" in capsys.readouterr().out
    assert cli.main(["info", scene, "--env-is"]) == 0
    assert json.loads(capsys.readouterr().out)["render_engine"].startswith(
        "env")
    assert cli.main(["fit", scene, png, "--env-is", "--params",
                     "albedo,emission", "--steps", "3", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out
    assert np.isfinite(float(out.split("final loss")[1].split()[0]))


def test_make_loss_env_gradient_matches_fd():
    """``make_loss`` routes an env scene through ``render_linear`` and the
    mean: its albedo gradient against a central difference of itself."""
    _, t = pair(spp=2, depth=2)
    target = np.full((6, 8, 3), 0.2, np.float32)
    loss = TG.make_loss(t, target, 8, 6, device="cpu")
    params = {"albedo": t.materials.albedo.clone().requires_grad_(True)}
    loss(params).backward()
    v = torch.tensor(np.random.default_rng(5).standard_normal((2, 3)),
                     dtype=torch.float32)
    ad = (params["albedo"].grad * v).sum().item()
    eps = 1e-3
    with torch.no_grad():
        a = params["albedo"].detach()
        fd = (loss({"albedo": a + eps * v})
              - loss({"albedo": a - eps * v})).item() / (2 * eps)
    assert abs(ad - fd) <= 0.02 * abs(fd)
