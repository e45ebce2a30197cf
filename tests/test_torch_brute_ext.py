"""The brute kernels' new branches on the CPU against the JAX package:
single-level mixes, constant-density sphere volumes, the isotropic lobe and
a sky map's miss, in the plain version that kernels #1, #3 and #4 are held
to on the card (tests/test_torch_gpu.py, chip_smoke.py phase 13).

The scenes are a "mini zoo" (tests/test_torch_gpu.py::brute_ext_builder:
a ground, a metal sphere, a Lambertian/glass mix, an emitter, an isotropic
sphere and a fog sphere of an isotropic material, under a gradient
background) and the same under a numpy-seeded 16x32 sky map, built in both
packages.  The JAX references run ``pixel_radiance_pallas`` and the
gradient kernels in interpret mode under ``jax.jit``, as
tests/test_pallas_mix.py runs them, at 8x6 spp 2 and depth 3 at most.
"""

import dataclasses
import json
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import jax
import jax.numpy as jnp
import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.diff import grad as JG
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render import render as JR
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models.convert import scene_from_arrays
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import rng as trng
from test_torch_gpu import brute_ext_builder
from test_torch_scene import assert_takes_xla, scene_arrays

W, H, SPP = 8, 6, 2
ZOO = "scenes/material_zoo.json"


def pair(depth=3, sky=False):
    """The scene in both packages; the port's carried across from the JAX
    one's arrays (models/convert.py), so both compute on the same float32
    numbers."""
    j = brute_ext_builder(J, depth, SPP, sky).build(with_bvh=False)
    arrays = scene_arrays(j)
    if sky:
        arrays.update({f"background.{k}": getattr(j.background, k)
                       for k in ("image", "cdf_rows", "cdf_cols")})
    t = scene_from_arrays(arrays, brute_ext_builder(T, depth, SPP).settings,
                          j.background.kind)
    return j, t


def _words(seed):
    return jnp.asarray(np.array(trng.base_key(seed), np.uint32).view(
        np.int32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


GRAD_TARGET = np.random.default_rng(1).random((H, W, 3)).astype(np.float32)
SKY_NAMES = ["albedo", "emission", "sphere_center"]


def _sky_loss(j):
    """JAX's loss of the sky scene ``j`` in (params, the sky's texels):
    its two-pass kernels, the texels gathered by ``_env_finish``."""
    def jloss(p, sky):
        s = JG.apply_params(j, p)
        s = dataclasses.replace(s, background=dataclasses.replace(
            s.background, image=sky))
        img = J.render_linear(s, W, H, seed=3, engine="pallas")
        return jnp.mean((img - GRAD_TARGET) ** 2)
    return jloss


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's references, each jitted with its kernels in interpret mode:
    the brute kernel at 8x6 spp 2, depth 1 and depth 3 (seeds 0 and 1), of
    both scenes (key (sky, depth, seed)); jax.grad of the mini zoo's loss
    at depth 2 through the fused kernel ("fused"); and of the sky scene's
    through the two-pass kernels, in the scene leaves and the texels
    ("sky").  The interpret-mode kernels unroll into large graphs, so all
    are lowered first and compiled together on threads at XLA's backend
    optimisation level 0 (the same IEEE operations, less LLVM work)."""
    jobs = {}
    for sky in (False, True):
        for depth in (1, 3):
            j, _ = pair(depth, sky)
            kinds = PK._sphere_kinds(j)
            fn = jax.jit(lambda s, w, kinds=kinds: PK.pixel_radiance_pallas(
                s, jnp.arange(W * H, dtype=jnp.int32), W, H, w,
                sphere_kinds=kinds, tri_kinds=(), interpret=True))
            for seed in ((0, 1) if depth == 3 else (0,)):
                jobs[sky, depth, seed] = (fn, (j, _words(seed)))
    j, _ = pair(2)
    jobs["fused"] = (jax.jit(jax.grad(JG.make_loss(
        j, GRAD_TARGET, W, H, seed=3, engine="pallas"))),
        (JG.extract_params(j, NAMES),))
    j, _ = pair(2, sky=True)
    jobs["sky"] = (jax.jit(jax.grad(_sky_loss(j), argnums=(0, 1))),
                   (JG.extract_params(j, SKY_NAMES), j.background.image))
    lowered = {}
    for k, (fn, args) in jobs.items():
        if not (isinstance(k, tuple) and k[2] == 1):  # seed 1: seed 0's
            lowered[k] = fn.lower(*args)
    with ThreadPoolExecutor(len(lowered)) as ex:
        compiled = dict(zip(lowered, ex.map(
            lambda low: low.compile(compiler_options={
                "xla_backend_optimization_level": 0}), lowered.values())))
    out = {}
    for k, (_, args) in jobs.items():
        run = compiled[k if k in compiled else (k[0], k[1], 0)]
        r = run(*args)
        out[k] = (np.asarray(r).reshape(H, W, 3) if isinstance(k, tuple)
                  else r)
    return out


# ---------------------------------------------------- packing and the gate

@pytest.mark.parametrize("sky", [False, True], ids=["gradient", "sky"])
def test_pack_fparams_and_columns_equal_jax(sky):
    """``pack_fparams`` equals JAX ``_pack_fparams(mix=True)`` entry for
    entry (stride 22: leaf A, the factor, leaf B, -1/density); the kinds
    carry JAX's (kind A, kind B) pairs; the bounce's uniform columns (the
    mix coin, [u1, u2, coin, u_r] from column 4, the fog's free flight at
    column 8) are bitwise JAX's ``_stream_uniforms``; the zoo's packing too."""
    j, t = pair(2, sky)
    fp = TK.pack_fparams(t, W, H).numpy()
    np.testing.assert_array_equal(
        fp, np.asarray(PK._pack_fparams(j, W, H, mix=True)))
    assert fp.shape == (20 + 6 * 22,)
    kinds = TK.sphere_kinds(t).numpy()
    pairs = [k if isinstance(k, tuple) else (k, k)
             for k in PK._sphere_kinds(j)]
    assert [(k & 0xFF, k >> 8) for k in kinds.tolist()] == pairs
    opts = TK.scene_opts(t)
    assert (opts["mix"], opts["n_vol"], opts["iso"]) == (True, 1, True)
    ids = torch.arange(0, 4096, 7, dtype=torch.int32)
    n_u = 4 + 4 + 1  # _radiance_math's n_u: off + 4 + n_vol
    for b in range(2):
        got = trng.ray_uniforms(trng.base_key(9), ids, 1 + b, n_u).numpy()
        k = _words(9).astype(jnp.uint32)
        want = np.stack([np.asarray(c) for c in PK._stream_uniforms(
            k[0], k[1], jnp.asarray(ids.numpy()).astype(jnp.uint32), 1 + b,
            n_u)], axis=-1)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    jz = J.SceneBuilder.from_file(ZOO).build(with_bvh=False)
    tz = T.SceneBuilder.from_file(ZOO).build(with_bvh=False)
    np.testing.assert_array_equal(TK.pack_fparams(tz, W, H).numpy(),
                                  np.asarray(PK._pack_fparams(jz, W, H,
                                                              mix=True)))


def _variants(mod):
    """(label, builder) of one scene per feature the gate decides on."""
    def base(**kw):
        b = mod.SceneBuilder()
        b.settings = mod.RenderSettings(samples_per_pixel=1, max_ray_depth=3,
                                        **kw)
        b.add_sphere((0, 0, -1), 0.5, b.add_material(
            mod.Lambertian((0.5, 0.5, 0.5))))
        return b

    def sky(b):
        b.background = mod.Background.skymap_from_array(
            np.full((4, 8, 3), 0.5, np.float32))
        return b

    out = {}
    b = base()
    b.add_sphere((1, 0, -1), 0.3, b.add_material(mod.MixMaterial(
        mod.Lambertian((0.1, 0.2, 0.3)), mod.Metal((0.9, 0.9, 0.9), 0.1),
        0.5)))
    out["mix"] = b
    b = base()
    b.add_sphere((1, 0, -1), 0.3, b.add_material(mod.Isotropic((1, 1, 1))))
    out["isotropic"] = b
    b = base()
    b.add_volume(b.add_sphere((1, 0, -1), 0.3, b.add_material(
        mod.Isotropic((1, 1, 1)))), 2.0)
    out["volume"] = b
    out["sky"] = sky(base())
    b = base()
    b.add_sphere((1, 0, -1), 0.3, b.add_material(mod.MixMaterial(
        mod.MixMaterial(mod.Lambertian((0.1, 0.2, 0.3)),
                        mod.Emission((1, 1, 1)), 0.5),
        mod.Dielectric(1.5), 0.5)))
    out["nested mix"] = b
    out["env-IS"] = sky(base(env_importance_sampling=True))
    out["view"] = base(mode="Normal")
    mesh = (J.models.mesh.Mesh if mod is J else TMesh).from_buffers(
        np.array([[0, 0, -2], [1, 0, -2], [0, 1, -2]], np.float32),
        np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32), 0)
    b = base()
    b.add_mesh(mesh)
    out["triangle"] = b
    b = base()
    b.add_volume(b.add_mesh(mesh), 1.0)
    out["mesh volume"] = b
    return out


def test_gate_equals_jax_supports():
    """``unsupported`` is None exactly where JAX ``supports`` admits the
    scene, for each feature alone (mix, isotropic, volume, sky map,
    triangles), a nested mix, env-IS, a view and a mesh volume."""
    jv, tv = _variants(J), _variants(T)
    for name in jv:
        j, t = jv[name].build(with_bvh=False), tv[name].build(with_bvh=False)
        why = TK.unsupported(t)
        assert (why is None) == PK.supports(j), (name, why)
    assert '"xla"' in TK.unsupported(tv["nested mix"].build(False))
    assert_takes_xla(tv["nested mix"].build(False))


def test_routes_equal_jax(monkeypatch):
    """The port's ``select_engine`` gives JAX ``select_engine``'s route
    (with the TPU it dispatches for) on every scene of the gate's list,
    with and without its BVH: "pallas" is "brute", "pallas_bvh" is "bvh";
    where JAX falls back to its XLA integrator the port takes its generic
    engine ("xla") too, and env-IS takes the port's "env" path with its
    BVH.  A
    triangle scene built without its BVH takes the brute kernels, as in
    JAX."""
    monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(
        platform="tpu")])
    names = {"pallas": "brute", "pallas_bvh": "bvh"}
    jv, tv = _variants(J), _variants(T)
    for name in jv:
        for bvh in (False, True):
            want = JR.select_engine(jv[name].build(with_bvh=bvh), "auto")
            t = tv[name].build(with_bvh=bvh)
            if name == "env-IS" and bvh:
                assert select_engine(t) == "env"
                continue
            if want == "xla":
                assert_takes_xla(t)
                continue
            assert select_engine(t) == names[want], (name, bvh, want)
            if name != "view":  # a view has no gradient
                assert select_engine(t, grad=True) == names[want]
    for sky in (False, True):
        assert select_engine(pair(3, sky)[1]) == "brute"


# ---------------------------------------------------------------- renders

@pytest.mark.parametrize("sky", [False, True], ids=["gradient", "sky"])
def test_render_depth1_within_two_ulp(jax_refs, sky):
    """Primary visibility (the fog's free flight, the mix leaf, the sky's
    texel or the gradient background) within 2 ulp of JAX's brute kernel
    (the background's 1/sqrt against rsqrt)."""
    _, t = pair(1, sky)
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[sky, 1, 0]
    assert got.max() > 0
    assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("sky", [False, True], ids=["gradient", "sky"])
def test_render_depth3_within_run_parity(jax_refs, sky):
    """At depth 3 bench.py::run_parity's criterion: the mean abs diff from
    JAX's brute kernel within 1.5 times JAX's own seed-to-seed mean abs
    diff.  The share of channels outside atol 1e-4 + rtol 1e-3 is printed
    (measured 0 of 144 on both scenes: the two agree within an ulp)."""
    _, t = pair(3, sky)
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[sky, 3, 0]
    noise = np.abs(want - jax_refs[sky, 3, 1]).mean()
    out = ~np.isclose(got, want, atol=1e-4, rtol=1e-3)
    print(f"sky={sky}: {int(out.sum())} of {out.size} channels outside "
          f"atol 1e-4 + rtol 1e-3; mean abs diff {np.abs(got - want).mean()}"
          f" vs seed noise {noise}")
    assert np.abs(got - want).mean() <= 1.5 * noise


# -------------------------------------------------------------- gradients

NAMES = ["albedo", "emission", "mix_factor", "sphere_center",
         "sphere_radius", "cam_lookfrom", "bg_color_a", "bg_color_b"]


def _port_grads(t, target, names):
    _, got = TG.render_and_grad(t, target, names, W, H, seed=3, device="cpu")
    return {k: v.numpy() for k, v in got.items()}


def _held(got, want, names):
    """Each entry within 5% of JAX's, with a floor of 1e-3 of the group's
    largest (as the texels' check), on the entries JAX gives finite; -> the
    groups with a nonzero gradient."""
    live = []
    for k in names:
        g, ref = got[k], np.asarray(want[k])
        fin = np.isfinite(ref)
        assert np.isfinite(g).all(), k
        if not fin.any() or np.abs(ref[fin]).max() == 0:
            continue
        tol = 0.05 * np.abs(ref[fin]) + 1e-3 * np.abs(ref[fin]).max()
        assert (np.abs(g[fin] - ref[fin]) <= tol).all(), (k, g, ref)
        live.append(k)
    return live


def test_gradients_match_jax_fused_and_fd(jax_refs):
    """The mini zoo at 8x6 spp 2 depth 2 (a scattering bounce and the one
    after it): the port's make_loss gradient (autograd through the plain
    route, which #4 is held to on the card) within 5% of jax.grad through
    JAX's fused kernel on the PARAM_PATHS entries JAX gives finite (its
    brute gradients go NaN under a direction-dependent background, ROADMAP
    C; here the geometry's); the mix factor's gradient is 0 in both; a
    central FD of the port's own loss along a numpy-seeded direction in
    albedo and emission (the fog's phase albedo and the mix's leaves among
    them) agrees within 5%.  The two-pass kernels (#1 and #3's TPU twins) are held in
    test_sky_gradients_and_texels_match_jax."""
    _, t = pair(2)
    target = GRAD_TARGET
    fused = jax_refs["fused"]
    got = _port_grads(t, target, NAMES)
    live = _held(got, fused, NAMES)
    assert {"albedo", "emission"} <= set(live), live
    assert not got["mix_factor"].any()
    assert not np.asarray(fused["mix_factor"]).any()

    loss = TG.make_loss(t, target, W, H, seed=3, device="cpu")
    base = TG.extract_params(t, ["albedo", "emission"])
    gen = np.random.default_rng(2)
    v = {k: torch.tensor(gen.standard_normal(tuple(p.shape)),
                         dtype=torch.float32) for k, p in base.items()}
    ad = sum(float((torch.tensor(got[k]) * v[k]).sum()) for k in base)
    eps = 1e-3
    with torch.no_grad():
        fd = (loss({k: p + eps * v[k] for k, p in base.items()})
              - loss({k: p - eps * v[k] for k, p in base.items()})) / (2 * eps)
    assert abs(ad - float(fd)) <= 0.05 * abs(float(fd))


def test_sky_gradients_and_texels_match_jax(jax_refs):
    """The sky scene at depth 2: make_loss takes the two-pass route (JAX's
    fused kernel excludes sky maps; on the card #1 then #3), and its
    gradient in the scene leaves and in the sky's texels (JAX's through
    ``_env_finish``'s gather) lies within 5% of jax.grad's through JAX's
    two-pass kernels, on JAX's finite entries (its sphere centers' are NaN;
    the port's are 0: a path's radiance here is the albedos times a texel,
    piecewise constant in every direction); a central FD of the port's loss
    in the texel of largest gradient agrees within 5%."""
    _, t = pair(2, sky=True)
    target, names = GRAD_TARGET, SKY_NAMES
    want, want_sky = jax_refs["sky"]
    sky = t.background.image.clone().requires_grad_(True)
    ts = dataclasses.replace(t, background=dataclasses.replace(
        t.background, image=sky))
    params = {k: v.clone().requires_grad_(True)
              for k, v in TG.extract_params(ts, names).items()}
    loss = TG.make_loss(ts, target, W, H, seed=3, device="cpu")
    value = loss(params)
    value.backward()
    got = {k: p.grad.numpy() for k, p in params.items()}
    assert {"albedo", "emission"} <= set(_held(got, want, names))
    assert not got["sphere_center"].any()  # the texel is constant in d
    g, ref = sky.grad.numpy(), np.asarray(want_sky)
    assert np.abs(ref).max() > 0
    assert (np.abs(g - ref) <= 0.05 * np.abs(ref)
            + 1e-3 * np.abs(ref).max()).all()
    at = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 0.05

    def at_texel(d):
        img = t.background.image.clone()
        img[at] += d
        s = dataclasses.replace(t, background=dataclasses.replace(
            t.background, image=img))
        return float(TG.make_loss(s, target, W, H, seed=3, device="cpu")({}))

    with torch.no_grad():
        fd = (at_texel(eps) - at_texel(-eps)) / (2 * eps)
    assert abs(g[at] - fd) <= 0.05 * abs(fd)


# ------------------------------------------------------------------- CLI

def test_cli_routes_the_zoo_to_the_brute_kernels(tmp_path, capsys):
    """CLI ``info`` names #1's and #4's kExt variants for the zoo, with or
    without its BVH; ``render`` of the zoo built without its BVH (which
    raised naming ROADMAP A5 before) writes its PNG."""
    d = json.load(open(ZOO))
    d["settings"]["enable_bvh_tree"] = False
    path = tmp_path / "zoo_nobvh.json"
    path.write_text(json.dumps(d))
    for scene in (ZOO, str(path)):
        assert cli.main(["info", scene]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["render_engine"] == ("brute: kernel #1 (mixes, volumes, "
                                         "isotropic variant)")
        assert info["fit_engine"].startswith("fused: kernel #4 (mixes")
    png = tmp_path / "zoo.png"
    assert cli.main(["render", str(path), "--width", "12", "--height", "8",
                     "--spp", "1", "--device", "cpu", "-o", str(png)]) == 0
    assert png.exists()


def test_plain_gradient_finite_at_a_zero_discriminant():
    """A zoo ray whose bounce meets a sphere's discriminant at exactly 0
    (ray 220306 at 600x400 spp 2, seed 13: tangent to the glass sphere
    after a free flight in the fog, found by chip_smoke.py phase 13 on the
    card): autograd through the plain version gives a finite gradient, 0
    in the masked root as the kernels' adjoint gives it (sqrt(max(disc,
    0)) alone would give 0/0 there, as jax.vjp does)."""
    scene = T.SceneBuilder.from_file(ZOO).build(with_bvh=False)
    ids, px, py = TK.prep_rays(torch.arange(600 * 400), 2, 600)
    at = slice(220306, 220307)
    fp = TK.pack_fparams(scene, 600, 400).detach().requires_grad_(True)
    rad = TK.radiance_plain(fp, TK.sphere_kinds(scene), trng.base_key(13),
                            ids[at], px[at], py[at],
                            **{**TK.scene_opts(scene), "max_depth": 8})
    (g,) = torch.autograd.grad(rad, fp, torch.ones_like(rad))
    assert rad.sum() > 0
    assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0
