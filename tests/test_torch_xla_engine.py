"""The port's generic engine ("xla": render/integrator.py, ops/intersect.py,
ops/shade.scatter, ops/traverse.py, the flat BVH) on the CPU against the
JAX package's XLA integrator.

Each module against its JAX counterpart on numpy-seeded inputs: the dense
intersector on spheres, sphere volumes, triangles and mesh volumes; the
flat BVH from ``scene_from_arrays``; the flat BVH's walk on 300 spheres;
``scatter`` lobe by lobe and in Clay mode.  Then the scenes the kernels
refuse, each on the "xla" route against JAX ``render_linear(engine="xla")``
at depth 1 and 3, and a gradient against ``jax.grad`` of JAX
``make_loss(engine="xla")`` and a finite difference of the port's primal.

A module fixture lowers every JAX reference under ``jax.jit`` and compiles
them together on threads at XLA's backend optimisation level 0, which
computes the all-pairs dot products as x + y + z, as the port does (above
it XLA fuses them into multiply-adds); it runs each once.  Frames are at
most 24x16, spp 2, depth 3.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import jax
import jax.numpy as jnp
import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.diff import grad as JG
from raytracingrust_tpu.ops import intersect as JI
from raytracingrust_tpu.ops import shade as JS
from raytracingrust_tpu.ops import traverse as JT
from raytracingrust_tpu.render import render as JR
from raytracingrust_tpu.utils import aabb as JA
from raytracingrust_tpu.utils import rng as jrng
from raytracingrust_tpu.utils import vec as JV
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models import materials as TM
from raytracingrust_tpu_torch.models.convert import scene_from_arrays
from raytracingrust_tpu_torch.models.scene import RenderSettings
from raytracingrust_tpu_torch.ops import intersect as TI
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.ops import shade as TS
from raytracingrust_tpu_torch.ops import traverse as TT
from raytracingrust_tpu_torch.render import integrator as TIN
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    resolve_engine,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import aabb as TA
from raytracingrust_tpu_torch.utils import rng as trng
from raytracingrust_tpu_torch.utils import vec as TV
from test_torch_env import sun_sky
from test_torch_mesh_volume import cube
from test_torch_scene import assert_takes_xla, scene_arrays

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "benchmark.json")
W, H = 24, 16
SEED = 5
N_RAYS = 2048


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _ulps_at(got, want, floor):
    """|got - want| in ulps of max(|want|, floor): the error of a value
    whose operands were of magnitude ``floor`` (a unit vector's 1, a point
    of these scenes' few units), which a sum that cancels (a normal plus a
    sphere sample, a root's -b - sqrt(disc)) keeps while the result's own
    ulp shrinks."""
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want), np.float32(floor))
    return np.abs(np.asarray(got, np.float64) - want) / np.spacing(scale)


# ---------------------------------------------------------------- scenes

def prims_builder(mod):
    """Solid spheres, two sphere volumes, a surface sheet of 8 triangles
    and two cubes of fog (mesh volumes): every column of the dense scan."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 1, 5), (0, 0, 0), (0, 1, 0), 50.0, 1.5)
    lam = b.add_material(mod.Lambertian((0.7, 0.5, 0.3)))
    iso = b.add_material(mod.Isotropic((0.8, 0.8, 0.9)))
    gen = np.random.default_rng(1)
    for c, r in zip(gen.uniform(-2, 2, (6, 3)), gen.uniform(0.2, 0.6, 6)):
        b.add_sphere(tuple(c), float(r), lam)
    b.add_volume(b.add_sphere((0.5, 0.2, 0.4), 0.7, iso), 1.5)
    b.add_volume(b.add_sphere((-1.0, -0.5, 0.0), 0.5, iso), 3.0)
    xs = np.linspace(-3, 3, 3, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, -1.2 + 0.1 * gx * gz, gz], -1).reshape(-1, 3)
    a = np.array([0, 1, 3, 4])
    faces = np.stack([np.stack([a, a + 1, a + 3], 1),
                      np.stack([a + 1, a + 4, a + 3], 1)], 1).reshape(-1, 3)
    mesh = J.Mesh if mod is J else T.models.mesh.Mesh
    b.add_mesh(mesh.from_buffers(verts, verts, faces.astype(np.int32), lam))
    b.add_volume(b.add_mesh(cube(mod, (1.2, 0.0, -0.5), 0.6, iso)), 2.0)
    b.add_volume(b.add_mesh(cube(mod, (-1.5, 0.8, 0.5), 0.5, iso)), 0.8)
    return b


def crowd_builder(mod, depth=1, mode="Full"):
    """130 spheres (more than the brute kernels' 128) on a ground sphere,
    nine of them fog (more than the BVH kernel's 8 volumes), mixes nested
    five deep (deeper than a hit resolves) and one level deep, every lobe,
    a gradient background."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 2.5, 7), (0, 0.3, 0), (0, 1, 0), 45.0,
                                 1.5)
    b.settings = mod.RenderSettings(samples_per_pixel=2, max_ray_depth=depth,
                                    enable_bvh_tree=False, mode=mode)
    b.background = mod.Background.gradient((0.9, 0.95, 1.0), (0.4, 0.5, 0.8))
    deep = mod.Lambertian((0.2, 0.6, 0.3))
    for k in range(5):
        deep = mod.MixMaterial(deep, mod.Metal((0.9, 0.8, 0.7), 0.05 * k),
                               0.3 + 0.1 * k)
    mats = [b.add_material(m) for m in (
        mod.Lambertian((0.5, 0.5, 0.5)), mod.Metal((0.8, 0.8, 0.9), 0.2),
        mod.Dielectric(1.5), mod.Emission((3.0, 2.5, 2.0)), deep,
        mod.MixMaterial(mod.Lambertian((0.8, 0.2, 0.2)),
                        mod.Dielectric(1.3), 0.5))]
    iso = b.add_material(mod.Isotropic((0.9, 0.9, 0.8)))
    b.add_sphere((0, -100.5, 0), 100.0, mats[0])
    gen = np.random.default_rng(2)
    xz = gen.uniform(-3.5, 3.5, (120, 2))
    for i, (x, z) in enumerate(xz):
        b.add_sphere((float(x), -0.35, float(z)), 0.15, mats[1 + i % 5])
    for i in range(9):
        b.add_volume(b.add_sphere((-3.2 + 0.8 * i, 0.2, -1.0), 0.3, iso),
                     1.0 + i)
    return b


def tri_builder(mod, depth=1, fog_env=True):
    """A sheet of 162 triangles, each of its own material (more than the
    brute kernels' 128 triangle materials), and two spheres; with
    ``fog_env`` two cubes of fog (mesh volumes, which the brute kernels
    refuse) under a sky map with HDRI importance sampling, whose shadow
    rays cross the fog."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 2.0, 5.5), (0, 0, 0), (0, 1, 0), 50.0,
                                 1.5)
    b.settings = mod.RenderSettings(samples_per_pixel=2, max_ray_depth=depth,
                                    enable_bvh_tree=False,
                                    env_importance_sampling=fog_env)
    if fog_env:
        b.background = mod.Background.skymap_from_array(sun_sky())
    gen = np.random.default_rng(3)
    n = 10
    xs = np.linspace(-3, 3, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, -0.8 + 0.15 * np.sin(gx + gz), gz],
                     -1).reshape(-1, 3).astype(np.float32)
    mesh = J.Mesh if mod is J else T.models.mesh.Mesh
    for i in range(n - 1):
        for k in range(n - 1):
            a = i * n + k
            for face in ((a, a + 1, a + n), (a + 1, a + n + 1, a + n)):
                m = b.add_material(
                    mod.Lambertian(tuple(gen.uniform(0.2, 0.9, 3)))
                    if len(b.materials) % 4 else
                    mod.Metal(tuple(gen.uniform(0.5, 0.9, 3)), 0.1))
                b.add_mesh(mesh.from_buffers(
                    verts, verts, np.asarray([face], np.int32), m))
    if fog_env:
        iso = b.add_material(mod.Isotropic((0.85, 0.85, 0.9)))
        for i in range(2):
            b.add_volume(b.add_mesh(cube(mod, (-1.2 + 2.4 * i, -0.2, -0.5),
                                         0.45, iso)), 1.5 + 0.5 * i)
    b.add_sphere((0.6, 0.0, 1.0), 0.5, b.add_material(mod.Dielectric(1.5)))
    b.add_sphere((-0.8, 0.1, 1.2), 0.4,
                 b.add_material(mod.Lambertian((0.7, 0.7, 0.2))))
    return b


def empty_builder(mod, depth=1):
    b = mod.SceneBuilder()
    b.settings = mod.RenderSettings(samples_per_pixel=2, max_ray_depth=depth)
    b.background = mod.Background.gradient((1.0, 0.9, 0.8), (0.2, 0.3, 0.6))
    b.add_material(mod.Lambertian((0.5, 0.5, 0.5)))
    return b


def grad_builder(mod):
    """Spheres of every lobe, a fog sphere and an emitter under a gradient
    background, at depth 2: the gradient's scene."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 1, 4), (0, 0, 0), (0, 1, 0), 45.0, 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=2, max_ray_depth=2,
                                    enable_bvh_tree=False)
    b.background = mod.Background.gradient((0.9, 0.9, 1.0), (0.5, 0.6, 0.9))
    lam = b.add_material(mod.Lambertian((0.6, 0.4, 0.3)))
    met = b.add_material(mod.Metal((0.8, 0.8, 0.7), 0.15))
    die = b.add_material(mod.Dielectric(1.5))
    em = b.add_material(mod.Emission((2.0, 1.8, 1.2)))
    iso = b.add_material(mod.Isotropic((0.7, 0.8, 0.9)))
    b.add_sphere((0, -100.5, 0), 100.0, lam)
    b.add_sphere((-0.8, 0.0, 0.0), 0.45, met)
    b.add_sphere((0.8, 0.0, 0.0), 0.45, die)
    b.add_sphere((0.0, 0.1, -0.6), 0.5, lam)
    b.add_sphere((0.0, 1.2, -0.5), 0.3, em)
    b.add_volume(b.add_sphere((0.0, -0.2, 0.8), 0.3, iso), 2.0)
    return b


CLASSES = {
    "crowd": (crowd_builder, 4),  # (builder, max ulp at depth 1)
    "tri_env": (tri_builder, 4),
    "empty": (empty_builder, 2),
}
VIEWS = ("Normal", "Random")
GRAD_NAMES = ("albedo", "sphere_center", "bg_color_a")
GW, GH = 10, 8


def _rays(n, seed):
    gen = np.random.default_rng(seed)
    o = gen.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[: n // 4] = gen.uniform(-0.5, 0.5, (n // 4, 3)) + [1.2, 0.0, -0.5]
    d = gen.standard_normal((n, 3)).astype(np.float32)
    return o, d


def _u_vol(n, cols, seed):
    return np.random.default_rng(seed).random((n, cols)).astype(np.float32)


def _shade_inputs(n=N_RAYS, seed=9):
    """A material table of every kind (with a mix, so the lobe columns
    shift by its 4 coins) and numpy-seeded hits on it."""
    mats = [m for m in (
        lambda mod: mod.Lambertian((0.7, 0.3, 0.2)),
        lambda mod: mod.Metal((0.9, 0.8, 0.7), 0.3),
        lambda mod: mod.Dielectric(1.45),
        lambda mod: mod.Emission((2.0, 1.5, 1.0)),
        lambda mod: mod.Isotropic((0.5, 0.6, 0.7)))]
    tables = {}
    for mod, key in ((J, "j"), (T, "t")):
        b = mod.SceneBuilder()
        for m in mats:
            b.add_material(m(mod))
        b.add_material(mod.MixMaterial(mats[0](mod), mats[1](mod), 0.5))
        b.add_sphere((0, 0, 0), 1.0, 0)
        tables[key] = b.build(with_bvh=False).materials
    gen = np.random.default_rng(seed)
    kinds = np.asarray(tables["t"].kind)
    mat_id = gen.integers(0, 5, n).astype(np.int32)  # the five leaves
    d_in = gen.standard_normal((n, 3)).astype(np.float32)
    nrm = gen.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = (d_in * nrm).sum(1) < 0
    nrm = np.where(front[:, None], nrm, -nrm).astype(np.float32)
    u = gen.random((n, 8)).astype(np.float32)
    u[:8, 4:6] = [[0.5, 0.0]] * 8  # a sphere sample opposite the normal
    assert kinds[5] == TM.MIX
    return tables, (mat_id, d_in, nrm, front, u)


def _jscene(make, **kw):
    return make(J, **kw).build(with_bvh=False)


def _tscene(make, **kw):
    return make(T, **kw).build(with_bvh=False)


def _image_job(j, w=W, h=H):
    return jax.jit(lambda s, key: JR.render_linear(s, w, h, key=key,
                                                   engine="xla"))


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference, lowered once and compiled together at XLA's
    backend optimisation level 0."""
    jobs = {}

    def add(name, fn, *args):
        jobs[name] = (jax.jit(fn).lower(*args), args)

    # the dense scan
    jp = prims_builder(J).build(with_bvh=False)
    o, d = _rays(N_RAYS, 4)
    nu = jp.spheres.num_volumes + jp.num_mesh_volumes
    add("brute", lambda o, d, u: JI.intersect_brute(jp, o, d, u),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(_u_vol(N_RAYS, nu, 5)))
    # the flat BVH's walk on 300 spheres
    js = bvh300(J)
    o3, d3 = _rays(N_RAYS, 6)
    add("walk", lambda o, d, u: JT.intersect_bvh(js, o, d, u),
        jnp.asarray(o3), jnp.asarray(d3),
        jnp.asarray(_u_vol(N_RAYS, js.spheres.num_volumes, 7)))
    # scatter
    tables, (mat_id, d_in, nrm, front, u) = _shade_inputs()
    for clay in (False, True):
        add(f"scatter{int(clay)}",
            lambda m, di, n, f, u, clay=clay: JS.scatter(
                tables["j"], m, di, n, f, u, clay=clay),
            *map(jnp.asarray, (mat_id, d_in, nrm, front, u)))
    # the former refusals at depth 1 and 3 (two keys), the views
    key0 = jnp.asarray(jrng.base_key(SEED))
    for name, (make, _) in CLASSES.items():
        for depth in (1, 3) if name != "empty" else (1,):
            j = _jscene(make, depth=depth)
            jobs[f"{name}{depth}"] = (_image_job(j).lower(j, key0), (j, key0))
    for mode in VIEWS:
        j = _jscene(crowd_builder, mode=mode)
        jobs[mode] = (_image_job(j).lower(j, key0), (j, key0))
    # the gradient
    jg = _jscene(grad_builder)
    target = jnp.asarray(np.random.default_rng(8).random(
        (GH, GW, 3)).astype(np.float32) * 0.5)
    add("grad", lambda p: jax.grad(JG.make_loss(
        jg, target, GW, GH, seed=SEED, engine="xla"))(p),
        JG.extract_params(jg, GRAD_NAMES))

    with ThreadPoolExecutor(len(jobs)) as ex:
        compiled = dict(zip(jobs, ex.map(
            lambda job: job[0].compile(compiler_options={
                "xla_backend_optimization_level": 0}), jobs.values())))
    out = {"target": np.asarray(target)}
    for name, fn in compiled.items():
        out[name] = jax.tree_util.tree_map(np.asarray, fn(*jobs[name][1]))
        if name[-1] == "3":  # the reference's own noise: a second key
            j = jobs[name][1][0]
            out[name + "_other"] = np.asarray(
                fn(j, jnp.asarray(jrng.base_key(SEED + 1))))
    return out


def bvh300(mod, with_bvh=True):
    """300 spheres on a shell and in a slab, two of them fog, for the flat
    BVH (more than BRUTE_FORCE_THRESHOLD primitives)."""
    b = mod.SceneBuilder()
    lam = b.add_material(mod.Lambertian((0.5, 0.5, 0.5)))
    iso = b.add_material(mod.Isotropic((0.8, 0.8, 0.8)))
    gen = np.random.default_rng(11)
    for c, r in zip(gen.uniform(-3, 3, (298, 3)), gen.uniform(0.05, 0.3, 298)):
        b.add_sphere(tuple(c), float(r), lam)
    b.add_volume(b.add_sphere((0.3, 0.2, 0.1), 0.8, iso), 2.0)
    b.add_volume(b.add_sphere((-1.0, 1.0, 0.5), 0.6, iso), 1.0)
    return b.build(with_bvh=with_bvh)


def _hit_of(hit):
    """A Hit of either package as numpy arrays by field."""
    return {k: np.asarray(getattr(hit, k)) for k in
            ("t", "prim", "material", "point", "normal", "front_face")}


# ------------------------------------------------------------ (a) modules

def test_helpers_against_jax():
    """``reflect``, ``refract``, ``near_zero``, ``length_squared``,
    ``unit_sphere_surface``, ``slab_hit``, the compensated |c|^2 - r^2,
    ``surround`` and ``reduce_surround`` against JAX's on numpy-seeded
    inputs: bit for bit, but for ``refract`` and the sphere sample, within
    1 ulp of 1 (:func:`_ulps_at`): PyTorch's CPU sqrt is an ulp off the
    rounded root on a small share of inputs (XLA's, and CUDA's, are
    rounded), and its cos and sin are other implementations than XLA's."""
    gen = np.random.default_rng(0)
    v, n = (gen.standard_normal((512, 3)).astype(np.float32)
            for _ in range(2))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    uv = v / np.linalg.norm(v, axis=1, keepdims=True)
    eta = gen.uniform(0.6, 1.6, 512).astype(np.float32)
    v[:4] = 1e-9
    u1, u2 = gen.random((2, 512)).astype(np.float32)
    lo = gen.uniform(-1, 0, (512, 3)).astype(np.float32)
    hi = lo + gen.uniform(0, 2, (512, 3)).astype(np.float32)
    inv = (1.0 / gen.standard_normal((512, 3))).astype(np.float32)
    tmax = gen.uniform(0, 5, 512).astype(np.float32)

    def jfn(v, n, uv, eta, u1, u2, lo, hi, inv, tmax):
        return (JV.reflect(v, n), JV.refract(uv, n, eta), JV.near_zero(v),
                JV.length_squared(v), jrng.unit_sphere_surface(u1, u2),
                JA.slab_hit(lo, hi, v, inv, 1e-5, tmax),
                JI._cc_rr_compensated(v * 50.0, eta * 40.0))

    args = (v, n, uv, eta, u1, u2, lo, hi, inv, tmax)
    want = jax.jit(jfn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    tv = [torch.tensor(a) for a in args]
    got = (TV.reflect(tv[0], tv[1]), TV.refract(tv[2], tv[1], tv[3]),
           TV.near_zero(tv[0]), TV.length_squared(tv[0]),
           trng.unit_sphere_surface(tv[4], tv[5]),
           TA.slab_hit(tv[6], tv[7], tv[0], tv[8], 1e-5, tv[9]),
           TI._cc_rr_compensated(tv[0] * 50.0, tv[3] * 40.0))
    # the host-side box helpers against JAX's numpy ones
    np.testing.assert_array_equal(TA.surround(lo, hi, -hi, -lo),
                                  JA.surround(lo, hi, -hi, -lo))
    for got_, want_ in zip(TA.reduce_surround(lo, hi),
                           JA.reduce_surround(lo, hi)):
        np.testing.assert_array_equal(got_, want_)
    assert [x.tolist() for x in TA.reduce_surround(lo[:0], hi[:0])] == [
        [0.0] * 3] * 2
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = [x for g in got for x in (g if isinstance(g, tuple) else (g,))]
    assert len(flat_w) == len(flat_g) == 9
    for i, (w_, g_) in enumerate(zip(flat_w, flat_g)):
        w_, g_ = np.asarray(w_), g_.numpy()
        if i in (1, 4):  # sqrt; the sphere sample's cos and sin
            assert _ulps_at(g_, w_, 1).max() <= 1, i
        else:
            np.testing.assert_array_equal(g_, w_, err_msg=str(i))


def test_intersect_brute_against_jax(jax_refs):
    """The dense scan over solid and volume spheres, a surface sheet and
    two mesh volumes: the same winner on every ray, its material and
    front face equal.  The all-pairs sums are x + y + z in both, so the
    winners agree; a 3-term sum in another order would move a near tie.
    t, the point and the normal within 2 ulp at the scene's scale
    (:func:`_ulps_at`, 4) where a solid or a triangle wins: PyTorch's CPU
    sqrt is an ulp off the rounded root on a small share of inputs, which
    the root's -b - sqrt(disc) keeps; within 4 ulp where a volume's free
    flight takes ``log`` (PyTorch's CPU log against XLA's, ROADMAP C)."""
    t = prims_builder(T).build(with_bvh=False)
    o, d = _rays(N_RAYS, 4)
    nu = t.spheres.num_volumes + t.num_mesh_volumes
    got = _hit_of(TI.intersect_brute(t, torch.tensor(o), torch.tensor(d),
                                     torch.tensor(_u_vol(N_RAYS, nu, 5))))
    want = _hit_of(jax_refs["brute"])
    np.testing.assert_array_equal(got["prim"], want["prim"])
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_array_equal(got["front_face"], want["front_face"])
    ns, nt = len(t.spheres), len(t.triangles)
    prim = got["prim"]
    vol = ((prim >= ns - t.spheres.num_volumes) & (prim < ns)) | (
        prim >= ns + nt)
    kinds = {"solid": (prim >= 0) & (prim < ns) & ~vol,
             "triangle": (prim >= ns) & (prim < ns + nt), "volume": vol}
    for name, sel in kinds.items():
        assert sel.sum() >= 20, name
        tol = 4 if name == "volume" else 2
        for k, floor in (("t", 4), ("point", 4), ("normal", 1)):
            err = _ulps_at(got[k][sel], want[k][sel], floor)
            assert err.max() <= tol, (name, k, err.max())
    assert (prim == -1).sum() >= 20
    assert np.isinf(got["t"][prim == -1]).all()


def test_flat_bvh_equals_jax():
    """The flat BVH built from ``scene_from_arrays``'s arrays (and by the
    port's builder) equals the JAX ``scene.bvh`` element for element: its
    boxes (taken from the rows, ``node_boxes``), leaves and links and its
    depth."""
    j = prims_builder(J).build(with_bvh=True)
    arrays = {k: np.asarray(v) for k, v in scene_arrays(j).items()}
    arrays.update({f"triangles.{k}": np.asarray(getattr(j.triangles, k))
                   for k in ("v0", "e1", "e2", "normal", "material",
                             "volume")})
    arrays.update({f"mesh_volumes.{k}": np.asarray(getattr(j.mesh_volumes,
                                                           k))
                   for k in ("neg_inv_density", "material")})
    via = scene_from_arrays(arrays, RenderSettings(), j.background.kind,
                            with_bvh=True)
    built = prims_builder(T).build(with_bvh=True)
    for t in (via, built):
        nodes = t.bvh.nodes(t)
        got = dict(zip(("node_min", "node_max"), TT.node_boxes(t, nodes)),
                   prim=nodes.prim, hit_link=nodes.hit_link,
                   miss_link=nodes.miss_link)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(j.bvh, k)))
        assert len(nodes.levels) + 1 == j.bvh.depth
        assert t.cbvh is not None
    assert scene_from_arrays(arrays, RenderSettings(),
                             j.background.kind).bvh is None


def test_intersect_bvh_against_brute_and_jax(jax_refs):
    """The flat BVH's walk on 300 spheres (two of them fog): the same
    winners and t as the port's dense scan bit for bit, and the same
    winners as JAX's walk with t within 2 ulp at the scene's scale where a
    solid sphere wins (the CPU sqrt), 4 where fog does (its ``log``)."""
    t = bvh300(T)
    assert TIN.uses_flat_bvh(t) and t.num_primitives == 300
    o, d = map(torch.tensor, _rays(N_RAYS, 6))
    u = torch.tensor(_u_vol(N_RAYS, t.spheres.num_volumes, 7))
    walk = _hit_of(TT.intersect_bvh(t, o, d, u))
    dense = _hit_of(TI.intersect_brute(t, o, d, u))
    for k in walk:
        np.testing.assert_array_equal(walk[k], dense[k], err_msg=k)
    want = _hit_of(jax_refs["walk"])
    np.testing.assert_array_equal(walk["prim"], want["prim"])
    hit = walk["prim"] >= 0
    assert hit.mean() > 0.3 and (walk["prim"] >= 298).sum() >= 10
    assert _ulps_at(walk["t"][hit], want["t"][hit], 4).max() <= 4
    solid = hit & (walk["prim"] < 298)
    assert _ulps_at(walk["t"][solid], want["t"][solid], 4).max() <= 2


def test_intersect_bvh_after_rows_move():
    """A fit moves sphere centres after the build: the walk's boxes follow
    the rows, so it picks the same winners and t as the dense scan bit
    for bit on the moved scene, among them hits on the moved spheres'
    parts outside their built boxes.  The tree is built on the first walk,
    from centres that require grad (a fit's leaves), and the moved walk's
    t carries a gradient to them."""
    t = bvh300(T)
    leaf = t.spheres.center.clone().requires_grad_(True)

    def at(center):
        return dataclasses.replace(t, spheres=dataclasses.replace(
            t.spheres, center=center))

    o, d = map(torch.tensor, _rays(N_RAYS, 6))
    u = torch.tensor(_u_vol(N_RAYS, t.spheres.num_volumes, 7))
    TT.intersect_bvh(at(leaf), o[:8], d[:8], u[:8])  # builds the tree
    gen = np.random.default_rng(8)
    moved = gen.choice(298, 60, replace=False)
    step = torch.zeros_like(leaf)
    step[moved] = torch.tensor(gen.uniform(-1.5, 1.5, (60, 3)),
                               dtype=torch.float32)
    hit = TT.intersect_bvh(at(leaf + step), o, d, u)
    walk = _hit_of(dataclasses.replace(
        hit, t=hit.t.detach(), point=hit.point.detach(),
        normal=hit.normal.detach()))
    dense = _hit_of(TI.intersect_brute(at((leaf + step).detach()), o, d, u))
    for k in walk:
        np.testing.assert_array_equal(walk[k], dense[k], err_msg=k)
    assert np.isin(walk["prim"], moved).sum() >= 20
    hit.t[np.isfinite(walk["t"])].sum().backward()
    assert leaf.grad[moved].abs().sum() > 0


@pytest.mark.parametrize("lobe", ["Lambertian", "Metal", "Dielectric",
                                  "Emission", "Isotropic", "Clay"])
def test_scatter_against_jax(jax_refs, lobe):
    """``scatter`` on numpy-seeded hits, per lobe: the scatter flags equal,
    ``forced`` decisions taking the place of the comparisons,
    the attenuation and direction within 2 ulp of 1 (:func:`_ulps_at`:
    the sphere sample's sqrt, cos and sin, and XLA's normalization by its
    rsqrt, an approximation, where PyTorch divides by the rounded root; a
    sum such as the normal plus the sample cancels), 4 for the isotropic
    lobe, whose cbrt01 adds log and exp."""
    tables, (mat_id, d_in, nrm, front, u) = _shade_inputs()
    clay = lobe == "Clay"
    got = TS.scatter(tables["t"], torch.tensor(mat_id).long(),
                     torch.tensor(d_in), torch.tensor(nrm),
                     torch.tensor(front), torch.tensor(u), clay=clay)
    want = jax_refs[f"scatter{int(clay)}"]
    sel = np.ones_like(front) if clay else mat_id == getattr(
        TM, lobe.upper())
    assert sel.sum() >= 200
    np.testing.assert_array_equal(got[2].numpy()[sel], want[2][sel])
    tol = 4 if lobe == "Isotropic" else 2
    for g, w_ in zip(got[:2], want[:2]):
        assert _ulps_at(g.numpy()[sel], w_[sel], 1).max() <= tol
    if lobe in ("Metal", "Dielectric"):
        # recorded decisions replace the comparisons: the flipped ones
        # flip the lobe's scatter (Metal) or direction (Dielectric)
        name = "metal_ok" if lobe == "Metal" else "dielectric_reflect"
        flip = torch.ones(len(mat_id), dtype=torch.bool)
        forced = TS.scatter(tables["t"], torch.tensor(mat_id).long(),
                            torch.tensor(d_in), torch.tensor(nrm),
                            torch.tensor(front), torch.tensor(u),
                            forced={name: flip})
        if lobe == "Metal":
            assert forced[2].numpy()[sel].all()
            assert not np.array_equal(forced[2].numpy()[sel], want[2][sel])
        else:
            reflect = TV.reflect(TV.normalize(torch.tensor(d_in)),
                                 torch.tensor(nrm)).numpy()
            np.testing.assert_array_equal(forced[1].numpy()[sel],
                                          reflect[sel])


# ----------------------------------------------- (b) the former refusals

def test_former_refusals_take_xla():
    """Every scene the kernels refuse takes "xla", with and without a
    gradient asked (a view without); the triangles of more than 128
    materials alone take it for a fit, and a render of them raises (the
    JAX package renders them with its brute kernel, which #1 cannot take
    yet); ``engine="xla"`` forces the route on a scene the
    kernels take; an unknown engine or mode raises ValueError."""
    for make in (crowd_builder, tri_builder, empty_builder):
        t = _tscene(make)
        assert select_engine(t) == "xla"
        assert select_engine(t, grad=True) == "xla"
    mats = _tscene(tri_builder, fog_env=False)
    assert "more than 128 materials" in TK.unsupported(mats)
    with pytest.raises(NotImplementedError, match="brute kernel"):
        select_engine(mats)
    assert_takes_xla(mats, grad=True)
    for mode in VIEWS:
        assert select_engine(_tscene(crowd_builder, mode=mode)) == "xla"
    bench = T.SceneBuilder.from_file(BENCH).build()
    assert select_engine(bench) == "brute"
    assert resolve_engine(bench, "xla") == "xla"
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine(bench, "pallas")
    odd = dataclasses.replace(bench, settings=dataclasses.replace(
        bench.settings, mode="Sketch"))
    with pytest.raises(ValueError, match="unknown render mode"):
        select_engine(odd)


@pytest.mark.parametrize("name", list(CLASSES))
def test_render_depth1_against_jax(jax_refs, name):
    """Depth 1 on the "xla" route against JAX ``render_linear(engine=
    "xla")``: within 2 ulp at the radiance's scale (:func:`_ulps_at`, 1: a
    pixel's mean adds terms of about 1), 4 where a volume's free flight
    takes ``log`` (measured: the crowd within 0.5 of 1, 1 of its own ulp
    on 43 channels of 1,152; the triangles' one-sample MIS, whose sky
    sampler adds sin and cos, within 1 of 1, 5 of its own on one channel;
    the empty scene within 1 of its own on 2, the gradient's 1 / sqrt)."""
    make, tol = CLASSES[name]
    got = render_linear(_tscene(make), W, H, seed=SEED, device="cpu",
                        engine="xla").numpy()
    want = jax_refs[f"{name}1"]
    assert np.isfinite(got).all() and got.std() > 0
    assert _ulps_at(got, want, 1).max() <= tol


@pytest.mark.parametrize("name", ["crowd", "tri_env"])
def test_render_depth3_against_jax(jax_refs, name):
    """Depth 3 on the "xla" route: the mean abs diff from JAX's image at
    most 1.5 times JAX's own between two keys (bench.py::run_parity)."""
    make, _ = CLASSES[name]
    got = render_linear(_tscene(make, depth=3), W, H, seed=SEED,
                        device="cpu", engine="xla").numpy()
    want, other = jax_refs[f"{name}3"], jax_refs[f"{name}3_other"]
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() <= 1.5 * np.abs(want - other).mean()


@pytest.mark.parametrize("mode", VIEWS)
def test_views_against_jax(jax_refs, mode):
    """The Normal and Random views of the crowd, built without its BVH,
    within 2 ulp of JAX's (the Normal view's 1 / sqrt)."""
    got = render_linear(_tscene(crowd_builder, mode=mode), W, H, seed=SEED,
                        device="cpu").numpy()
    assert _ulps(got, jax_refs[mode]).max() <= 2


def test_gradient_against_jax_and_fd(jax_refs, monkeypatch):
    """``make_loss`` on the "xla" route, a backward a tile over several
    tiles (FIT_TILE_RAYS cut to 48 rays: 4 tiles of the 160): the gradient
    in albedo, sphere centres and the background within 5% of ``jax.grad``
    of JAX ``make_loss(engine="xla")`` (of each group's largest entry), and
    a directional finite difference of the port's own primal within 5%."""
    monkeypatch.setattr(TG, "FIT_TILE_RAYS", 48)
    t = _tscene(grad_builder)
    assert select_engine(t, grad=True) == "brute"  # forced below
    target = jax_refs["target"].copy()
    loss = TG.make_loss(t, target, GW, GH, seed=SEED, device="cpu",
                        engine="xla")
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in TG.extract_params(t, GRAD_NAMES).items()}
    value = loss(params)
    value.backward()
    want = jax_refs["grad"]
    for k in GRAD_NAMES:
        g, w_ = params[k].grad.numpy(), np.asarray(want[k])
        assert np.abs(w_).max() > 0 and np.isfinite(g).all(), k
        assert np.abs(g - w_).max() <= 0.05 * np.abs(w_).max(), k
    gen = np.random.default_rng(12)
    v = {k: torch.tensor(gen.standard_normal(tuple(p.shape)),
                         dtype=torch.float32) * (k != "sphere_center")
         for k, p in params.items()}
    ad = sum((params[k].grad * v[k]).sum().item() for k in params)
    eps = 1e-3
    with torch.no_grad():
        fd = (loss({k: p + eps * v[k] for k, p in params.items()})
              - loss({k: p - eps * v[k] for k, p in params.items()})
              ).item() / (2 * eps)
    assert abs(ad - fd) <= 0.05 * abs(fd)
