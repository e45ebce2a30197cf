"""The brute kernels' triangle branch on the CPU against the JAX package:
surface triangles in a scene built without its BVH, in the plain version
that kernels #1, #3 and #4 are held to on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 14).

The scenes (tests/test_torch_gpu.py::brute_tri_builder) are JAX's own
triangle scene of tests/test_pallas.py (a tetrahedron, a metal triangle, a
ground triangle, an emitter sphere), the same without the sphere, the
mini zoo of the kExt tests with a triangle of its mix material and an
isotropic triangle beside its fog sphere under its 16x32 sky, and the
600-triangle fan of test_pallas_triangle_chunking (two 512-triangle
chunks), each built in the JAX package and carried across with
models/convert.py.  The JAX references run ``pixel_radiance_pallas``, its
gradients and ``_tri_intersect`` in interpret mode under ``jax.jit``, at
8x6 spp 2 and depth 3 at most, lowered once in one module fixture.
"""

import dataclasses
import json
import types
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction

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
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import rng as trng
from test_torch_gpu import brute_tri_builder
from test_torch_scene import assert_takes_xla, scene_arrays

W, H, SPP = 8, 6, 2
# (builder name, sky): the scenes of the depth-1 checks
SCENES = {"tri": ("tri", False), "tri_only": ("tri_only", False),
          "zoo_sky": ("zoo", True), "fan": ("fan", False),
          "tri_grad": ("tri_grad", False), "tri_mix_sky": ("tri_mix", True)}
DEPTH1 = ["tri", "tri_only", "zoo_sky", "fan"]
GRAD_TARGET = np.random.default_rng(1).random((H, W, 3)).astype(np.float32)
# rays from above the fan towards it, and a weight for each ray's t
_gen = np.random.default_rng(4)
RAYS = (_gen.uniform((-0.5, 0.8, -1.5), (0.5, 1.6, -0.5), (96, 3)).T
        .astype(np.float32),
        _gen.uniform((-0.4, -1.0, -0.4), (0.4, -0.5, 0.4), (96, 3)).T
        .astype(np.float32))
RAY_W = _gen.standard_normal(96).astype(np.float32)
NAMES = ["albedo", "emission", "mix_factor", "sphere_center", "cam_lookfrom"]


def pair(scene, depth=3):
    """The scene in both packages, built without its BVH; the port's
    carried across from the JAX one's arrays (models/convert.py), so both
    compute on the same float32 numbers."""
    name, sky = SCENES[scene]
    j = brute_tri_builder(J, name, depth, SPP, sky).build(with_bvh=False)
    arrays = scene_arrays(j)
    tris = j.triangles
    arrays.update({f"triangles.{k}": getattr(tris, k) for k in
                   ("v0", "e1", "e2", "normal", "material", "volume")})
    if sky:
        arrays.update({f"background.{k}": getattr(j.background, k)
                       for k in ("image", "cdf_rows", "cdf_cols")})
    t = scene_from_arrays(arrays,
                          brute_tri_builder(T, name, depth, SPP).settings,
                          j.background.kind)
    return j, t


def _words(seed):
    return jnp.asarray(np.array(trng.base_key(seed), np.uint32).view(
        np.int32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _primary(t):
    """The port's primary rays of the frame (bitwise JAX's, test_pallas
    camera checks): origin and direction, three (R,) tensors each."""
    ids, px, py = TK.prep_rays(torch.arange(W * H), SPP, W)
    return TK.camera_ray(TK.pack_fparams(t, W, H), trng.base_key(0), ids,
                         px, py)


def _o0(fn, *args):
    """``fn`` jitted and compiled at XLA's backend optimisation level 0 (the
    references' setting: each float32 operation as written), run."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0})(*args)


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
    the brute kernel's frame at depth 1 of every scene and at depth 3
    (seeds 0 and 1) of "tri" and "zoo_sky" (key (scene, depth, seed));
    ``_tri_intersect`` of every scene's triangles against the port's
    primary rays (key ("hit", scene)); jax.grad of "tri_grad"'s loss at
    depth 2 through the fused kernel ("fused"); and of "tri_mix_sky"'s
    through the two-pass kernels, in the scene leaves and the texels
    ("sky"); jax.grad of ``_tri_intersect``'s t in the origins and
    directions of numpy-seeded rays against the fan ("t_vjp").  Each is
    compiled on a thread of its own as soon as it is lowered, at XLA's
    backend optimisation level 0, which keeps every float32 operation as
    written (no contraction into fused multiply-adds; the dot stays a
    chain of them)."""
    jobs = {}
    for scene in DEPTH1:
        for depth in ((1, 3) if scene in ("tri", "zoo_sky") else (1,)):
            j, t = pair(scene, depth)
            fn = jax.jit(lambda s, w, j=j: PK.pixel_radiance_pallas(
                s, jnp.arange(W * H, dtype=jnp.int32), W, H, w,
                sphere_kinds=PK._sphere_kinds(j), tri_kinds=PK._tri_kinds(j),
                interpret=True))
            for seed in ((0, 1) if depth == 3 else (0,)):
                jobs[scene, depth, seed] = (fn, (j, _words(seed)))
        tb = PK._tri_sizes(len(j.triangles))[0]
        o, d = _primary(t)

        def hit(s, o, d, tb=tb, mix=bool(j.materials.has_mix)):
            ops = PK._pack_tri(s, tb, mix=mix)
            tt, par, _ = PK._tri_intersect(ops[0], ops[1], tb, *o, *d)
            return tt, jnp.stack(par)
        jobs["hit", scene] = (jax.jit(hit), (
            j, *([jnp.asarray(v.numpy()[None]) for v in w] for w in (o, d))))
    j, _ = pair("fan", 1)
    tb = PK._tri_sizes(len(j.triangles))[0]

    def t_vjp(s, o, d):
        """d(sum of w t over the hits)/d(o, d) of _tri_intersect's t."""
        def f(o, d):
            c, sm = PK._pack_tri(s, tb)
            tt = PK._tri_intersect(c, sm, tb, *o, *d)[0]
            return jnp.sum(jnp.where(jnp.isfinite(tt), tt * RAY_W, 0.0))
        return jax.grad(f, argnums=(0, 1))(o, d)
    jobs["t_vjp"] = (jax.jit(t_vjp), (j, *([jnp.asarray(v[None])
                                           for v in w] for w in RAYS)))
    j, _ = pair("tri_grad", 2)
    jobs["fused"] = (jax.jit(jax.grad(JG.make_loss(
        j, GRAD_TARGET, W, H, seed=3, engine="pallas"))),
        (JG.extract_params(j, NAMES),))
    j, _ = pair("tri_mix_sky", 2)
    jobs["sky"] = (jax.jit(jax.grad(_sky_loss(j), argnums=(0, 1))),
                   (JG.extract_params(j, NAMES), j.background.image))
    opts = {"xla_backend_optimization_level": 0}
    with ThreadPoolExecutor(len(jobs)) as ex:
        # the costliest compiles start first, each as soon as it is lowered
        compiled = {k: ex.submit(fn.lower(*args).compile,
                                 compiler_options=opts)
                    for k, (fn, args) in sorted(
                        jobs.items(), key=lambda kv: kv[0] not in ("sky",
                                                                  "fused"))
                    if not (isinstance(k, tuple) and k[-1] == 1)}
        compiled = {k: v.result() for k, v in compiled.items()}
    out = {}
    for k, (_, args) in jobs.items():
        run = compiled[k if k in compiled else k[:-1] + (0,)]
        r = run(*args)
        if isinstance(k, tuple) and isinstance(k[1], int):
            out[k] = np.asarray(r).reshape(H, W, 3)
        elif k == "t_vjp":
            out[k] = [np.stack([np.asarray(v)[0] for v in g]) for g in r]
        elif k[0] == "hit":
            out[k] = tuple(np.asarray(v)[..., 0, :] if v.ndim == 3
                           else np.asarray(v)[0] for v in r)
        else:
            out[k] = r
    return out


# ------------------------------------------------ the fused multiply-add

def _rn32(q: Fraction) -> np.float32:
    """The float32 nearest the rational ``q``, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma_chain_rounds_once():
    """The plain version's fused multiply-add (``_fma_chain``) rounds
    c * x + acc once to float32: on 2,000 numpy-seeded triples against the
    exact rational sum rounded to nearest even; and on a constructed sum
    just below a float32 midpoint, which float64 rounds onto the midpoint
    and the cast would then round to even the wrong way: the cheap step
    marks it, the exact one rounds it right."""
    gen = np.random.default_rng(7)
    c, x, acc = (gen.standard_normal(2000).astype(np.float32)
                 * np.float32(2.0) ** gen.integers(-30, 30, 2000)
                 .astype(np.float32) for _ in range(3))
    want = np.array([_rn32(Fraction(float(a)) * Fraction(float(b))
                           + Fraction(float(s)))
                     for a, b, s in zip(c, x, acc)], np.float32)
    c64, x64 = (torch.tensor(v).double() for v in (c, x))
    got, _ = TK._fma_chain([(c64 * 0 + 1, torch.tensor(acc).double()),
                            (c64, x64)], exact=True)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # 2^30 + 128 + 64 - 2^-40: just below the midpoint 2^30 + 192
    c = torch.tensor([64 * (1 + 2.0 ** -23)], dtype=torch.float64)
    x = torch.tensor([1 - 2.0 ** -23], dtype=torch.float64)
    base = torch.tensor([2.0 ** 30 + 128], dtype=torch.float64)
    cheap, risky = TK._fma_chain([(base, torch.ones(1).double()), (c, x)])
    exact, _ = TK._fma_chain([(base, torch.ones(1).double()), (c, x)],
                             exact=True)
    assert bool(risky.all()) and float(cheap) == 2.0 ** 30 + 256
    assert float(exact) == 2.0 ** 30 + 128


# ---------------------------------------------------- packing and routing

@pytest.mark.parametrize("scene", ["tri", "zoo_sky", "fan"])
def test_pack_tri_equals_jax(scene):
    """``pack_tri``'s coefficients equal the rows of JAX ``_pack_tri``'s C
    matrix (-n; v0 x e2 and e2; -(v0 x e1) and -e1; n and -v0 . n) and its
    flat normal S's ``_TS_NRM`` rows; each triangle's slot row at the end
    of ``pack_fparams`` equals its S material rows (and S2's under mixes),
    its slot's kinds S's (and S2's) kind one-hot rows; the head and the
    spheres equal JAX ``_pack_fparams``'s, and its camera basis within 2
    ulp (PyTorch's and XLA's CPU tan round tan(30 degrees) an ulp apart).
    JAX's packing is compiled as the references are (:func:`_o0`: eagerly,
    jnp.cross would contract its products into fused multiply-adds)."""
    j, t = pair(scene)
    mix = bool(j.materials.has_mix)
    n_tri = len(j.triangles)
    tb = PK._tri_sizes(n_tri)[0]
    ops = [np.asarray(m) for m in _o0(
        lambda s: PK._pack_tri(s, tb, mix=mix), j)]
    c_mat, s_mat = ops[0], ops[1][:, :n_tri]
    secs = [np.concatenate([c_mat[:, (4 * c + k) * tb:(4 * c + k + 1) * tb]
                            for c in range(c_mat.shape[1] // (4 * tb))],
                           axis=1)[:, :n_tri] for k in range(4)]
    g = TK.pack_tri(t).numpy()
    assert g.shape == (n_tri, TK.TRI_COLS)
    want = np.concatenate([-secs[0][0:3], secs[1][0:6], -secs[2][0:6],
                           -secs[3][9:10], s_mat[0:3]]).T
    np.testing.assert_array_equal(g[:, :19], want)
    np.testing.assert_array_equal(secs[3][6:9], -secs[0][0:3])
    fp = TK.pack_fparams(t, W, H).numpy()
    head = np.asarray(_o0(lambda s: PK._pack_fparams(s, W, H, mix=mix), j))
    assert _ulps(fp[:12], head[:12]).max() <= 2
    np.testing.assert_array_equal(fp[12:head.size], head[12:])
    opts = TK.scene_opts(t)
    rows = fp[head.size:].reshape(opts["n_tm"], TK.tri_stride(mix))
    slot = g[:, TK._TSLOT].astype(np.int64)
    np.testing.assert_array_equal(rows[slot, :8], s_mat[3:11].T)
    kinds = TK.brute_kinds(t).numpy()[len(t.spheres):][slot]
    onehot = np.stack([kinds & 0xFF == k for k in range(5)])
    np.testing.assert_array_equal(onehot, s_mat[11:16] > 0.5)
    if mix:
        s2 = ops[2][:, :n_tri]
        np.testing.assert_array_equal(rows[slot, 8:], s2[0:9].T)
        np.testing.assert_array_equal(
            np.stack([kinds >> 8 == k for k in range(5)]), s2[9:14] > 0.5)
    assert opts["iso"] == (4 in PK._tri_kinds(j) or any(
        4 in (k if isinstance(k, tuple) else (k,))
        for k in PK._sphere_kinds(j)))


def _many(mod, n_tri, n_sph=0):
    b = mod.SceneBuilder()
    b.settings = mod.RenderSettings(samples_per_pixel=1, max_ray_depth=3,
                                    enable_bvh_tree=False)
    lam = b.add_material(mod.Lambertian((0.5, 0.5, 0.5)))
    v = np.zeros((3 * n_tri, 3), np.float32)
    v[:, 0] = np.arange(3 * n_tri) * 1e-3
    v[1::3, 1] = v[2::3, 2] = 1.0
    b.add_mesh(mod.models.mesh.Mesh.from_buffers(
        v, v, np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3), lam))
    for i in range(n_sph):
        b.add_sphere((0.1 * i, 0, -3), 0.04, lam)
    return b


def test_gate_and_routes_equal_jax(monkeypatch):
    """``unsupported`` admits each scene JAX ``supports`` admits, and the
    port's ``select_engine`` takes JAX's route on a TPU ("pallas" is
    "brute", "pallas_bvh" "bvh"), with and without the BVH; the one
    difference, 1,025 triangles without the BVH (JAX's XLA integrator),
    stays on the brute kernels up to MAX_TRIS, whose next triangle both
    refuse (the port then takes its generic engine, "xla").  A fit of a triangle scene
    without its BVH takes #3/#4 here (JAX's ``resolve_fit_engine`` sends it
    to XLA: Mosaic cannot compile the brute kernel's VJP)."""
    monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(
        platform="tpu")])
    names = {"pallas": "brute", "pallas_bvh": "bvh"}
    builders = {k: (lambda mod, k=k: brute_tri_builder(
        mod, SCENES[k][0], 3, SPP, SCENES[k][1])) for k in SCENES}
    builders["1025"] = lambda mod: _many(mod, 1025, n_sph=3)
    builders["8192"] = lambda mod: _many(mod, TK.MAX_TRIS)
    for name, make in builders.items():
        for bvh in (False, True):
            j, t = make(J).build(with_bvh=bvh), make(T).build(with_bvh=bvh)
            assert PK.supports(j) and TK.unsupported(t) is None, name
            want = JR.select_engine(j, "auto")
            got = select_engine(t)
            if want == "xla":
                assert name in ("1025", "8192") and not bvh and got == "brute"
            else:
                assert got == names[want], (name, bvh)
            fit = "bvh" if bvh else "brute"
            assert select_engine(t, grad=True) == fit, (name, bvh)
    j, t = (_many(mod, TK.MAX_TRIS + 1).build(with_bvh=False)
            for mod in (J, T))
    assert not PK.supports(j)
    assert_takes_xla(t)


# ---------------------------------------------------------------- renders

@pytest.mark.parametrize("scene", DEPTH1)
def test_depth1_winners_and_image(jax_refs, scene):
    """On every primary ray of the frame the plain triangle test
    (``tri_closest``) finds JAX ``_tri_intersect``'s t bit for bit, and
    the winner's flat normal, material and kind rows are the ones JAX's
    one-hot matmul gathers; the depth-1 image (the emitter, the sky's
    texel, the background or 0, so the winner's class: triangle, sphere or
    miss) within 2 ulp of JAX's brute kernel (measured: 0)."""
    j, t = pair(scene, 1)
    o, d = _primary(t)
    t_tri, idx = TK.tri_closest(TK.pack_tri(t), o, d)
    want_t, want_par = jax_refs["hit", scene]
    np.testing.assert_array_equal(t_tri.numpy().view(np.int32),
                                  want_t.view(np.int32))
    hit = idx.numpy() >= 0
    assert hit.any() and (hit == np.isfinite(want_t)).all()
    g = TK.pack_tri(t).numpy()[idx.numpy()[hit]]
    np.testing.assert_array_equal(g[:, 16:19], want_par[0:3, hit].T)
    fp = TK.pack_fparams(t, W, H).numpy()
    mix = bool(j.materials.has_mix)
    rows = fp[fp.size - TK.scene_opts(t)["n_tm"] * TK.tri_stride(mix):]
    rows = rows.reshape(-1, TK.tri_stride(mix))[g[:, 19].astype(np.int64)]
    np.testing.assert_array_equal(rows[:, :8], want_par[3:11, hit].T)
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[scene, 1, 0]
    assert got.max() > 0
    assert _ulps(got, want).max() <= 2


@pytest.mark.parametrize("scene", ["tri", "zoo_sky"])
def test_render_depth3_within_run_parity(jax_refs, scene):
    """At depth 3 bench.py::run_parity's criterion: the mean abs diff from
    JAX's brute kernel within 1.5 times JAX's own seed-to-seed mean abs
    diff.  The share of channels outside atol 1e-4 + rtol 1e-3 is
    printed."""
    _, t = pair(scene, 3)
    got = render_linear(t, W, H, seed=0, device="cpu").numpy()
    want = jax_refs[scene, 3, 0]
    noise = np.abs(want - jax_refs[scene, 3, 1]).mean()
    out = ~np.isclose(got, want, atol=1e-4, rtol=1e-3)
    print(f"{scene}: {int(out.sum())} of {out.size} channels outside "
          f"atol 1e-4 + rtol 1e-3; mean abs diff {np.abs(got - want).mean()}"
          f" vs seed noise {noise}")
    assert np.abs(got - want).mean() <= 1.5 * noise


# -------------------------------------------------------------- gradients

def test_tri_t_gradient_equals_jax_vjp(jax_refs):
    """The winner's t (``tri_t``, which the plain version differentiates)
    on 96 numpy-seeded rays against the fan: its gradient in the rays'
    origins and directions, dt/do = n / a and dt/dd = -t n / a through
    the fused multiply-adds, within 1e-5 of jax.grad of
    ``_tri_intersect``'s t (the VJP of its matmul) on every coordinate."""
    _, t = pair("fan", 1)
    tri = TK.pack_tri(t)
    o = [torch.tensor(v).requires_grad_(True) for v in RAYS[0]]
    d = [torch.tensor(v).requires_grad_(True) for v in RAYS[1]]
    t_hit, idx = TK.tri_closest(tri, o, d)
    hit = idx >= 0
    assert int(hit.sum()) > 48
    tt = TK.tri_t(tri[idx.clamp(min=0)], o, d)
    assert torch.equal(tt[hit], t_hit[hit])
    (tt[hit] * torch.tensor(RAY_W)[hit]).sum().backward()
    for got, want in zip((o, d), jax_refs["t_vjp"]):
        got = torch.stack([v.grad for v in got]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _held(got, want, names):
    """Each entry within 5% of JAX's, with a floor of 1e-3 of the group's
    largest, on the entries JAX gives finite; -> the groups with a nonzero
    gradient."""
    live = []
    for k in names:
        g, ref = got[k], np.asarray(want[k])
        fin = np.isfinite(ref)
        assert np.isfinite(g).all(), k
        if not fin.any() or np.abs(ref[fin]).max() == 0:
            assert not g[fin].any(), k
            continue
        tol = 0.05 * np.abs(ref[fin]) + 1e-3 * np.abs(ref[fin]).max()
        assert (np.abs(g[fin] - ref[fin]) <= tol).all(), (k, g, ref)
        live.append(k)
    return live


def _fd_check(t, target, got, names):
    """A central FD of the port's own loss along a numpy-seeded direction
    in ``names`` agrees with the gradient ``got`` within 5%."""
    loss = TG.make_loss(t, target, W, H, seed=3, device="cpu")
    base = TG.extract_params(t, names)
    gen = np.random.default_rng(2)
    v = {k: torch.tensor(gen.standard_normal(tuple(p.shape)),
                         dtype=torch.float32) for k, p in base.items()}
    ad = sum(float((torch.tensor(got[k]) * v[k]).sum()) for k in base)
    eps = 1e-3
    with torch.no_grad():
        fd = (loss({k: p + eps * v[k] for k, p in base.items()})
              - loss({k: p - eps * v[k] for k, p in base.items()})) / (2 * eps)
    assert abs(ad - float(fd)) <= 0.05 * abs(float(fd))


def test_gradients_match_jax_fused_and_fd(jax_refs):
    """JAX's triangle scene with a metal sphere under a gradient background
    at 8x6 spp 2 depth 2: the port's make_loss gradient (the fused route,
    which #4 is held to on the card) and the two-pass one (render_linear,
    then the mean: #1 and #3 on the card), autograd through the plain
    version both, within 5% of jax.grad through JAX's fused kernel on its
    finite entries: the triangles' albedos through their material slots
    and the emitter's emission.  JAX's gradients in the metal sphere's
    center and the camera are NaN here (its sqrt(max(disc, 0)) under a
    direction-dependent background, ROADMAP C); a central FD of the port's
    loss along a numpy-seeded direction in albedo, emission, the sphere's
    center and the camera (through each triangle's t and the rays leaving
    it) agrees within 5%."""
    _, t = pair("tri_grad", 2)
    fused = jax_refs["fused"]
    _, got = TG.render_and_grad(t, GRAD_TARGET, NAMES, W, H, seed=3,
                                device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    assert {"albedo", "emission"} <= set(_held(got, fused, NAMES))
    assert got["sphere_center"].any() and got["cam_lookfrom"].any()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in TG.extract_params(t, NAMES).items()}
    img = render_linear(TG.apply_params(t, params), W, H, seed=3,
                        device="cpu")
    torch.mean((img - torch.tensor(GRAD_TARGET)) ** 2).backward()
    two = {k: np.zeros(p.shape, np.float32) if p.grad is None
           else p.grad.numpy() for k, p in params.items()}
    for k in NAMES:
        np.testing.assert_allclose(two[k], got[k], rtol=1e-4, atol=1e-7)
    _fd_check(t, GRAD_TARGET, got,
              ["albedo", "emission", "sphere_center", "cam_lookfrom"])


def test_sky_gradients_and_texels_match_jax(jax_refs):
    """JAX's triangle scene with a mix triangle under the sky at depth 2:
    make_loss takes the two-pass route (on the card #1, then #3's kExt +
    kSky + kTri variant), and its gradient in the scene leaves (the mix
    triangle's leaves through its slot; the mix factor's is 0 in both: the
    coin is a comparison) and in the sky's texels lies within 5% of
    jax.grad's through JAX's two-pass kernels on its finite entries; a
    central FD of the port's loss in albedo and emission agrees within
    5%."""
    _, t = pair("tri_mix_sky", 2)
    want, want_sky = jax_refs["sky"]
    sky = t.background.image.clone().requires_grad_(True)
    ts = dataclasses.replace(t, background=dataclasses.replace(
        t.background, image=sky))
    params = {k: v.clone().requires_grad_(True)
              for k, v in TG.extract_params(ts, NAMES).items()}
    TG.make_loss(ts, GRAD_TARGET, W, H, seed=3, device="cpu")(
        params).backward()
    got = {k: p.grad.numpy() for k, p in params.items()}
    assert {"albedo", "emission"} <= set(_held(got, want, NAMES))
    assert not got["mix_factor"].any()
    g, ref = sky.grad.numpy(), np.asarray(want_sky)
    assert np.abs(ref).max() > 0
    assert (np.abs(g - ref) <= 0.05 * np.abs(ref)
            + 1e-3 * np.abs(ref).max()).all()
    _fd_check(t, GRAD_TARGET, got, ["albedo", "emission"])


# ------------------------------------------------------------------- CLI

def test_cli_render_info_and_fit_without_bvh(tmp_path, capsys):
    """A JSON scene of a mesh and a sphere with ``"enable_bvh_tree":
    false``: CLI ``info`` names #1's and #4's triangle variants (the BVH
    kernel with the tree), ``render`` writes its PNG and ``fit`` runs on
    the CPU, its loss finite and falling."""
    obj = tmp_path / "tet.obj"
    obj.write_text("v 0 0 0\nv 0.6 0 0.1\nv 0.3 0 -0.5\nv 0.3 0.7 -0.1\n"
                   "f 1 2 4\nf 2 3 4\nf 3 1 4\nf 1 3 2\n")
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0, 0.6, 2.0), (0, 0.2, 0), (0, 1, 0), 60.0,
                               1.0)
    b.settings = T.RenderSettings(samples_per_pixel=2, max_ray_depth=3,
                                  enable_bvh_tree=False)
    b.add_mesh(T.models.mesh.Mesh.from_file(
        str(obj), b.add_material(T.Lambertian((0.7, 0.4, 0.2)))))
    b.add_sphere((1.2, 1.5, 0.5), 0.5,
                 b.add_material(T.Emission((2.0, 1.8, 1.5))))
    path = tmp_path / "tet.json"
    path.write_text(json.dumps(b.to_json()))
    assert cli.main(["info", str(path)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["triangles"] == 4
    assert info["render_engine"] == "brute: kernel #1 (triangles variant)"
    assert info["fit_engine"] == "fused: kernel #4 (triangles variant)"
    png = tmp_path / "tet.png"
    assert cli.main(["render", str(path), "--width", "12", "--height", "10",
                     "--device", "cpu", "-o", str(png)]) == 0
    target = tmp_path / "target.png"
    assert cli.main(["render", str(path), "--width", "12", "--height", "10",
                     "--device", "cpu", "--seed", "1", "-o",
                     str(target)]) == 0
    capsys.readouterr()
    assert cli.main(["fit", str(path), str(target), "--params",
                     "albedo,emission", "--steps", "3", "--device",
                     "cpu"]) == 0
    losses = [float(ln.split()[-1]) for ln in
              capsys.readouterr().out.splitlines()
              if ln.startswith(("step", "final"))]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
