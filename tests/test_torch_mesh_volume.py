"""The port's mesh-bounded volumes (fog inside a triangle mesh) on the CPU
against the JAX package: the JSON form, the build (each triangle's volume,
the surface tree without the boundary, ``mv_perm`` and ``mv_spans``), the
uniform columns, the renders, the record codes, the replay's gradient in
the phase material, the Normal view and the routing, through the plain
version of kernel #5's crossing scan (ops/bvh_kernel.py).

The scenes are copies of tests/test_mesh_volume.py::_mesh_vol_scene (a
12-triangle cube of fog beside two spheres) and of
tests/test_pallas_bvh_mixn.py::test_mix_mesh_volume_combo_on_kernel's (a
cube of fog whose material is a mix).  The JAX references run its packet
kernel in interpret mode (``engine="pallas_bvh"``), at 12x12 and below and
at depth 3 at most; a module fixture renders them once.  On the card the
CUDA kernels are held to the plain versions by tests/test_torch_gpu.py and
chip_smoke.py (phase 12).
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
from raytracingrust_tpu.models.mesh import Mesh as JMesh
from raytracingrust_tpu.ops import shade as JS
from raytracingrust_tpu.render.render import render_linear as j_render
from raytracingrust_tpu.utils import rng as jrng
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models import materials as TM
from raytracingrust_tpu_torch.models.backgrounds import Background as TBg
from raytracingrust_tpu_torch.models.convert import scene_from_arrays
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.models.scene import RenderSettings
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import fetch as F
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.ops.bvh import build_chunked_bvh
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import rng as trng
from test_torch_bvh_render import assert_within_jax_bounds
from test_torch_scene import assert_same_arrays, scene_arrays

W = H = 12
CUBE_FACES = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                       [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                       [1, 5, 7], [1, 7, 3]], np.int32)


def _mesh(mod):
    return JMesh if mod is J else TMesh


def cube(mod, center, half, material):
    """tests/test_mesh_volume.py::_cube_mesh."""
    h = float(half)
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)], np.float32) + np.asarray(center,
                                                              np.float32)
    return _mesh(mod).from_buffers(v, v, CUBE_FACES, material)


def icosphere(mod, center, radius, material, subdiv):
    """tests/test_mesh_volume.py::_icosphere: an octahedron subdivided
    ``subdiv`` times onto the sphere, 8 * 4^subdiv triangles."""
    verts = [np.asarray(v, np.float64) for v in (
        (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5),
             (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(subdiv):
        cache, new = {}, []

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new
    v = (np.asarray(verts, np.float32) * radius
         + np.asarray(center, np.float32))
    return _mesh(mod).from_buffers(v, v, np.asarray(faces, np.int32),
                                   material)


def fog_builder(mod, depth=3, density=2.0, spp=4):
    """tests/test_mesh_volume.py::_mesh_vol_scene: a cube of isotropic fog
    between a Lambertian and an emissive sphere."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 0, 1), (0, 0, -2), (0, 1, 0), 60.0, 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth)
    iso = b.add_material(mod.Isotropic((0.6, 0.7, 0.8)))
    lam = b.add_material(mod.Lambertian((0.7, 0.4, 0.3)))
    em = b.add_material(mod.Emission((2.0, 1.8, 1.5)))
    b.add_volume(b.add_mesh(cube(mod, (0, 0, -2), 0.5, iso)), density)
    b.add_sphere((1, 0, -2), 0.4, lam)
    b.add_sphere((-1, 0.8, -2), 0.3, em)
    return b


def combo_builder(mod, depth=3, spp=2):
    """test_mix_mesh_volume_combo_on_kernel's scene: a cube of fog whose
    material mixes two isotropic phases, and two spheres of a mix."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 1.5, 5), (0, 0, 0), (0, 1, 0), 55.0,
                                 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth)
    fog = b.add_material(mod.MixMaterial(mod.Isotropic((0.8, 0.8, 0.9)),
                                         mod.Isotropic((0.9, 0.5, 0.3)), 0.5))
    lam = b.add_material(mod.MixMaterial(mod.Lambertian((0.7, 0.3, 0.2)),
                                         mod.Metal((0.9, 0.9, 0.9), 0.1),
                                         0.4))
    b.add_volume(b.add_mesh(cube(mod, (0, 0, 0), 1.0, fog)), 0.9)
    b.add_sphere((0.0, 0.0, 0.0), 0.45, lam)
    b.add_sphere((1.8, 0.3, 0.0), 0.4, lam)
    return b


def sheet_fog_builder(mod):
    """A surface sheet of 32 triangles with two mesh volumes, an
    icosphere of 128 triangles and a cube, and a sphere: the surface tree
    and the boundary slots side by side."""
    b = mod.SceneBuilder()
    lam = b.add_material(mod.Lambertian((0.6, 0.5, 0.3)))
    iso = b.add_material(mod.Isotropic((0.8, 0.8, 0.9)))
    xs = np.linspace(-2, 2, 5, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, 0.2 * np.sin(gx) * gz, gz], -1).reshape(-1, 3)
    a = (np.arange(4)[:, None] * 5 + np.arange(4)[None, :]).reshape(-1)
    faces = np.stack([np.stack([a, a + 1, a + 5], 1),
                      np.stack([a + 1, a + 6, a + 5], 1)], 1).reshape(-1, 3)
    b.add_volume(b.add_mesh(icosphere(mod, (-0.3, 0.8, 0.2), 0.7, iso, 2)),
                 1.5)
    b.add_mesh(_mesh(mod).from_buffers(verts, verts, faces.astype(np.int32),
                                       lam))
    b.add_sphere((0.8, 1.2, 0.0), 0.4, lam)
    b.add_volume(b.add_mesh(cube(mod, (1.1, 0.6, -0.6), 0.35, iso)), 3.0)
    return b


def both(make, **kw):
    """(JAX scene, port scene) of one builder, each with its BVH."""
    return tuple(make(mod, **kw).build(with_bvh=True) for mod in (J, T))


def port_image(scene, w=W, h=H, seed=0):
    assert select_engine(scene) == "bvh"
    return render_linear(scene, w, h, seed=seed, device="cpu").numpy()


@pytest.fixture(scope="module")
def refs():
    """The fog scene at depth 1 and 3 (JAX, port), and the JAX packet
    kernel's images: depth 1 at seed 0, depth 3 at seeds 0 and 1."""
    scenes = {d: both(fog_builder, depth=d) for d in (1, 3)}
    images = {(d, s): np.asarray(j_render(scenes[d][0], W, H, seed=s,
                                          engine="pallas_bvh"))
              for d, s in ((1, 0), (3, 0), (3, 1))}
    return scenes, images


# ------------------------------------------------------ the scene model

def _write_cube_obj(path, center=(0.0, 0.0, -2.0), half=0.5):
    with open(path, "w") as f:
        for x in (-half, half):
            for y in (-half, half):
                for z in (-half, half):
                    f.write(f"v {x + center[0]} {y + center[1]} "
                            f"{z + center[2]}\n")
        for tri in CUBE_FACES + 1:
            f.write("f {} {} {}\n".format(*tri))


def _fog_json(tmp_path, density=2.0):
    """A JSON scene of the fog cube from an OBJ, as JAX writes it."""
    obj = str(tmp_path / "cube.obj")
    _write_cube_obj(obj)
    b = fog_builder(J, density=density)
    b.objects[0]["mesh"] = JMesh.from_file(obj, 0)
    return b.to_json()


def test_json_round_trip_equals_jax(tmp_path):
    """``{"type": "Volume", "boundary": {"type": "Mesh", ...}}`` loads, and
    the port writes back JAX's dict (less the boundary's ``smooth``, which
    the port reads and does not keep: tests/test_torch_bvh_build.py), which
    loads back to the same dict; the mesh volume table equals JAX's."""
    d = _fog_json(tmp_path)
    vol = d["objects"][0]
    assert vol["type"] == "Volume" and vol["boundary"]["type"] == "Mesh"
    b = T.SceneBuilder.from_json(json.loads(json.dumps(d)))
    got = b.to_json()
    want = json.loads(json.dumps(d))
    del want["objects"][0]["boundary"]["smooth"]
    assert got == want
    assert T.SceneBuilder.from_json(got).to_json() == got
    t = b.build(with_bvh=False)
    j = J.SceneBuilder.from_json(d).build(with_bvh=False)
    assert t.num_mesh_volumes == j.num_mesh_volumes == 1
    for name in ("neg_inv_density", "material"):
        np.testing.assert_array_equal(
            getattr(t.mesh_volumes, name).numpy(),
            np.asarray(getattr(j.mesh_volumes, name)))
    np.testing.assert_array_equal(t.triangles.volume.numpy(),
                                  np.asarray(j.triangles.volume))


def test_build_equals_jax():
    """Each triangle's volume ordinal, the surface tree (the boundary
    triangles left out), ``mv_perm`` and ``mv_spans`` equal the JAX
    build's arrays; so do the arrays ``scene_from_arrays`` carries across
    and the tree built from them."""
    j, t = both(sheet_fog_builder)
    cb, tc = j.cbvh, t.cbvh
    np.testing.assert_array_equal(t.triangles.volume.numpy(),
                                  np.asarray(j.triangles.volume))
    assert set(t.triangles.volume.tolist()) == {-1, 0, 1}
    np.testing.assert_array_equal(tc.triangles.nodes_f.reshape(-1),
                                  np.asarray(cb.tri_nodes_f))
    np.testing.assert_array_equal(tc.triangles.nodes_i.reshape(-1),
                                  np.asarray(cb.tri_nodes_i))
    np.testing.assert_array_equal(tc.triangles.perm, np.asarray(cb.tri_perm))
    np.testing.assert_array_equal(tc.mv_perm, np.asarray(cb.mv_perm))
    assert tc.mv_spans == tuple(cb.mv_spans) == ((0, 1), (1, 1))
    live = tc.triangles.perm[tc.triangles.perm >= 0]
    assert (t.triangles.volume.numpy()[live] == -1).all()

    keys = ("v0", "e1", "e2", "normal", "material", "volume")
    arrays = {k: np.asarray(v) for k, v in scene_arrays(j).items()}
    arrays.update({f"triangles.{k}": np.asarray(getattr(j.triangles, k))
                   for k in keys})
    arrays.update({f"mesh_volumes.{k}": np.asarray(getattr(j.mesh_volumes, k))
                   for k in ("neg_inv_density", "material")})
    via = scene_from_arrays(arrays, RenderSettings.from_json(
        j.settings.to_json()), j.background.kind)
    assert_same_arrays(scene_arrays(via), scene_arrays(t))
    for k in keys:
        np.testing.assert_array_equal(getattr(via.triangles, k).numpy(),
                                      getattr(t.triangles, k).numpy())
    via_cb = build_chunked_bvh(via.spheres, via.triangles)
    np.testing.assert_array_equal(via_cb.mv_perm, tc.mv_perm)
    assert via_cb.mv_spans == tc.mv_spans


@pytest.mark.parametrize("make", [fog_builder, combo_builder])
def test_uniform_columns_equal_jax(make):
    """A bounce draws the JAX number of columns (the mix coins, the lobe's
    four, one a volume; the mesh volumes' after the sphere volumes'), and
    the free-flight uniforms the scan reads are JAX's bit for bit."""
    j, t = both(make)
    sc = BK.pack(t, 4, 4, "cpu")
    _, n = sc.shade_cols()
    assert sc.n_mv == j.num_mesh_volumes == 1
    assert n == (JS.shade_uniforms(j.materials) + j.spheres.num_volumes
                 + j.num_mesh_volumes)
    key = trng.base_key(7)
    ids = torch.arange(0, 4096, 3, dtype=torch.int32)
    for b in (0, 2):
        _, _, u_vol = BK.bounce_uniforms(sc, key, ids, b)
        want = np.asarray(jrng.ray_uniforms(
            jnp.asarray(np.array(key, np.uint32)),
            jnp.asarray(ids.numpy()), 1 + b, n))[:, n - sc.n_mv:]
        np.testing.assert_array_equal(u_vol[:, sc.n_vol:].numpy(), want)


# ------------------------------------------------------ the renders

def test_render_depth1_within_2ulp(refs):
    """Primary visibility through the fog (the crossing scan, the free
    flight of the volume's own column) against the JAX packet kernel:
    within 2 ulp (measured 0)."""
    _, t = refs[0][1]
    got = port_image(t)
    want = refs[1][(1, 0)]
    assert (got > 0).any()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_render_depth3_within_jax_bounds(refs):
    """At depth 3: at most 8% of the channels outside atol 1e-4 + rtol 1e-3
    of the JAX packet kernel, and the mean abs diff no larger than 1.5
    times the JAX kernel's own seed-0-to-seed-1 mean abs diff
    (bench.py::run_parity's criterion; measured 0 channels and 0.0, the
    seed-to-seed 0.0256)."""
    _, t = refs[0][3]
    got = port_image(t)
    want, other = refs[1][(3, 0)], refs[1][(3, 1)]
    assert_within_jax_bounds(want, got, frac=0.08)
    assert np.abs(got - want).mean() <= 1.5 * np.abs(want - other).mean()


def test_record_codes_match_jax(refs):
    """The plain record walk's codes against the JAX record kernel's
    (interpret mode) at depth 3: fog winners coded ``mv_base + v`` after
    the sphere slots, equal on at least 95% of the live (ray, bounce)
    pairs, those whose ray the port still traces (measured: all 659).  The
    JAX kernel scans the fog for rays that have already ended too, and may
    record a winner for them where the port records -1 (the replay reads
    neither)."""
    j, t = refs[0][3]
    cb = j.cbvh
    depth, spp = 3, 4
    ray_ids, px, py, rows, n = PK._prep_rays(
        jnp.arange(W * H, dtype=jnp.int32), spp, W)
    mix, d_mix, m_pad = PK._mixn_cfg(j)
    run = PK._bvh_call(depth, PK._bvh_kinds(j), j.background.kind, False,
                       rows, True, cb.n_sph_chunks, cb.n_tri_chunks,
                       cb.sph_nodes, cb.tri_nodes,
                       n_vol_chunks=cb.n_vol_chunks, k_vol=cb.vol_nodes,
                       n_vol=j.spheres.num_volumes, record=True, mix=mix,
                       mv_spans=cb.mv_spans, d_mix=d_mix, m_pad=m_pad)
    fp, scal, tens = PK._bvh_prep(j, W, H, mix, cb.mv_spans, m_pad=m_pad)
    key = trng.base_key(3)
    words = jnp.asarray(np.array(key, np.uint32).view(np.int32))
    *_, rec = run(words, fp, scal, tens, ray_ids, px, py)
    want = np.asarray(PK._bvh_rec_flat(rec, rows, depth, n)).T
    ids, tpx, tpy = TK.prep_rays(torch.arange(W * H), spp, W)
    sc = BK.pack(t, W, H, "cpu")
    with torch.no_grad():
        _, got = BK.radiance_bvh_plain(sc, key, ids, tpx, tpy, record=True,
                                       max_depth=depth,
                                       bg_kind=t.background.kind, clay=False)
    got = got.numpy()
    fog = (got >= 0) & ((got & BK.REC_SLOT) == sc.mv_base)
    assert fog[0].any() and fog[1:].any()
    assert sc.mv_base == cb.n_sph_chunks * PK.BVH_LEAF
    # a ray is traced at bounce b if it scattered at every bounce before
    kind = F.fetch_rows_plain(torch.tensor(got), *BK.fetch_inputs(sc))[1]
    went_on = (torch.tensor(got) >= 0) & (kind != TM.EMISSION)
    live = torch.cat([torch.ones_like(went_on[:1]),
                      went_on[:-1].cumprod(dim=0).bool()]).numpy()
    assert (got == want)[live].mean() >= 0.95


def _albedo_loss(scene, row, w, h):
    """sum(image^2) as a function of material ``row``'s albedo, through
    the port's ``render_linear`` (the record walk, then the replay under
    autograd)."""
    def loss(albedo):
        mats = scene.materials
        al = torch.cat([mats.albedo[:row], albedo[None], mats.albedo[row + 1:]])
        s2 = dataclasses.replace(scene, materials=dataclasses.replace(
            mats, albedo=al))
        return (render_linear(s2, w, h, seed=0, device="cpu") ** 2).sum()
    return loss


@pytest.mark.parametrize("make", [fog_builder, combo_builder])
def test_phase_albedo_gradient_vs_jax_and_fd(make):
    """The gradient of sum(image^2) in the fog's phase albedo (its own row;
    in the combo a mix leaf's) through the port's replay: within 5% of
    jax.grad through the JAX packet kernel (its record walk and replay),
    and within 5% of the central difference of the port's own primal,
    on every channel the gradient moves (as
    tests/test_mesh_volume.py::test_mesh_volume_bvh_grad_fd)."""
    kw = dict(depth=3, density=4.0, spp=4) if make is fog_builder else \
        dict(depth=3)
    j, t = both(make, **kw)
    w = h = 10
    row = int(np.nonzero(np.asarray(j.materials.kind) == 4)[0][0])
    a0 = np.asarray(j.materials.albedo)[row].copy()

    def j_loss(albedo):
        mats = dataclasses.replace(
            j.materials, albedo=j.materials.albedo.at[row].set(albedo))
        img = j_render(dataclasses.replace(j, materials=mats), w, h, seed=0,
                       engine="pallas_bvh")
        return jnp.sum(img ** 2)

    want = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(a0)))
    loss = _albedo_loss(t, row, w, h)
    a = torch.tensor(a0, requires_grad=True)
    (got,) = torch.autograd.grad(loss(a), a)
    got = got.numpy()
    eps = 1e-3
    with torch.no_grad():
        fd = np.array([(loss(torch.tensor(a0) + eps * e).item()
                        - loss(torch.tensor(a0) - eps * e).item()) / (2 * eps)
                       for e in torch.eye(3)])
    assert np.abs(want).max() > 1e-3
    live = np.abs(want) > 1e-3 * np.abs(want).max()
    assert live.sum() >= 2
    np.testing.assert_allclose(got[live], want[live], rtol=0.05)
    np.testing.assert_allclose(got[live], fd[live], rtol=0.05)


def test_replay_forward_equals_walk():
    """The replay over the record walk's codes (the fog winners' t from the
    scan over detached rays) gives the walk's radiance bit for bit, on the
    two-volume scene and on the combo (raw fetch, the mix re-resolved)."""
    for make, spp in ((sheet_fog_builder, 2), (combo_builder, 2)):
        b = make(T)
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                         max_ray_depth=4)
        t = b.build(with_bvh=True)
        sc = BK.pack(t, 16, 12, "cpu")
        key = trng.base_key(4)
        ids, px, py = TK.prep_rays(torch.arange(16 * 12), spp, 16)
        opts = dict(max_depth=4, bg_kind=t.background.kind, clay=False)
        with torch.no_grad():
            rad, codes = BK.radiance_bvh_plain(sc, key, ids, px, py,
                                               record=True, **opts)
            again = BK.replay(sc, codes, key, 16 * 12, spp, 16, **opts)
        assert ((codes >= 0) & ((codes & BK.REC_SLOT) >= sc.mv_base)).any()
        np.testing.assert_array_equal(again.numpy(), rad.numpy())


def test_normal_view_vs_jax():
    """The Normal and Random views of the fog scene against the JAX packet
    kernel's debug views.  A fog hit shows its dummy normal (1, 0, 0)
    turned to face the ray: every pixel whose samples hit only the fog or
    nothing is within 2 ulp (measured 0).  A sphere hit's normal is
    normalized by 1 / sqrt here and by rsqrt in the JAX kernel
    (test_torch_sky_views.py::_check_view), up to 25 ulp apart on this
    frame: those pixels are held within 1e-5."""
    key = trng.base_key(0)
    for mode in ("Normal", "Random"):
        j, t = (fog_builder(mod, depth=1).build(with_bvh=True)
                for mod in (J, T))
        j = dataclasses.replace(j, settings=dataclasses.replace(
            j.settings, mode=mode))
        t = dataclasses.replace(t, settings=dataclasses.replace(
            t.settings, mode=mode))
        got = port_image(t).reshape(-1, 3)
        want = np.asarray(j_render(j, W, H, seed=0,
                                   engine="pallas_bvh")).reshape(-1, 3)
        sc = BK.pack(t, W, H, "cpu")
        spp = t.settings.samples_per_pixel
        ids, px, py = TK.prep_rays(torch.arange(W * H), spp, W)
        with torch.no_grad():
            _, codes = BK.radiance_bvh_plain(sc, key, ids, px, py,
                                             record=True, max_depth=1,
                                             bg_kind=t.background.kind,
                                             clay=False)
        code = codes[0].view(W * H, spp)
        sphere = ((code >= 0) & ((code & BK.REC_SLOT) < sc.mv_base)).any(1)
        fog = ((code & BK.REC_SLOT) == sc.mv_base) & (code >= 0)
        assert bool(fog.any()) and bool((~sphere).any())
        np.testing.assert_array_max_ulp(got[~sphere.numpy()],
                                        want[~sphere.numpy()], maxulp=2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------ routing, CLI

def test_routing():
    """A mesh-volume scene built with its BVH takes #5; the brute gate
    refuses it; without the BVH, with more than 4 mesh volumes or under
    HDRI importance sampling it raises naming ROADMAP A6 (the JAX package's
    XLA integrator)."""
    t = fog_builder(T).build(with_bvh=True)
    assert select_engine(t) == "bvh" and select_engine(t, grad=True) == "bvh"
    assert "mesh volumes" in TK.unsupported(t)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        select_engine(fog_builder(T).build(with_bvh=False))
    b = fog_builder(T)
    for i in range(4):
        b.add_volume(b.add_mesh(cube(T, (i - 2.0, 1.5, -3), 0.3, 0)), 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        select_engine(b.build(with_bvh=True))
    b = fog_builder(T)
    b.settings = dataclasses.replace(b.settings, env_importance_sampling=True)
    b.background = TBg.skymap_from_array(np.ones((4, 8, 3), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        select_engine(b.build(with_bvh=True))
    b.settings = dataclasses.replace(b.settings,
                                     env_importance_sampling=False)
    assert select_engine(b.build(with_bvh=True)) == "bvh"  # the sky variant


def test_cli_render_fit_info(tmp_path, capsys):
    """CLI ``info``, ``render`` and ``fit`` of a JSON scene with fog inside
    a mesh, on the CPU."""
    path = str(tmp_path / "fog.json")
    with open(path, "w") as f:
        json.dump(_fog_json(tmp_path), f)
    assert cli.main(["info", path]) == 0
    info = json.loads(capsys.readouterr().out)
    assert (info["mesh_volumes"], info["mesh_volume_triangles"]) == (1, 12)
    assert "crossing scan of 1 mesh volumes" in info["render_engine"]
    assert "record mode of #5" in info["fit_engine"]
    png = str(tmp_path / "fog.png")
    assert cli.main(["render", path, "--width", "10", "--height", "8",
                     "--spp", "2", "--device", "cpu", "-o", png]) == 0
    capsys.readouterr()
    assert cli.main(["fit", path, png, "--params", "albedo,emission",
                     "--steps", "2", "--spp", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split("final loss")[1].split()[0]))
