"""The port's volume, isotropic and mix path on the CPU against the JAX
package: scenes/material_zoo.json (47 spheres, one fog sphere of an
isotropic material, a single-level mix) and a scene of nested mixes over a
triangle sheet with a fog sphere, through the BVH kernel's plain version
(its volume tree, free flight, mix resolution and isotropic lobe), the
record codes, the replay and its gradient, ``make_loss``, the occlusion
test through fog, and the helpers they share (``cbrt01``,
``resolve_mix``, ``scene_from_arrays``).

On the CPU the port runs the plain versions; the CUDA kernels are held to
them on the card by tests/test_torch_gpu.py and chip_smoke.py.  The JAX
references run in interpret mode, under jax.jit or op by op, at 24x16 and
below and at depth 3 at most; a module fixture builds the zoo once.
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import raytracingrust_tpu as J
import raytracingrust_tpu.ops.pallas_megakernel as PK
from raytracingrust_tpu.diff import grad as JG
from raytracingrust_tpu.diff.replay import replay_radiance
from raytracingrust_tpu.models.mesh import Mesh as JMesh
from raytracingrust_tpu.ops import shade as JS
from raytracingrust_tpu.render.integrator import nee_stream
from raytracingrust_tpu.render.render import render_linear as j_render
from raytracingrust_tpu.utils import rng as jrng
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models import materials as TM
from raytracingrust_tpu_torch.models.convert import scene_from_arrays
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.models.scene import RenderSettings
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.ops import occlusion as OC
from raytracingrust_tpu_torch.ops.shade import resolve_mix
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)
from raytracingrust_tpu_torch.utils import rng as trng
from test_torch_bvh_render import assert_within_jax_bounds
from test_torch_scene import assert_same_arrays, scene_arrays

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "material_zoo.json")
W, H = 24, 16
SEED = 3


def zoo(mod, spp=2, depth=1):
    b = mod.SceneBuilder.from_file(ZOO)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                     max_ray_depth=depth)
    return b.build(with_bvh=True)


def mixn_builder(mod, depth=3):
    """tests/test_pallas_bvh_mixn.py::test_mixn_bvh_triangles_and_volume_
    match_xla's scene: mixes nested two deep on a 50-triangle sheet and a
    sphere, and a fog sphere of an isotropic material."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 2.5, 4), (0, 0, 0), (0, 1, 0), 55.0,
                                 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=1, max_ray_depth=depth)
    mm = b.add_material(mod.MixMaterial(
        mod.MixMaterial(mod.Lambertian((0.6, 0.5, 0.3)),
                        mod.Metal((0.9, 0.85, 0.8), 0.02), 0.35),
        mod.Emission((1.2, 1.0, 0.8)), 0.8))
    ms = b.add_material(mod.MixMaterial(
        mod.Emission((2.0, 1.8, 1.4)),
        mod.MixMaterial(mod.Lambertian((0.2, 0.3, 0.8)),
                        mod.Dielectric(1.33), 0.5), 0.5))
    n_side = 5
    xs = np.linspace(-2, 2, n_side + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.3 * np.sin(gx * 2.1) * np.cos(gz * 1.7)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(n_side):
        for j in range(n_side):
            a = i * (n_side + 1) + j
            bq, c = a + 1, a + (n_side + 1)
            faces.append([a, bq, c])
            faces.append([bq, c + 1, c])
    mesh = JMesh if mod is J else TMesh
    b.add_mesh(mesh.from_buffers(verts, verts, np.asarray(faces, np.int32),
                                 mm))
    b.add_sphere((0.6, 1.2, 0.0), 0.4, ms)
    iso = b.add_material(mod.Isotropic((0.7, 0.7, 0.9)))
    vi = b.add_sphere((-0.8, 0.6, 0.0), 0.5, iso)
    b.add_volume(vi, 0.8)
    return b


@pytest.fixture(scope="module")
def zoos():
    """(JAX, port) zoo scenes at depth 1 and 3, spp 2."""
    return {d: (zoo(J, depth=d), zoo(T, depth=d)) for d in (1, 3)}


def port_image(scene, w=W, h=H, seed=0):
    """The BVH route's image (the dispatch takes the zoo, a sphere scene
    of the brute kernels' size, to #1; the nested mixes to #5)."""
    assert select_engine(scene) in ("brute", "bvh")
    return render_linear(scene, w, h, seed=seed, device="cpu",
                         engine="bvh").numpy()


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ------------------------------------------------------- (a) the helpers

def test_cbrt01_and_resolve_mix_against_jax():
    """``resolve_mix`` is bit for bit JAX's on numpy-seeded ids and coins
    over the zoo's table (its mix and every other row).  ``cbrt01`` is
    JAX's formula, ``exp(log(max(u, 1e-38)) * (1/3))``, but PyTorch's CPU
    log and exp and XLA's CPU ones are different implementations, neither
    correctly rounded: on 200,000 uniforms they are at most 4 ulp apart
    (measured: 21% differ by 1 ulp, 0.1% by 2 to 4).  At u = 0 XLA's CPU
    flushes the subnormal 1e-38 to zero (cbrt01 = 0) where PyTorch keeps it
    (2.2e-13).  On the card the kernels and PyTorch share CUDA's logf and
    expf, which chip_smoke.py holds bit for bit."""
    u = np.random.default_rng(0).random(200_000).astype(np.float32)
    u[:2] = [0.0, 2.0 ** -23]
    want = np.asarray(jax.jit(jrng.cbrt01)(jnp.asarray(u)))
    # PyTorch's CPU log can be wrong on the first parallel call of a
    # process: one worker thread's chunk comes out up to ~1,500 ulp off,
    # in about one process in five; every later call is within 1 ulp.  So
    # the formula is held to JAX's on a second call, once a first has
    # started every thread.
    trng.cbrt01(torch.tensor(u))
    got = trng.cbrt01(torch.tensor(u)).numpy()
    ulps = _ulps(got[1:], want[1:])
    assert ulps.max() <= 4, ulps.max()
    assert (ulps > 0).mean() < 0.3
    assert want[0] == 0.0 and 0.0 < got[0] < 1e-12

    j, t = zoo(J), zoo(T)
    m = int(t.materials.kind.shape[0])
    gen = np.random.default_rng(1)
    ids = gen.integers(0, m, 4096).astype(np.int32)
    ids[:64] = int(np.nonzero(t.materials.kind.numpy() == TM.MIX)[0][0])
    coins = gen.random((4096, TM.MAX_MIX_DEPTH)).astype(np.float32)
    want = np.asarray(JS.resolve_mix(j.materials, jnp.asarray(ids),
                                     jnp.asarray(coins)))
    got = resolve_mix(t.materials, torch.tensor(ids),
                      torch.tensor(coins).unbind(-1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:64].tolist())) == 2  # both children picked


def test_scene_from_arrays_round_trips_the_zoo():
    """The zoo's arrays from the JAX scene (volume densities, the mix
    columns) build the port's scene, equal to the port's own loader."""
    j = J.SceneBuilder.from_file(ZOO).build(with_bvh=False)
    arrays = {k: np.asarray(v) for k, v in scene_arrays(j).items()}
    via = scene_from_arrays(arrays, RenderSettings.from_json(
        j.settings.to_json()), j.background.kind)
    loaded = T.SceneBuilder.from_file(ZOO).build()
    assert_same_arrays(scene_arrays(via), scene_arrays(loaded))
    assert via.spheres.num_volumes == 1 and via.materials.has_mix


def test_volume_tree_equals_jax():
    """The volume tree: nodes and slots equal the JAX ``vol_*`` fields, its
    slots global sphere rows, the ordinals row minus the solid spheres."""
    j, t = zoo(J), zoo(T)
    cb, tree = j.cbvh, t.cbvh.volumes
    np.testing.assert_array_equal(tree.nodes_f.reshape(-1),
                                  np.asarray(cb.vol_nodes_f))
    np.testing.assert_array_equal(tree.nodes_i.reshape(-1),
                                  np.asarray(cb.vol_nodes_i))
    np.testing.assert_array_equal(tree.perm, np.asarray(cb.vol_perm))
    sc = BK.pack(t, 8, 8, "cpu")
    n_solid = len(t.spheres) - t.spheres.num_volumes
    live = tree.perm >= 0
    np.testing.assert_array_equal(sc.volumes.ordinal.numpy()[live],
                                  tree.perm[live] - n_solid)
    assert (sc.volumes.nid.numpy()[live] < 0).all()
    assert sc.vol_base == cb.n_sph_chunks * PK.BVH_LEAF
    assert sc.tri_base == sc.vol_base + cb.n_vol_chunks * PK.BVH_LEAF


# ------------------------------------------------------- (b) the renders

@pytest.mark.parametrize("engine", ["xla", "pallas_bvh"])
def test_zoo_depth1_within_four_ulp(zoos, engine):
    """Primary visibility of the zoo (the fog sphere's free flight, the mix
    resolved at the hit, the gradient background) against both JAX
    engines: at most four ulp apart, as test_gradient_background_depth1_
    within_four_ulp (the background's 1/sqrt against rsqrt), measured 2."""
    j, t = zoos[1]
    got = port_image(t, seed=SEED)
    want = np.asarray(j_render(j, W, H, seed=SEED, engine=engine))
    assert (got > 0).any()
    np.testing.assert_array_max_ulp(got, want, maxulp=4)


def test_zoo_depth3_within_jax_bounds(zoos):
    """At depth 3 against the JAX packet kernel (interpret mode): the
    port's bounds, at most 0.08 of the channels flipped and a mean abs diff
    under 4e-2 (measured 0.044 and 0.0096 at seed 0).  Against the XLA
    engine the flipped share is JAX's own engine-to-engine share (0.135
    between its two engines here), so it is held to bench.py::run_parity's
    criterion: the mean abs diff within 1.5 times the XLA engine's own
    seed-to-seed mean abs diff (measured 0.0275 against 0.117)."""
    j, t = zoos[3]
    got = port_image(t)
    want = np.asarray(j_render(j, W, H, seed=0, engine="pallas_bvh"))
    assert_within_jax_bounds(want, got, frac=0.08)
    xa = np.asarray(j_render(j, W, H, seed=0, engine="xla"))
    xb = np.asarray(j_render(j, W, H, seed=1, engine="xla"))
    assert np.abs(got - xa).mean() <= 1.5 * np.abs(xa - xb).mean()


def test_nested_mixes_triangles_and_fog_vs_jax():
    """Mixes nested two deep on a triangle sheet and a sphere, with a fog
    sphere: the material table equal to JAX's array for array (a nested
    mix's children after it), at depth 1 within four ulp of the JAX packet
    kernel (interpret mode), at depth 3 within the port's bounds of it."""
    for depth in (1, 3):
        j, t = (mixn_builder(mod, depth).build(with_bvh=True)
                for mod in (J, T))
        assert PK._mix_depth(j) == 2 and t.spheres.num_volumes == 1
        for name in ("kind", "mix_first", "mix_second", "mix_factor",
                     "albedo", "emission", "ir", "fuzz"):
            np.testing.assert_array_equal(
                getattr(t.materials, name).numpy(),
                np.asarray(getattr(j.materials, name)), err_msg=name)
        got = port_image(t, 12, 12)
        want = np.asarray(j_render(j, 12, 12, seed=0, engine="pallas_bvh"))
        if depth == 1:
            np.testing.assert_array_max_ulp(got, want, maxulp=4)
        else:
            assert_within_jax_bounds(want, got, frac=0.08)


# ------------------------------------------------ (c) codes and gradients

def _words(seed=SEED):
    return jnp.asarray(np.array(trng.base_key(seed), np.uint32).view(
        np.int32))


def test_zoo_record_codes_match_jax(zoos):
    """The plain record walk's codes on the zoo (spp 2, depth 3) against
    the JAX record kernel's (interpret mode), volume span included (volume
    slots from the sphere tree's slot count).  Bounce 0 is equal bit for
    bit: solid and volume winners, front face, metal and dielectric
    decisions.  Deeper, the JAX kernel's packet leaf tests rays that have
    already ended, which may record a winner where the port records -1 (its
    replay ignores them), and a lobe's transcendental ulp may flip a path:
    at least 0.9 of all entries are equal (measured 0.957 at spp 1)."""
    j, t = zoos[3]
    cb = j.cbvh
    depth = 3
    ray_ids, px, py, rows, n = PK._prep_rays(
        jnp.arange(W * H, dtype=jnp.int32), 2, W)
    mix, d_mix, m_pad = PK._mixn_cfg(j)
    run = PK._bvh_call(depth, PK._bvh_kinds(j), j.background.kind, False,
                       rows, True, cb.n_sph_chunks, cb.n_tri_chunks,
                       cb.sph_nodes, cb.tri_nodes,
                       n_vol_chunks=cb.n_vol_chunks, k_vol=cb.vol_nodes,
                       n_vol=j.spheres.num_volumes, record=True, mix=mix,
                       d_mix=d_mix, m_pad=m_pad)
    fp, scal, tens = PK._bvh_prep(j, W, H, mix, (), m_pad=m_pad)
    *_, rec = run(_words(), fp, scal, tens, ray_ids, px, py)
    want = np.asarray(PK._bvh_rec_flat(rec, rows, depth, n)).T
    ids, tpx, tpy = TK.prep_rays(torch.arange(W * H), 2, W)
    sc = BK.pack(t, W, H, "cpu")
    with torch.no_grad():
        _, got = BK.radiance_bvh_plain(sc, trng.base_key(SEED), ids, tpx,
                                       tpy, record=True, max_depth=depth,
                                       bg_kind=t.background.kind,
                                       clay=False)
    got = got.numpy()
    slot = got & BK.REC_SLOT
    hit = got >= 0
    assert (hit[0] & (slot[0] >= sc.vol_base)).any()  # fog winners
    assert (hit[0] & (slot[0] < sc.vol_base)).any()  # solid winners
    for bit in (BK.REC_FRONT, BK.REC_METAL_OK, BK.REC_REFLECT):
        assert (hit & (got & bit != 0)).any()
    np.testing.assert_array_equal(got[0], want[0])
    assert (got == want).mean() >= 0.9


def test_zoo_replay_matches_jax(zoos):
    """The port's replay (plain fetch in raw mode, the mix re-resolved, the
    fog's free flight recomputed) on its own codes against JAX
    ``replay_radiance`` on the same codes, op by op, on the zoo at spp 2
    depth 3: radiance within atol 1e-5 on every ray, and the VJP of a
    numpy-seeded cotangent in every PARAM_PATHS leaf within rtol 1e-3 of
    each entry plus 1e-5 of the largest.  (Under jax.jit XLA's fused
    arithmetic moves a path that hits the mix sphere by 3e-5 of its
    radiance, and its center gradient by 1.5%; op by op the two replays
    agree bit for bit on those rays.)  The replay's forward equals the
    walk's radiance bit for bit."""
    j, t = zoos[3]
    ids, px, py = TK.prep_rays(torch.arange(W * H), 2, W)
    opts = dict(max_depth=3, bg_kind=t.background.kind, clay=False)
    sc0 = BK.pack(t, W, H, "cpu")
    with torch.no_grad():
        rad, codes = BK.radiance_bvh_plain(sc0, trng.base_key(SEED), ids,
                                           px, py, record=True, **opts)
        again = BK.replay(sc0, codes, trng.base_key(SEED), W * H, 2, W,
                          **opts)
    np.testing.assert_array_equal(again.numpy(), rad.numpy())
    n = rad.shape[0]
    cts = np.random.default_rng(0).standard_normal((n, 3)).astype(
        np.float32)
    jids, jpx, jpy, *_ = PK._prep_rays(jnp.arange(W * H, dtype=jnp.int32),
                                       2, W)
    flat = lambda v: jnp.asarray(v).reshape(-1)[:n]
    rec = jnp.asarray(codes.numpy().T)
    want, vjp = jax.vjp(lambda s: replay_radiance(
        s, rec, _words(), flat(jids), flat(jpx), flat(jpy), W, H), j)
    (d_scene,) = vjp(jnp.asarray(cts))
    params = {k: v.clone().requires_grad_(True) for k, v in
              TG.extract_params(t, list(TG.PARAM_PATHS)).items()}
    sc = BK.pack(TG.apply_params(t, params), W, H, "cpu")
    got = BK.replay(sc, codes, trng.base_key(SEED), W * H, 2, W, **opts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    want_grads = JG.extract_params(d_scene, list(TG.PARAM_PATHS))
    grads = torch.autograd.grad(got, list(params.values()), torch.tensor(cts),
                                allow_unused=True)
    live = 0
    for (k, p), g in zip(params.items(), grads):
        g = np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
        ref = np.asarray(want_grads[k])
        assert np.isfinite(g).all(), k
        tol = 1e-3 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert (np.abs(g - ref) <= tol).all(), (k, g, ref)
        live += bool(np.abs(ref).max() > 0)
    assert live >= 8
    # the fog sphere (the last sphere row) moves the radiance
    assert np.abs(np.asarray(want_grads["sphere_center"])[-1]).max() > 0


def test_zoo_make_loss_matches_jax_pallas_bvh():
    """Port ``make_loss`` gradients on the zoo (16x12 spp 1 depth 2) in the
    albedos (the mix's two leaves and the fog's phase material among them),
    emissions and every sphere's center and radius against jax.grad of JAX ``make_loss(engine="pallas_bvh")``
    (its record kernel in interpret mode, then its gather replay): within
    rtol 1e-3 of each entry plus 1e-5 of the largest, on JAX's finite
    entries (all of them here).  A pixel whose radiance differs between the
    two forwards by more than 1e-4 (a path flipped by a transcendental's
    ulp; 5 of 192) is left out of both losses: its target is each
    package's own render there."""
    w, h = 16, 12
    j, t = (zoo(mod, spp=1, depth=2) for mod in (J, T))
    names = ["albedo", "emission", "sphere_center", "sphere_radius"]
    target = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    img_j = np.asarray(j_render(j, w, h, seed=SEED, engine="pallas_bvh"))
    img_t = port_image(t, w, h, seed=SEED)
    flip = (np.abs(img_j - img_t) > 1e-4).any(-1)
    assert flip.sum() <= 8, flip.sum()
    want = jax.jit(jax.grad(JG.make_loss(
        j, np.where(flip[..., None], img_j, target), w, h, seed=SEED,
        engine="pallas_bvh")))(JG.extract_params(j, names))
    _, got = TG.render_and_grad(t, np.where(flip[..., None], img_t, target),
                                names, w, h, seed=SEED, device="cpu",
                                engine="bvh")
    for k in names:
        g, ref = got[k].numpy(), np.asarray(want[k])
        fin = np.isfinite(ref)
        assert np.isfinite(g).all() and np.abs(ref[fin]).max() > 0, k
        tol = 1e-3 * np.abs(ref[fin]) + 1e-5 * np.abs(ref[fin]).max()
        assert (np.abs(g[fin] - ref[fin]) <= tol).all(), k


# ------------------------------------------------------ (d) fog occlusion

def test_occluded_plain_through_fog_matches_jax_kernel():
    """``occluded_plain`` against the JAX occlusion kernel (interpret mode)
    on tests/test_env_is_kernel.py's fog scene: 128 seeded rays, each
    volume's free flight drawn from column 2 of the NEE stream by the ray's
    id; bit for bit, with rays blocked by the fog alone among them."""
    from raytracingrust_tpu.models.backgrounds import Background as JBg
    from raytracingrust_tpu_torch.models.backgrounds import Background as TBg

    sky = np.full((16, 32, 3), 0.05, np.float32)
    sky[2:4, 5:8] = 25.0
    scenes = []
    for mod, bg in ((J, JBg), (T, TBg)):
        b = mod.SceneBuilder()
        b.camera = mod.Camera.create((0, 1, 4), (0, 0.5, 0), (0, 1, 0),
                                     55.0, 1.0)
        b.settings = mod.RenderSettings(samples_per_pixel=1, max_ray_depth=3,
                                        env_importance_sampling=True)
        iso = b.add_material(mod.Isotropic((0.6, 0.6, 0.6)))
        lam = b.add_material(mod.Lambertian((0.7, 0.6, 0.5)))
        vi = b.add_sphere((0, 0.5, 0), 1.0, iso)
        b.add_volume(vi, 0.6)
        b.add_sphere((2, 0.5, 0), 0.4, lam)
        b.background = bg.skymap_from_array(sky)
        scenes.append(b.build(with_bvh=True))
    j, t = scenes
    assert select_engine(t) == "env"
    r = 128
    key = trng.base_key(5)
    gen = np.random.default_rng(9)
    o = gen.uniform(-2.0, 2.0, (r, 3)).astype(np.float32)
    d = gen.standard_normal((r, 3)).astype(np.float32)
    ids = np.arange(r, dtype=np.int32)
    stream = nee_stream(1, 3)
    want = np.asarray(PK.occlusion_bvh(
        j, jnp.asarray(o), jnp.asarray(d), stream,
        jnp.asarray(np.array(key, np.uint32).view(np.int32)),
        jnp.asarray(ids), interpret=True))
    sc = BK.pack(t, 8, 8, "cpu")
    args = (torch.tensor(o.T.copy()), torch.tensor(d.T.copy()))
    got = OC.occluded(sc, *args, torch.tensor(ids), key, stream).numpy()
    np.testing.assert_array_equal(got, want)
    solid = OC.occluded_plain(sc._replace(volumes=None), *args).numpy()
    assert want.any() and not want.all()
    assert (want & ~solid).any()  # blocked by the fog alone
