"""The port's BVH fit path on the CPU against the JAX package: the record
walk's codes, the replay, the fetch pair's plain versions, ``make_loss``
gradients, finite differences of the port's own loss and the CLI fit.

On the CPU the port runs the plain versions (the record walk of
ops/bvh_kernel.py, ops/fetch.py's gathers and ``index_add_``); the CUDA
kernels are held to them on the card by tests/test_torch_gpu.py.  The JAX
references run in interpret mode, whose compiles are slow, so the frames
are 12x10 and 12x12 at depth 2 and 3, and one scene serves three tests.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import jax
import jax.numpy as jnp
import numpy as np

import raytracingrust_tpu as J
import raytracingrust_tpu.ops.pallas_megakernel as PK
from raytracingrust_tpu.diff import grad as JG
from raytracingrust_tpu.diff.replay import replay_radiance
from raytracingrust_tpu.models.mesh import Mesh as JMesh
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import fetch as TF
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.utils import rng as trng
from test_torch_bvh_build import (STRESS, grid_builder, mesh_builder,
                                  sheet_buffers)

SEED = 3


def _words(seed=SEED):
    return jnp.asarray(np.array(trng.base_key(seed), np.uint32).view(
        np.int32))


def _pair(name, depth, gradient=False):
    """(JAX scene, port scene) with their BVH: "grid", the 216-sphere grid
    of four materials; "sheet", a 128-triangle sheet with a metal and an
    emissive sphere; "both", a 125-sphere grid with the sheet through it
    (a sphere tree and a triangle tree, every material kind).
    ``gradient``: a gradient background, which gives the geometry and the
    camera a gradient."""
    out = []
    for mod in (J, T):
        if name == "sheet":
            b = mesh_builder(mod, n_side=8, depth=depth, spp=1)
        else:
            b = grid_builder(mod, n=6 if name == "grid" else 5, depth=depth,
                             spp=1)
        if name == "both":
            verts, faces = sheet_buffers(8)
            b.add_mesh((JMesh if mod is J else TMesh).from_buffers(
                verts, verts, faces, 0))
        if gradient:
            b.background = mod.Background.gradient((0.9, 0.9, 1.0),
                                                   (0.4, 0.55, 0.9))
        out.append(b.build(with_bvh=True))
    return out


def _opts(scene):
    s = scene.settings
    return dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == "Clay")


def port_codes(scene, w, h, seed=SEED):
    """(radiance (R, 3), codes (depth, R)) of the plain record walk."""
    ids, px, py = TK.prep_rays(torch.arange(w * h),
                               scene.settings.samples_per_pixel, w)
    with torch.no_grad():
        return BK.radiance_bvh_plain(BK.pack(scene, w, h, "cpu"),
                                     trng.base_key(seed), ids, px, py,
                                     record=True, **_opts(scene))


def _jax_rays(scene, w, h):
    return PK._prep_rays(jnp.arange(w * h, dtype=jnp.int32),
                         scene.settings.samples_per_pixel, w)


def jax_codes(scene, w, h, seed=SEED):
    """(R, depth) codes of the JAX record kernel (interpret mode)."""
    cb = scene.cbvh
    depth = scene.settings.max_ray_depth
    ray_ids, px, py, rows, n = _jax_rays(scene, w, h)
    run = PK._bvh_call(depth, PK._bvh_kinds(scene), scene.background.kind,
                       False, rows, True, cb.n_sph_chunks, cb.n_tri_chunks,
                       cb.sph_nodes, cb.tri_nodes, record=True)
    fp, scal, tens = PK._bvh_prep(scene, w, h, False, ())
    *_, rec = run(_words(seed), fp, scal, tens, ray_ids, px, py)
    return np.asarray(PK._bvh_rec_flat(rec, rows, depth, n))


# ------------------------------------------------------- (a) the codes

def test_record_codes_match_jax():
    """The plain record walk's codes against the JAX record kernel's
    (interpret mode) at depth 3, on a sphere grid with a triangle sheet
    through it.  The first bounce, all a depth-1 record holds, is bit for
    bit equal: winner slot (sphere and triangle slots), front face, and the
    metal and dielectric decisions of every hit.  Deeper, a path flipped by
    a lobe transcendental's ulp (ROADMAP C) records other winners after
    the flip; at least 0.9 of all the entries are equal."""
    j, t = _pair("both", 3)
    w = h = 12
    _, got = port_codes(t, w, h)
    got = got.numpy()
    want = jax_codes(j, w, h).T
    slot = got[0] & BK.REC_SLOT
    tri_base = j.cbvh.n_sph_chunks * PK.BVH_LEAF
    assert ((got[0] >= 0) & (slot < tri_base)).any()  # spheres,
    assert ((got[0] >= 0) & (slot >= tri_base)).any()  # triangles
    assert (got[0] < 0).any()  # and misses
    for bit in (BK.REC_FRONT, BK.REC_METAL_OK, BK.REC_REFLECT):
        assert ((got >= 0) & (got & bit != 0)).any()
    np.testing.assert_array_equal(got[0], want[0])
    share = (got == want).mean()
    print(f"depth 3: {share:.4f} of the codes equal")
    assert share >= 0.9


# ------------------------------------------------------- (b) the replay

def test_replay_matches_jax():
    """The port's replay (plain fetch, then diff/replay.py) on the port's
    own codes against JAX ``replay_radiance`` on the same codes, on the
    grid with the sheet and a gradient background at depth 3: radiance
    within atol 1e-5, and the VJP of one numpy-seeded cotangent on every
    PARAM_PATHS leaf within rtol 1e-3 of each entry plus 1e-5 of the
    largest.  The JAX replay runs under jax.jit (op by op it takes 11 s
    here), where XLA's fused arithmetic moves the recomputed exit root of
    at most a ray or two through a glass sphere; those rays are left out
    of both comparisons.  Op by op, JAX's replay matches the port's on
    every ray (measured on the 216-sphere grid: 120 of 120)."""
    j, t = _pair("both", 3, gradient=True)
    w, h = 12, 10
    rad, codes = port_codes(t, w, h)
    n = rad.shape[0]
    cts = np.random.default_rng(0).standard_normal((n, 3)).astype(
        np.float32)

    ray_ids, px, py, rows, _ = _jax_rays(j, w, h)
    flat = lambda v: jnp.asarray(v).reshape(-1)[:n]
    rec = jnp.asarray(codes.numpy().T)
    replay = jax.jit(lambda s: replay_radiance(
        s, rec, _words(), flat(ray_ids), flat(px), flat(py), w, h))

    params = {k: v.clone().requires_grad_(True) for k, v in
              TG.extract_params(t, list(TG.PARAM_PATHS)).items()}
    sc = BK.pack(TG.apply_params(t, params), w, h, "cpu")
    got = BK.replay(sc, codes, trng.base_key(SEED), w * h, 1, w, **_opts(t))
    want = np.asarray(replay(j))
    moved = (np.abs(got.detach().numpy() - want) > 1e-5).any(-1)
    assert moved.sum() <= 2, moved.sum()
    np.testing.assert_allclose(got.detach().numpy()[~moved], want[~moved],
                               rtol=0, atol=1e-5)
    cts[moved] = 0.0
    (d_scene,) = jax.jit(lambda s, c: jax.vjp(replay, s)[1](c))(
        j, jnp.asarray(cts))
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
    assert live >= 8  # materials, background, camera and geometry


# ------------------------------------------------ (c) the fetch pair

def _rec_blocks(codes, rows):
    """Port codes (nb, R) -> the JAX fetch kernels' (rows * nb, 256)
    record layout (block i owns rows [i nb 8, (i + 1) nb 8), bounce k its
    rows [k 8, (k + 1) 8))."""
    nb, n = codes.shape
    full = np.full((nb, rows * PK.BLOCK_COLS), -1, np.int32)
    full[:, :n] = codes
    grid = rows // PK.BLOCK_ROWS
    return jnp.asarray(full.reshape(nb, grid, PK.BLOCK_ROWS, PK.BLOCK_COLS)
                       .transpose(1, 0, 2, 3).reshape(-1, PK.BLOCK_COLS))


def test_fetch_pair_plain_matches_jax():
    """#6's plain version against the JAX fetch kernel (interpret mode,
    depth 2, both bounces in one group) on the sphere grid with the sheet:
    every field bit for bit equal to the matching JAX row (_BS_GEO and
    _BS_RAD for a sphere, _TG_* and the _BS_GEO normal for a triangle,
    _BS_AL .. _BS_EM for the material, the _BS_LAM .. _BS_EMI one-hot for
    the kind), but for the sign of a zero, which the JAX one-hot product
    drops (-0 * 1 + 0 = +0; the sheet has -0.0 coordinates).  #7's plain
    version against the JAX transpose kernel for a numpy-seeded cotangent
    of the JAX rows: each tree's rows slot for slot, and the per-slot
    material rows of both trees summed per material id, within rtol
    1e-5."""
    j, t = _pair("both", 2)
    w = h = 12
    _, codes = port_codes(t, w, h)
    sc = BK.pack(t, w, h, "cpu")
    sph, tri = sc.spheres, sc.triangles
    args = (codes, sc.kinds, sc.tri_base, sph.mat, tri.mat, sc.mats, sph.geo,
            tri.geo)
    rows, kind = TF.fetch_rows_plain(*args)
    c = codes.numpy()
    n = c.shape[1]
    hit = c >= 0
    is_tri = hit & ((c & BK.REC_SLOT) >= sc.tri_base)
    is_sph = hit & ~is_tri
    assert is_sph.any() and is_tri.any()

    cb = j.cbvh
    *_, jrows, _ = _jax_rays(j, w, h)
    _, _, tens = PK._bvh_prep(j, w, h, False, ())
    wide, (sp, tp) = PK._fetch_wide_tabs(tens, cb.n_sph_chunks,
                                         cb.n_tri_chunks)
    fetch = PK._fetch_rows_cvjp(jrows, 2, cb.n_sph_chunks * PK.BVH_LEAF, sp,
                                tp, True)
    rec_g = _rec_blocks(c, jrows)
    ct = np.random.default_rng(0).standard_normal(
        (jrows * 2 * PK.FETCH_F, PK.BLOCK_COLS)).astype(np.float32)

    @jax.jit
    def fetch_vjp(tabs, g):  # one program: the pair compiles once
        out, vjp = jax.vjp(lambda *t: fetch(rec_g, *t), *tabs)
        return out, vjp(g)

    out, (d_sph_j, d_tri_j) = fetch_vjp(tuple(wide), jnp.asarray(ct))

    def per_ray(a):  # (rows nb F, 256) -> (F, nb, R)
        a = np.asarray(a).reshape(jrows // 8, 2, PK.FETCH_F, 8 * PK.BLOCK_COLS)
        return a.transpose(2, 1, 0, 3).reshape(PK.FETCH_F, 2, -1)[..., :n]

    sph_rows = [PK._BS_GEO + k for k in range(3)] + [PK._BS_RAD]
    tri_rows = ([PK.FETCH_GEO0 + PK._TG_V0 + k for k in range(9)]
                + [PK._BS_GEO + k for k in range(3)])
    mat_rows = ([PK._BS_AL + k for k in range(3)] + [PK._BS_FUZZ, PK._BS_IR]
                + [PK._BS_EM + k for k in range(3)])

    def port_fields(a):
        """The JAX fields (F, nb, R) in the port's row layout."""
        geo = np.zeros((12,) + a.shape[1:], np.float32)
        geo[:4] = np.where(is_sph, a[sph_rows], 0.0)
        geo = np.where(is_tri, a[tri_rows], geo)
        return np.concatenate([geo, a[mat_rows]])

    np.testing.assert_array_equal((rows.numpy() + 0.0).view(np.uint32),
                                  port_fields(per_ray(out)).view(np.uint32))
    kinds = np.argmax(per_ray(out)[PK._BS_LAM:PK._BS_LAM + 4], 0)
    np.testing.assert_array_equal(kind.numpy(), np.where(hit, kinds, -1))

    d_sph, d_tri, d_mats = TF.fetch_rows_transpose_plain(
        codes, torch.tensor(port_fields(per_ray(ct))), sc.tri_base, sph.mat,
        tri.mat, sc.kinds.shape[0], sph.geo.shape[0], tri.geo.shape[0])
    d_sph_j, d_tri_j = np.asarray(d_sph_j), np.asarray(d_tri_j)
    n_s, n_t = sph.geo.shape[0], tri.geo.shape[0]
    want_mats = np.zeros((sc.kinds.shape[0], 8), np.float32)
    for got, dj, geo_rows, mat, n_slots in (
            (d_sph, d_sph_j, sph_rows, sph.mat, n_s),
            (d_tri, d_tri_j, [16 + k for k in range(9)] + sph_rows[:3],
             tri.mat, n_t)):
        want = dj[geo_rows, :n_slots].T
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        np.add.at(want_mats, mat.numpy(), dj[mat_rows, :n_slots].T)
    np.testing.assert_allclose(d_mats.numpy(), want_mats, rtol=1e-5,
                               atol=1e-6 * np.abs(want_mats).max())


# ------------------------------------------- (d) make_loss end to end

def _flip_tolerant(got, ref, name):
    """test_bvh_grad_matches_xla_mesh's bound: |port - JAX| / (|JAX| +
    1e-3) < 5e-2, and a live, finite gradient."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0, name
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-3)
    assert rel.max() < 5e-2, (name, rel)


def test_make_loss_matches_jax_pallas_bvh():
    """Port make_loss gradients on the sheet (triangles, a metal and an
    emissive sphere, depth 2) against jax.grad of JAX make_loss with
    engine="pallas_bvh" (the record kernel in interpret mode, then its
    replay), under the flip-tolerant relative error."""
    j, t = _pair("sheet", 3)
    w = h = 12
    names = ["albedo", "emission", "bg_color_a"]
    target = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    want = jax.jit(jax.grad(JG.make_loss(j, target, w, h, seed=SEED,
                                         engine="pallas_bvh")))(
        JG.extract_params(j, names))
    _, got = TG.render_and_grad(t, target, names, w, h, seed=SEED,
                                device="cpu")
    for k in names:
        _flip_tolerant(got[k].numpy(), want[k], k)


# ------------------------------------- (e) finite differences, port only

def test_grad_matches_fd():
    """AD of the port's own loss (record walk, replay) against central
    differences of its forward, as test_bvh_grad_fd_spheres: material 0's
    albedo (rtol 3e-2, atol 5e-3) and sphere 0's center x (rtol 2e-1,
    atol 5e-2)."""
    scene = grid_builder(T, n=6, depth=3, spp=1).build(with_bvh=True)
    w = h = 12
    albedo0 = torch.tensor([0.7, 0.3, 0.2])
    c0 = scene.spheres.center[0].clone()

    def loss(a, c):
        mats = dataclasses.replace(scene.materials, albedo=torch.cat(
            [a[None], scene.materials.albedo[1:]]))
        sph = dataclasses.replace(scene.spheres, center=torch.cat(
            [c[None], scene.spheres.center[1:]]))
        s2 = dataclasses.replace(scene, materials=mats, spheres=sph)
        return (T.render_linear(s2, w, h, seed=0, device="cpu") ** 2).sum()

    a = albedo0.clone().requires_grad_(True)
    c = c0.clone().requires_grad_(True)
    ga, gc = torch.autograd.grad(loss(a, c), [a, c])

    def fd(which, i, eps=1e-3):
        with torch.no_grad():
            vals = []
            for sign in (1, -1):
                aa, cc = albedo0.clone(), c0.clone()
                (aa if which == "albedo" else cc)[i] += sign * eps
                vals.append(loss(aa, cc).item())
        return (vals[0] - vals[1]) / (2 * eps)

    live = 0
    for i in range(3):
        np.testing.assert_allclose(ga[i].item(), fd("albedo", i), rtol=3e-2,
                                   atol=5e-3)
        live += abs(ga[i].item()) > 1e-6
    assert live >= 2, "the albedo gradient should be live"
    np.testing.assert_allclose(gc[0].item(), fd("center", 0), rtol=2e-1,
                               atol=5e-2)


# ------------------------------------------------------- (f) the CLI fit

def test_cli_fit_bvh_stress(tmp_path, capsys):
    """CLI ``fit`` of scenes/bvh_stress.json (1,189 spheres, the BVH path)
    on the CPU, 3 steps of the albedos, emission and both background
    colors against a target the CLI rendered from the scene with its
    albedos and its sky dimmed: the loss falls.  (At 12x12 the spheres
    cover too few pixels for their albedos alone to move the loss above
    the noise of a new seed each step.)"""
    with open(STRESS) as f:
        d = json.load(f)
    for m in d["materials"]:
        if "albedo" in m:
            m["albedo"] = {c: 0.5 * v for c, v in m["albedo"].items()}
    for side in ("top", "bottom"):
        d["background"][side] = {c: 0.6 * v for c, v in
                                 d["background"][side].items()}
    dim = tmp_path / "dim.json"
    dim.write_text(json.dumps(d))
    target = str(tmp_path / "target.png")
    size = ["--width", "12", "--height", "12"]
    assert cli.main(["render", str(dim), *size, "--device", "cpu", "-o",
                     target]) == 0
    capsys.readouterr()
    assert cli.main(["fit", STRESS, target, "--params",
                     "albedo,emission,bg_color_a,bg_color_b", "--steps", "3",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    first = float(out.split("step 0: loss")[1].split()[0])
    final = float(out.split("final loss")[1].split()[0])
    assert np.isfinite(first) and final < first, out
    assert cli.main(["info", STRESS]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["fit_engine"].startswith("bvh: record mode of #5")


def test_fit_sheet_on_cpu():
    """``diff.inverse.fit`` on the triangle sheet (the BVH path, both
    trees) on the CPU: 3 Adam steps of the albedos against a render with
    the albedos dimmed, on a pinned seed (as test_bvh_fit_converges: at
    12x12 spp 1 a new seed each step moves the loss more than the fit
    does); the loss falls and the albedos move down."""
    from raytracingrust_tpu_torch.diff.inverse import fit

    _, t = _pair("sheet", 2)
    w = h = 12
    target = T.render_linear(TG.apply_params(t, {
        "albedo": t.materials.albedo * 0.5}), w, h, seed=0, device="cpu")
    _, params, history = fit(t, target, ["albedo"], w, h, steps=3,
                             resample_every=0, device="cpu")
    assert all(np.isfinite(history)) and history[-1] < history[0]
    assert bool((params["albedo"][0] < t.materials.albedo[0]).all())


def test_cuda_wrappers_refuse_cpu_tensors():
    """On CPU tensors the record variant, #6 and #7 raise (the dispatch
    takes their plain versions there); nothing falls back."""
    _, t = _pair("sheet", 2)
    sc = BK.pack(t, 8, 6, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        BK.radiance_bvh_cuda(sc, (0, 0), 48, 1, 8, max_depth=2, bg_kind=0,
                             clay=False, record=True)
    _, codes = port_codes(t, 8, 6)
    sph, tri = sc.spheres, sc.triangles
    args = (codes, sc.kinds, sc.tri_base, sph.mat, tri.mat, sc.mats,
            sph.geo, tri.geo)
    with pytest.raises(ValueError, match="CUDA"):
        TF.fetch_rows_cuda(*args)
    rows, _ = TF.fetch_rows_plain(*args)
    with pytest.raises(ValueError, match="CUDA"):
        TF.fetch_rows_transpose_cuda(codes, rows, sc.tri_base, sph.mat,
                                     tri.mat, sc.kinds.shape[0],
                                     sph.geo.shape[0], tri.geo.shape[0])
