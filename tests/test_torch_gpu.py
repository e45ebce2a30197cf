"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run on a machine that has PyTorch and CUDA alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models.mesh import Mesh
from raytracingrust_tpu_torch.ops import bvh_kernel as TB
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.ops import mse_loss as TM
from raytracingrust_tpu_torch.ops import radiance_grad as TR
from raytracingrust_tpu_torch.utils import rng as trng

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes",
                       "cornell_spheres.json")
STRESS = os.path.join(os.path.dirname(__file__), "..", "scenes",
                      "bvh_stress.json")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _benchmark_like(mode="Full", gradient=False):
    """tests/test_pallas.py::benchmark_like_builder's scene."""
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = T.RenderSettings(samples_per_pixel=2, max_ray_depth=4,
                                  enable_bvh_tree=False, mode=mode)
    if gradient:
        b.background = T.Background.gradient((0.5, 0.7, 1.0),
                                             (1.0, 1.0, 1.0))
    ground = b.add_material(T.Lambertian((0.8, 0.8, 0.4)))
    red = b.add_material(T.Lambertian((0.8, 0.1, 0.1)))
    mirror = b.add_material(T.Metal((1.0, 1.0, 1.0), 0.03))
    glass = b.add_material(T.Dielectric(1.5))
    sun = b.add_material(T.Emission((2.0, 2.0, 2.0)))
    b.add_sphere((10, 15.8, -1), 10.0, sun)
    b.add_sphere((1, 0, -1), 0.5, mirror)
    b.add_sphere((-1, 0, -1), 0.5, glass)
    b.add_sphere((0, -0.2, -1), 0.3, red)
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    return b.build()


def _both(scene, w, h, seed, device):
    """(kernel, plain) per-ray radiance of the same rays on the card."""
    s = scene.settings
    fp = TK.pack_fparams(scene, w, h).to(device)
    kinds = TK.sphere_kinds(scene).to(device)
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == "Clay")
    key = trng.base_key(seed)
    spp = s.samples_per_pixel
    ker = TK.radiance_cuda(fp, kinds, key, w * h * spp, spp, w, **opts)
    torch.cuda.synchronize()
    ids, px, py = TK.prep_rays(torch.arange(w * h, device=device), spp, w)
    return ker, TK.radiance_plain(fp, kinds, key, ids, px, py, **opts)


def _cornell():
    """scenes/cornell_spheres.json at spp 4: radius-1000 walls, depth 8."""
    b = T.SceneBuilder.from_file(CORNELL)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=4)
    return b.build()


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: _benchmark_like("Full"), lambda: _benchmark_like("Clay"),
    lambda: _benchmark_like("Full", gradient=True), _cornell],
    ids=["full", "clay", "gradient", "cornell"])
def test_kernel_matches_plain_on_card(cuda_device, make):
    """Per-ray radiance bit for bit equal at depth 1 and at full depth (as
    chip_smoke.py phase 3)."""
    scene = make()
    w, h = 64, 48
    d1 = dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, max_ray_depth=1))
    for sc in (d1, scene):
        ker, plain = _both(sc, w, h, 11, cuda_device)
        assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
def test_kernel_cipher_bitwise_on_card(cuda_device):
    key = trng.base_key(0xDEADBEEFCAFEBABE)
    ids = torch.arange(1 << 16, dtype=torch.int32, device=cuda_device)
    for stream in (0, 1, 7):
        got = TK.uniforms_cuda(key, ids, stream, 5)
        want = trng.ray_uniforms(key, ids, stream, 5)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_render_on_card_counts_launches(cuda_device):
    scene = _benchmark_like()
    before = TK.LAUNCHES
    img = T.render_linear(scene, 32, 24, seed=0, device=cuda_device)
    assert TK.LAUNCHES == before + 1
    assert img.shape == (24, 32, 3) and bool(torch.isfinite(img).all())
    cpu = T.render_linear(scene, 32, 24, seed=0, device="cpu")
    assert (img.cpu() - cpu).abs().mean().item() < 4e-2


# ------------------------------------------------------ the gradient kernels

def _close(got, want, rtol=2e-3, atol=2e-5):
    """Each entry within rtol of the plain version's, or atol of its largest
    entry: the kernels' sums run in another order (shared atomics, per-block
    partials) than autograd's."""
    err = (got - want).abs()
    return bool((err <= rtol * want.abs() + atol * want.abs().max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: _benchmark_like("Full"), lambda: _benchmark_like("Clay"),
    lambda: _benchmark_like("Full", gradient=True)],
    ids=["full", "clay", "gradient"])
def test_gradient_kernels_match_plain_on_card(cuda_device, make):
    """Kernel #3 (radiance gradient) and kernel #4 (fused loss) against
    autograd through the plain version, on the same inputs on the card."""
    scene = make()
    w, h = 64, 48
    s = scene.settings
    spp = s.samples_per_pixel
    fp = TK.pack_fparams(scene, w, h).to(cuda_device)
    kinds = TK.sphere_kinds(scene).to(cuda_device)
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == "Clay")
    key = trng.base_key(3)
    gen = np.random.default_rng(0)
    cts = torch.tensor(gen.standard_normal((w * h * spp, 3)),
                       dtype=torch.float32, device=cuda_device)
    ker = TR.radiance_grad_cuda(fp, kinds, key, cts, spp, w, **opts)
    plain = TR.radiance_grad_plain(fp, kinds, key, cts, spp, w, **opts)
    assert bool(torch.isfinite(ker).all()) and _close(ker, plain)

    target = torch.tensor(gen.random((w * h, 3)), dtype=torch.float32,
                          device=cuda_device)
    loss, dfp = TM.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                 clamp=s.clamp_indirect, **opts)
    fpg = fp.clone().requires_grad_(True)
    want = TM.mse_loss_plain(fpg, kinds, key, target, spp, w,
                             clamp=s.clamp_indirect, **opts)
    (want_dfp,) = torch.autograd.grad(want, fpg)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    assert _close(dfp, want_dfp)


@pytest.mark.gpu
def test_gradient_kernels_refuse_depth_13(cuda_device):
    scene = _benchmark_like()
    fp = TK.pack_fparams(scene, 8, 6).to(cuda_device)
    kinds = TK.sphere_kinds(scene).to(cuda_device)
    opts = dict(max_depth=13, bg_kind=0, clay=False)
    cts = torch.ones((8 * 6 * 2, 3), device=cuda_device)
    with pytest.raises(ValueError, match="at most 12"):
        TR.radiance_grad_cuda(fp, kinds, (0, 0), cts, 2, 8, **opts)
    with pytest.raises(ValueError, match="at most 12"):
        TM.mse_loss_cuda(fp, kinds, (0, 0), cts[:48], 2, 8, clamp=10.0,
                         **opts)


@pytest.mark.gpu
def test_fit_step_on_card_is_one_fused_launch(cuda_device):
    """make_loss under autograd launches the fused kernel once a step and
    nothing else of csrc/; without grad it launches the forward kernel."""
    scene = _benchmark_like()
    target = T.render_linear(scene, 32, 24, seed=5, device="cpu") * 0.9
    loss = TG.make_loss(scene, target, 32, 24, device=cuda_device)
    params = {k: v.to(cuda_device).requires_grad_(True) for k, v in
              TG.extract_params(scene, ["albedo", "bg_color_a"]).items()}
    counts = (TK.LAUNCHES, TR.LAUNCHES, TM.LAUNCHES)
    value = loss(params)
    value.backward()
    assert (TK.LAUNCHES, TR.LAUNCHES, TM.LAUNCHES) == (
        counts[0], counts[1], counts[2] + 1)
    assert bool(torch.isfinite(params["albedo"].grad).all())
    assert params["bg_color_a"].grad.abs().sum() > 0
    with torch.no_grad():
        again = loss(params)
    assert TK.LAUNCHES == counts[0] + 1
    assert abs(again.item() - value.item()) <= 1e-5 * value.item()


# ------------------------------------------------------ the BVH kernel (#5)

def _sheet(n_side=16, depth=4, spp=2, mode="Full"):
    """tests/test_pallas_bvh.py::mesh_builder's triangle sheet and two
    spheres."""
    return _sheet_builder(n_side, depth, spp, mode).build(with_bvh=True)


def _sheet_builder(n_side=16, depth=4, spp=2, mode="Full"):
    """The builder of :func:`_sheet`'s scene."""
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0, 2.5, 4), (0, 0, 0), (0, 1, 0), 55.0, 1.0)
    b.settings = T.RenderSettings(samples_per_pixel=spp, max_ray_depth=depth,
                                  mode=mode)
    ml = b.add_material(T.Lambertian((0.6, 0.5, 0.3)))
    mm = b.add_material(T.Metal((0.9, 0.85, 0.8), 0.05))
    me = b.add_material(T.Emission((2.5, 2.2, 1.8)))
    xs = np.linspace(-2, 2, n_side + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.3 * np.sin(gx * 2.1) * np.cos(gz * 1.7)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    a = (np.arange(n_side)[:, None] * (n_side + 1)
         + np.arange(n_side)[None, :]).reshape(-1)
    faces = np.stack([np.stack([a, a + 1, a + n_side + 1], 1),
                      np.stack([a + 1, a + n_side + 2, a + n_side + 1], 1)],
                     1).reshape(-1, 3)
    b.add_mesh(Mesh.from_buffers(verts, verts, faces, ml))
    b.add_sphere((0.8, 1.2, 0.0), 0.4, mm)
    b.add_sphere((-1.2, 1.8, 0.5), 0.35, me)
    return b


def _stress(mode="Full"):
    """scenes/bvh_stress.json (1,189 spheres, gradient background) at
    spp 2."""
    b = T.SceneBuilder.from_file(STRESS)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=2,
                                     mode=mode)
    return b.build()


def _bvh_both(scene, w, h, seed, device):
    """(kernel, plain) per-ray radiance of the same rays on the card."""
    s = scene.settings
    sc = TB.pack(scene, w, h, device)
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == "Clay")
    key = trng.base_key(seed)
    spp = s.samples_per_pixel
    ker = TB.radiance_bvh_cuda(sc, key, w * h * spp, spp, w, **opts)
    torch.cuda.synchronize()
    ids, px, py = TK.prep_rays(torch.arange(w * h, device=device), spp, w)
    return ker, TB.radiance_bvh_plain(sc, key, ids, px, py, **opts)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    _stress, lambda: _stress("Clay"), _sheet, lambda: _sheet(mode="Clay")],
    ids=["stress", "stress-clay", "sheet", "sheet-clay"])
def test_bvh_kernel_matches_plain_on_card(cuda_device, make):
    """Kernel #5's per-ray radiance bit for bit equal to its plain version
    at depth 1 and at full depth (as chip_smoke.py phase 7)."""
    scene = make()
    d1 = dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, max_ray_depth=1))
    for sc in (d1, scene):
        ker, plain = _bvh_both(sc, 48, 40, 7, cuda_device)
        assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
def test_bvh_render_on_card_counts_launches(cuda_device):
    scene = _sheet()
    before, brute = TB.LAUNCHES, TK.LAUNCHES
    img = T.render_linear(scene, 32, 24, seed=0, device=cuda_device)
    assert (TB.LAUNCHES, TK.LAUNCHES) == (before + 1, brute)
    assert img.shape == (24, 32, 3) and bool(torch.isfinite(img).all())
    cpu = T.render_linear(scene, 32, 24, seed=0, device="cpu")
    assert (img.cpu() - cpu).abs().mean().item() < 4e-2


# ------------------- the BVH fit path: record mode of #5, #6 and #7


def _record_inputs(scene, w, h, seed, device):
    s = scene.settings
    sc = TB.pack(scene, w, h, device)
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == "Clay")
    return sc, trng.base_key(seed), s.samples_per_pixel, opts


def _fetch_args(sc, codes):
    sph, tri = sc.spheres, sc.triangles
    return (codes, sc.kinds, sc.tri_base, sph and sph.mat, tri and tri.mat,
            sc.mats, sph and sph.geo, tri and tri.geo)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    _stress, lambda: _stress("Clay"), _sheet, lambda: _sheet(mode="Clay")],
    ids=["stress", "stress-clay", "sheet", "sheet-clay"])
def test_bvh_record_kernel_matches_on_card(cuda_device, make):
    """The record variant's radiance equals #5's bit for bit, and its codes
    equal the plain record walk's on every ray and bounce."""
    scene = make()
    w, h = 48, 40
    sc, key, spp, opts = _record_inputs(scene, w, h, 7, cuda_device)
    n = w * h * spp
    plain_rec = TB.RECORD_LAUNCHES
    ker = TB.radiance_bvh_cuda(sc, key, n, spp, w, **opts)
    rec, codes = TB.radiance_bvh_cuda(sc, key, n, spp, w, record=True, **opts)
    assert TB.RECORD_LAUNCHES == plain_rec + 1
    torch.cuda.synchronize()
    assert torch.equal(rec.view(torch.int32), ker.view(torch.int32))
    ids, px, py = TK.prep_rays(torch.arange(w * h, device=cuda_device), spp,
                               w)
    _, want = TB.radiance_bvh_plain(sc, key, ids, px, py, record=True, **opts)
    assert torch.equal(codes, want)
    assert bool((codes >= 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_stress, _sheet], ids=["stress", "sheet"])
def test_fetch_pair_matches_plain_on_card(cuda_device, make):
    """#6 equals its plain version bit for bit; #7 agrees with index_add_
    within rtol 1e-5 of each entry plus 1e-6 of the largest (float32
    atomics in another order)."""
    from raytracingrust_tpu_torch.ops import fetch as TF

    scene = make()
    w, h = 48, 40
    sc, key, spp, opts = _record_inputs(scene, w, h, 7, cuda_device)
    _, codes = TB.radiance_bvh_cuda(sc, key, w * h * spp, spp, w,
                                    record=True, **opts)
    args = _fetch_args(sc, codes)
    rows, kind = TF.fetch_rows_cuda(*args)
    want_rows, want_kind = TF.fetch_rows_plain(*args)
    assert torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
    assert torch.equal(kind, want_kind)
    g = torch.tensor(np.random.default_rng(0).standard_normal(
        tuple(rows.shape)), dtype=torch.float32, device=cuda_device)
    sph, tri = sc.spheres, sc.triangles
    targs = (codes, g, sc.tri_base, sph and sph.mat, tri and tri.mat,
             sc.kinds.shape[0], sph.geo.shape[0] if sph else 0,
             tri.geo.shape[0] if tri else 0)
    for got, want in zip(TF.fetch_rows_transpose_cuda(*targs),
                         TF.fetch_rows_transpose_plain(*targs)):
        if want is None:
            assert got is None
            continue
        tol = 1e-5 * want.abs() + 1e-6 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_stress, _sheet], ids=["stress", "sheet"])
def test_bvh_gradients_match_plain_route_on_card(cuda_device, make):
    """The packed tensors' gradient through the record kernel, #6 and #7
    agrees with autograd through the plain route (plain record walk, plain
    fetch) within rtol 2e-3 of each entry plus 2e-5 of the largest, at
    64x48; the kernels launch once each."""
    scene = make()
    w, h = 64, 48
    sc, key, spp, opts = _record_inputs(scene, w, h, 5, cuda_device)
    n_pix = w * h
    cts = torch.tensor(np.random.default_rng(1).standard_normal(
        (n_pix * spp, 3)), dtype=torch.float32, device=cuda_device)
    want = TB.radiance_grad_plain(sc, key, cts, n_pix, spp, w, **opts)
    from raytracingrust_tpu_torch.ops import fetch as TF

    counts = (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TF.TRANSPOSE_LAUNCHES)
    rows = [None if v is None else v.detach().requires_grad_(True)
            for v in TB._rows(sc)]
    sc_g = sc.with_rows(*rows)
    rad = TB.radiance(sc_g, key, n_pix, spp, w, **opts)
    live = [v for v in rows if v is not None]
    got = torch.autograd.grad(rad, live, cts)
    assert (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES,
            TF.TRANSPOSE_LAUNCHES) == tuple(c + 1 for c in counts)
    for a, b in zip(got, [v for v in want if v is not None]):
        assert bool(torch.isfinite(a).all())
        tol = 2e-3 * b.abs() + 2e-5 * b.abs().max()
        assert bool(((a - b).abs() <= tol).all())
    assert got[1].abs().sum() > 0  # the material table


@pytest.mark.gpu
def test_bvh_fit_on_card(cuda_device):
    """make_loss and fit take a BVH scene on the card: the loss falls over
    three Adam steps and every step launches the record kernel, #6 and
    #7 once."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import fetch as TF

    scene = _sheet()
    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 32, 24, seed=1,
        device=cuda_device)
    counts = (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TF.TRANSPOSE_LAUNCHES)
    _, _, history = fit(scene, target, ["albedo", "emission"], 32, 24,
                        steps=3, device=cuda_device)
    assert (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES,
            TF.TRANSPOSE_LAUNCHES) == tuple(c + 3 for c in counts)
    assert all(np.isfinite(history)) and history[-1] < history[0]


# ---------------- the HDRI importance-sampling path: #8 and the env replay


def _env(scene, h=32, w=64):
    """The scene under a seeded sky (a gradient, noise and a small sun far
    above the clamp), with HDRI importance sampling on."""
    img = np.random.default_rng(0).uniform(0.8, 1.2, (h, w, 3)).astype(
        np.float32)
    img *= np.linspace(1.0, 0.1, h, dtype=np.float32)[:, None, None]
    img[4:6, 10:13] = 500.0  # rows near 0 face the zenith
    return dataclasses.replace(
        scene, background=T.Background.skymap_from_array(img),
        settings=dataclasses.replace(scene.settings,
                                     env_importance_sampling=True))


def _shadow_rays(sc, sky, key, n_pix, spp, w, depth):
    """The shadow rays of every bounce of the plain route's replay."""
    from raytracingrust_tpu_torch.ops import occlusion as TO

    rays = []

    def occlude(o, d, ids, stream):
        rays.append((o, d, ids, stream))
        return TO.occluded_plain(sc, o, d, ids, key, stream)

    ids, px, py = TK.prep_rays(torch.arange(n_pix, device=sc.device), spp, w)
    _, codes = TB.radiance_bvh_plain(sc, key, ids, px, py, max_depth=depth,
                                     bg_kind=T.Background.uniform(0).kind,
                                     clay=False, record=True)
    TB.replay(sc, codes, key, n_pix, spp, w, max_depth=depth,
              bg_kind=sky.kind, clay=False, plain=True, sky=sky,
              occlude=occlude)
    return rays


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_stress, _sheet], ids=["stress", "sheet"])
def test_occlusion_kernel_matches_plain_on_card(cuda_device, make):
    """#8 equals its plain version on every shadow ray of every bounce of
    an env render at 64x48, and refuses CPU tensors."""
    from raytracingrust_tpu_torch.ops import occlusion as TO

    scene = _env(make())
    w, h = 64, 48
    sc, key, spp, _ = _record_inputs(scene, w, h, 5, cuda_device)
    sky = scene.to(cuda_device).background
    rays = _shadow_rays(sc, sky, key, w * h, spp, w,
                        scene.settings.max_ray_depth)
    assert rays
    before, blocked, total = TO.LAUNCHES, 0, 0
    for o, d, ids, stream in rays:
        got = TO.occluded_cuda(sc, o, d, ids, key, stream)
        assert torch.equal(got, TO.occluded_plain(sc, o, d, ids, key,
                                                  stream))
        blocked, total = blocked + int(got.sum()), total + got.numel()
    assert TO.LAUNCHES == before + len(rays)
    assert 0 < blocked < total  # both outcomes
    cpu = TB.pack(scene, w, h, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TO.occluded_cuda(cpu, rays[0][0].cpu(), rays[0][1].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_stress, _sheet], ids=["stress", "sheet"])
def test_env_radiance_matches_plain_route_on_card(cuda_device, make):
    """The env radiance through the record kernel, #6 and #8 equals the
    all-plain route bit for bit; the gradient in the packed tensors and the
    sky's texels through the kernels (#7 as the fetch's backward) agrees
    with autograd through the plain route within rtol 2e-3 of each entry
    plus 2e-5 of the largest."""
    from raytracingrust_tpu_torch.ops import fetch as TF
    from raytracingrust_tpu_torch.ops import occlusion as TO

    scene = _env(make())
    w, h = 64, 48
    sc, key, spp, _ = _record_inputs(scene, w, h, 5, cuda_device)
    depth = scene.settings.max_ray_depth
    sky = scene.to(cuda_device).background
    args = (key, w * h, spp, w)
    counts = (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TO.LAUNCHES)
    with torch.no_grad():
        ker = TB.env_radiance(sc, sky, *args, max_depth=depth)
        plain = TB.env_radiance(sc, sky, *args, max_depth=depth, plain=True)
    assert (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES) == (counts[0] + 1,
                                                       counts[1] + 1)
    assert TO.LAUNCHES > counts[2]
    assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))
    assert bool(torch.isfinite(ker).all()) and ker.abs().sum() > 0

    cts = torch.tensor(np.random.default_rng(1).standard_normal(
        (w * h * spp, 3)), dtype=torch.float32, device=cuda_device)
    grads = []
    for route in (False, True):
        rows = [None if v is None else v.detach().requires_grad_(True)
                for v in TB._rows(sc)]
        img = sky.image.detach().requires_grad_(True)
        live = [v for v in rows if v is not None] + [img]
        rad = TB.env_radiance(sc.with_rows(*rows),
                              dataclasses.replace(sky, image=img), *args,
                              max_depth=depth, plain=route)
        grads.append(torch.autograd.grad(rad, live, cts))
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        tol = 2e-3 * b.abs() + 2e-5 * b.abs().max()
        assert bool(((a - b).abs() <= tol).all())
    assert grads[0][1].abs().sum() > 0 and grads[0][-1].abs().sum() > 0


@pytest.mark.gpu
def test_env_render_and_fit_on_card(cuda_device):
    """render_linear and fit take an env scene on the card through the
    record kernel, #6, #7 and #8; the loss falls over three steps."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import occlusion as TO

    scene = _env(_sheet())
    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 32, 24, seed=1,
        device=cuda_device)
    assert bool(torch.isfinite(target).all())
    before = TO.LAUNCHES
    _, _, history = fit(scene, target, ["albedo", "emission"], 32, 24,
                        steps=3, device=cuda_device)
    assert TO.LAUNCHES > before
    assert all(np.isfinite(history)) and history[-1] < history[0]


# ------------- volumes, isotropic materials and mixes: the material zoo

ZOO = os.path.join(os.path.dirname(__file__), "..", "scenes",
                   "material_zoo.json")


def _zoo(spp=2, depth=8):
    """scenes/material_zoo.json: a fog sphere of an isotropic material and
    a mix among 47 spheres."""
    b = T.SceneBuilder.from_file(ZOO)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                     max_ray_depth=depth)
    return b.build()


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 8])
def test_zoo_kernels_match_plain_on_card(cuda_device, depth):
    """On the zoo at 96x64: #5's radiance and the record variant's codes
    equal their plain versions bit for bit (the volume tree's free flight,
    the mix rounds and the isotropic lobe included); #6 in raw mode equals
    its plain version; #7 agrees with the float64 sums of the same
    cotangents within rtol 1e-5 of each entry plus 1e-6 of the largest (as
    chip_smoke.py holds it: index_add_'s float32 atomic sums vary in their
    order as #7's do); the gradient through the kernels
    agrees with the plain route within rtol 2e-3 plus 2e-5 of the
    largest."""
    from raytracingrust_tpu_torch.ops import fetch as TF

    scene = _zoo(depth=depth)
    w, h = 96, 64
    sc, key, spp, opts = _record_inputs(scene, w, h, 7, cuda_device)
    assert sc.volumes is not None and sc.mixes is not None and sc.iso
    n = w * h * spp
    ker = TB.radiance_bvh_cuda(sc, key, n, spp, w, **opts)
    rec, codes = TB.radiance_bvh_cuda(sc, key, n, spp, w, record=True, **opts)
    torch.cuda.synchronize()
    ids, px, py = TK.prep_rays(torch.arange(w * h, device=cuda_device), spp,
                               w)
    plain, want = TB.radiance_bvh_plain(sc, key, ids, px, py, record=True,
                                        **opts)
    assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(rec.view(torch.int32), ker.view(torch.int32))
    assert torch.equal(codes, want)
    slot = codes & TB.REC_SLOT
    assert bool(((codes >= 0) & (slot >= sc.vol_base)).any())  # fog hits

    args = (codes, *TB.fetch_inputs(sc))
    rows, kind = TF.fetch_rows_cuda(*args)
    want_rows, want_kind = TF.fetch_rows_plain(*args)
    assert rows.shape[0] == 4  # raw: geometry only
    assert torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
    assert torch.equal(kind, want_kind)
    g = torch.tensor(np.random.default_rng(0).standard_normal(
        tuple(rows.shape)), dtype=torch.float32, device=cuda_device)
    kinds, tri_base, sph_mat, tri_mat, _, sph_geo, _, raw = args[1:9]
    targs = (codes, g, tri_base, sph_mat, tri_mat, kinds.shape[0],
             sph_geo.shape[0], 0, raw)
    got_t = TF.fetch_rows_transpose_cuda(*targs)
    want_t = TF.fetch_rows_transpose_plain(codes, g.double(), *targs[2:])
    assert got_t[1] is None and got_t[2] is None and want_t[2] is None
    tol = 1e-5 * want_t[0].abs() + 1e-6 * want_t[0].abs().max()
    assert bool(((got_t[0].double() - want_t[0]).abs() <= tol).all())

    if depth == 1:
        return
    cts = torch.tensor(np.random.default_rng(1).standard_normal(
        (n, 3)), dtype=torch.float32, device=cuda_device)
    grad_want = TB.radiance_grad_plain(sc, key, cts, w * h, spp, w, **opts)
    rows_in = [None if v is None else v.detach().requires_grad_(True)
               for v in TB._rows(sc)]
    rad = TB.radiance(sc.with_rows(*rows_in), key, w * h, spp, w, **opts)
    got = torch.autograd.grad(rad, [v for v in rows_in if v is not None],
                              cts)
    for a, b in zip(got, [v for v in grad_want if v is not None]):
        assert bool(torch.isfinite(a).all())
        tol = 2e-3 * b.abs() + 2e-5 * b.abs().max()
        assert bool(((a - b).abs() <= tol).all())
    assert got[-1].abs().sum() > 0  # the fog sphere's row


@pytest.mark.gpu
def test_sky_zoo_occlusion_and_env_on_card(cuda_device):
    """The zoo under a sky with importance sampling at 64x48 depth 4: #8
    equals its plain version on every shadow ray, some blocked by the fog
    alone; the env radiance through the kernels equals the all-plain route
    bit for bit."""
    from raytracingrust_tpu_torch.ops import occlusion as TO

    scene = _env(_zoo(depth=4))
    w, h = 64, 48
    sc, key, spp, _ = _record_inputs(scene, w, h, 5, cuda_device)
    sky = scene.to(cuda_device).background
    rays = _shadow_rays(sc, sky, key, w * h, spp, w, 4)
    fog_only = 0
    solid = sc._replace(volumes=None)
    for o, d, ids, stream in rays:
        got = TO.occluded_cuda(sc, o, d, ids, key, stream)
        assert torch.equal(got, TO.occluded_plain(sc, o, d, ids, key,
                                                  stream))
        fog_only += int((got & ~TO.occluded_plain(solid, o, d)).sum())
    assert fog_only > 0
    with torch.no_grad():
        ker = TB.env_radiance(sc, sky, key, w * h, spp, w, max_depth=4)
        plain = TB.env_radiance(sc, sky, key, w * h, spp, w, max_depth=4,
                                plain=True)
    assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
def test_zoo_fit_on_card(cuda_device):
    """fit's BVH route (``engine="bvh"``; the dispatch sends the zoo to the
    brute kernels) takes the zoo on the card through the record kernel, #6
    and #7, once each a step; the loss falls over three steps."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import fetch as TF

    scene = _zoo(spp=4, depth=4)
    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 48, 32, seed=1,
        device=cuda_device)
    counts = (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TF.TRANSPOSE_LAUNCHES)
    _, _, history = fit(scene, target, ["albedo", "sphere_center"], 48, 32,
                        steps=3, device=cuda_device, resample_every=0,
                        engine="bvh")
    assert (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES,
            TF.TRANSPOSE_LAUNCHES) == tuple(c + 3 for c in counts)
    assert all(np.isfinite(history)) and history[-1] < history[0]


# ------- the brute kernels' mixes, sphere volumes, isotropic lobe and sky


def brute_ext_builder(mod, depth=3, spp=2, sky=False):
    """A small scene of every branch the brute kernels' kExt and kSky
    variants add: a ground, a metal sphere, a single-level mix (Lambertian
    and glass), an emitter, an isotropic sphere and a fog sphere of an
    isotropic material; a gradient background, or a numpy-seeded 16x32 sky
    map with a bright patch.  ``mod`` is the package (the port's or the
    JAX one's), so the CPU tests build the same scene in both."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 1, 4), (0, 0.3, 0), (0, 1, 0), 50.0,
                                 4 / 3)
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth,
                                    enable_bvh_tree=False)
    if sky:
        img = (0.1 + 0.5 * np.random.RandomState(2).rand(16, 32, 3)).astype(
            np.float32)
        img[2:4, 8:11] = (6.0, 5.0, 4.0)
        b.background = mod.Background.skymap_from_array(img)
    else:
        b.background = mod.Background.gradient((0.5, 0.7, 1.0),
                                               (1.0, 1.0, 1.0))
    ground = b.add_material(mod.Lambertian((0.7, 0.6, 0.4)))
    metal = b.add_material(mod.Metal((0.9, 0.8, 0.7), 0.1))
    mix = b.add_material(mod.MixMaterial(mod.Lambertian((0.2, 0.5, 0.8)),
                                         mod.Dielectric(1.5), 0.4))
    light = b.add_material(mod.Emission((3.0, 2.5, 2.0)))
    iso = b.add_material(mod.Isotropic((0.8, 0.8, 0.9)))
    b.add_sphere((0, -100.5, 0), 100.0, ground)
    b.add_sphere((-1.1, 0.2, 0), 0.6, metal)
    b.add_sphere((1.1, 0.2, 0), 0.6, mix)
    b.add_sphere((0, 2.2, -1), 0.5, light)
    b.add_sphere((0.4, 1.0, 0.6), 0.3, iso)
    b.add_volume(b.add_sphere((0, 0.3, 0.2), 0.7, iso), 1.5)
    return b


def _brute_inputs(scene, w, h, device):
    """The packed constants, kinds, options (with the triangles' rows) and
    sky of a brute scene."""
    fp = TK.pack_fparams(scene, w, h).to(device)
    kinds = TK.brute_kinds(scene).to(device)
    sky = (scene.background.image.to(device)
           if scene.background.image is not None else None)
    tri = TK.pack_tri(scene)
    return fp, kinds, {**TK.scene_opts(scene), "tri": None if tri is None
                       else tri.to(device)}, sky


_BRUTE_EXT = {
    "ext": lambda depth: brute_ext_builder(T, depth).build(),
    "sky": lambda depth: _solid_sky(depth),
    "ext-sky": lambda depth: brute_ext_builder(T, depth, sky=True).build(),
    "zoo": lambda depth: _zoo(depth=depth),
}


def _solid_sky(depth):
    """The benchmark-like scene (solid spheres) under the small sky: the
    kSky variant alone."""
    scene = _benchmark_like()
    sky = brute_ext_builder(T, sky=True).background
    return dataclasses.replace(scene, background=sky,
                               settings=dataclasses.replace(
                                   scene.settings, max_ray_depth=depth))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_BRUTE_EXT))
def test_brute_ext_kernel_matches_plain_on_card(cuda_device, name):
    """Kernel #1's kExt, kSky and kExt + kSky variants (and the zoo on kExt)
    bit for bit equal to their plain version at depth 1 and 6 (as
    chip_smoke.py phase 13); each launch counts as its variant."""
    w, h = 64, 48
    for depth in (1, 6):
        scene = _BRUTE_EXT[name](depth)
        fp, kinds, opts, sky = _brute_inputs(scene, w, h, cuda_device)
        key = trng.base_key(11)
        spp = scene.settings.samples_per_pixel
        before = (TK.LAUNCHES, TK.EXT_LAUNCHES, TK.SKY_LAUNCHES)
        ker = TK.radiance_cuda(fp, kinds, key, w * h * spp, spp, w, sky=sky,
                               **opts)
        torch.cuda.synchronize()
        ext = int(name != "sky")
        assert (TK.LAUNCHES, TK.EXT_LAUNCHES, TK.SKY_LAUNCHES) == (
            before[0] + 1, before[1] + ext, before[2] + int(sky is not None))
        ids, px, py = TK.prep_rays(torch.arange(w * h, device=cuda_device),
                                   spp, w)
        plain = TK.radiance_plain(fp, kinds, key, ids, px, py, sky=sky,
                                  **opts)
        assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_BRUTE_EXT))
def test_brute_ext_gradients_match_plain_on_card(cuda_device, name):
    """Kernel #3's variants (the sky's texels included) and, without a sky
    map, kernel #4's against autograd through the plain version at depth
    6: every entry within rtol 2e-3 plus 2e-5 of the largest."""
    w, h = 48, 32
    scene = _BRUTE_EXT[name](6)
    fp, kinds, opts, sky = _brute_inputs(scene, w, h, cuda_device)
    key = trng.base_key(5)
    spp = scene.settings.samples_per_pixel
    gen = np.random.default_rng(0)
    cts = torch.tensor(gen.standard_normal((w * h * spp, 3)),
                       dtype=torch.float32, device=cuda_device)
    got = TR.radiance_grad_cuda(fp, kinds, key, cts, spp, w, sky=sky, **opts)
    want = TR.radiance_grad_plain(fp, kinds, key, cts, spp, w, sky=sky,
                                  **opts)
    for a, b in zip(*((got, want) if sky is not None else ([got], [want]))):
        assert bool(torch.isfinite(a).all()) and b.abs().max() > 0
        assert _close(a, b)
    if sky is not None:
        return
    target = torch.tensor(gen.random((w * h, 3)), dtype=torch.float32,
                          device=cuda_device)
    clamp = scene.settings.clamp_indirect
    loss, dfp = TM.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                 clamp=clamp, **opts)
    fpg = fp.clone().requires_grad_(True)
    p_loss = TM.mse_loss_plain(fpg, kinds, key, target, spp, w, clamp=clamp,
                               **opts)
    (p_dfp,) = torch.autograd.grad(p_loss, fpg)
    assert abs(loss.item() - p_loss.item()) <= 1e-5 * p_loss.item()
    assert _close(dfp, p_dfp)


@pytest.mark.gpu
def test_brute_ext_render_and_fit_on_card(cuda_device):
    """The dispatch takes the zoo and a sky scene to the brute kernels:
    render_linear launches #1's variant; make_loss under autograd launches
    #4's kExt variant on the zoo, and #1 + #3 with the sky (the texels'
    gradient finite and nonzero); fit's loss falls."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.render.render import select_engine

    zoo = _zoo(spp=2, depth=4)
    assert select_engine(zoo) == select_engine(zoo, grad=True) == "brute"
    before = (TK.EXT_LAUNCHES, TM.EXT_LAUNCHES, TB.LAUNCHES)
    target = T.render_linear(TG.apply_params(zoo, {
        "albedo": zoo.materials.albedo * 0.6}), 48, 32, seed=1,
        device=cuda_device)
    _, _, history = fit(zoo, target, ["albedo", "emission"], 48, 32,
                        steps=3, device=cuda_device, resample_every=0)
    assert (TK.EXT_LAUNCHES, TM.EXT_LAUNCHES, TB.LAUNCHES) == (
        before[0] + 1, before[1] + 3, before[2])
    assert all(np.isfinite(history)) and history[-1] < history[0]

    sky = brute_ext_builder(T, depth=4, sky=True).build()
    image = sky.background.image.to(cuda_device).requires_grad_(True)
    scene = dataclasses.replace(sky, background=dataclasses.replace(
        sky.background, image=image))
    before = (TK.SKY_LAUNCHES, TR.SKY_LAUNCHES, TM.LAUNCHES)
    loss = TG.make_loss(scene, torch.zeros(24, 32, 3), 32, 24,
                        device=cuda_device)
    params = {k: v.to(cuda_device).requires_grad_(True) for k, v in
              TG.extract_params(scene, ["albedo"]).items()}
    value = loss(params)
    value.backward()
    assert (TK.SKY_LAUNCHES, TR.SKY_LAUNCHES, TM.LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    assert bool(torch.isfinite(image.grad).all()) and image.grad.abs().sum() > 0
    assert bool(torch.isfinite(params["albedo"].grad).all())


@pytest.mark.gpu
def test_deep_cornell_fit_on_card(cuda_device):
    """A fit of scenes/cornell_spheres.json at depth 13, deeper than the
    brute gradient kernels' tape, runs through the record kernel, #6 and
    #7 (and never the brute gradient kernel #3); the loss falls.  The
    record kernel's radiance and codes at that depth equal the plain
    record walk's on every ray and bounce."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import fetch as TF

    b = T.SceneBuilder.from_file(CORNELL)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=4,
                                     max_ray_depth=13)
    scene = b.build()
    sc, key, spp, opts = _record_inputs(scene, 48, 48, 3, cuda_device)
    rad, codes = TB.radiance_bvh_cuda(sc, key, 48 * 48 * spp, spp, 48,
                                      record=True, **opts)
    ids, px, py = TK.prep_rays(torch.arange(48 * 48, device=cuda_device),
                               spp, 48)
    plain, want = TB.radiance_bvh_plain(sc, key, ids, px, py, record=True,
                                        **opts)
    assert torch.equal(rad.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(codes, want)
    assert bool((codes[12:] >= 0).any())  # hits past the brute tape
    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 48, 48, seed=1,
        device=cuda_device)
    counts = (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TR.LAUNCHES)
    _, _, history = fit(scene, target, ["albedo"], 48, 48, steps=3,
                        device=cuda_device, resample_every=0)
    assert (TB.RECORD_LAUNCHES - counts[0], TF.FETCH_LAUNCHES - counts[1],
            TR.LAUNCHES - counts[2]) == (3, 3, 0)
    assert all(np.isfinite(history)) and history[-1] < history[0]


# ------- the sky map without importance sampling, and the views, on #5


def _sky(scene, h=32, w=64):
    """The scene under _env's seeded sky, with importance sampling off;
    every texel distinct, so equal radiance means the same texel."""
    scene = _env(scene, h, w)
    return dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, env_importance_sampling=False))


def _view(scene, mode):
    return dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, mode=mode))


def _variant_both(scene, w, h, seed, device):
    """(kernel, plain) per-ray radiance of the same rays on the card, the
    sky-map variant or the view as the scene asks."""
    s = scene.settings
    sc = TB.pack(scene, w, h, device)
    sky = (scene.to(device).background if scene.background.kind == 2
           else None)
    opts = dict(max_depth=s.max_ray_depth, bg_kind=scene.background.kind,
                clay=s.mode == "Clay", sky=sky,
                debug=TB.VIEWS.get(s.mode))
    key = trng.base_key(seed)
    spp = s.samples_per_pixel
    ker = TB.radiance_bvh_cuda(sc, key, w * h * spp, spp, w, **opts)
    torch.cuda.synchronize()
    ids, px, py = TK.prep_rays(torch.arange(w * h, device=device), spp, w)
    return ker, TB.radiance_bvh_plain(sc, key, ids, px, py, **opts)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: _sky(_stress()), lambda: _sky(_sheet()),
    lambda: _sky(_stress("Clay")), lambda: _sky(_zoo(depth=4))],
    ids=["stress", "sheet", "stress-clay", "zoo"])
def test_bvh_sky_kernel_matches_plain_on_card(cuda_device, make):
    """#5's sky-map variant (the texel looked up in the kernel) bit for bit
    equal to its plain version (``Background.sample`` on the card) at
    depth 1 and at full depth; each launch counts as a sky launch."""
    scene = make()
    d1 = dataclasses.replace(scene, settings=dataclasses.replace(
        scene.settings, max_ray_depth=1))
    for sc in (d1, scene):
        before = (TB.SKY_LAUNCHES, TB.LAUNCHES)
        ker, plain = _variant_both(sc, 48, 40, 7, cuda_device)
        assert (TB.SKY_LAUNCHES, TB.LAUNCHES) == (before[0] + 1, before[1])
        assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))
        assert ker.abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["Normal", "Random"])
@pytest.mark.parametrize("make", [_stress, lambda: _sky(_sheet()), _zoo],
                         ids=["stress", "sky-sheet", "zoo"])
def test_bvh_view_kernel_matches_plain_on_card(cuda_device, make, mode):
    """#5's views (one intersection, the fog's free flight from bounce
    stream 1) bit for bit equal to their plain version on a gradient
    background, a sky map and the zoo; each launch counts as a view
    launch; a view refuses a gradient."""
    scene = _view(make(), mode)
    before = (TB.VIEW_LAUNCHES, TB.LAUNCHES, TB.SKY_LAUNCHES)
    ker, plain = _variant_both(scene, 48, 40, 7, cuda_device)
    assert (TB.VIEW_LAUNCHES, TB.LAUNCHES, TB.SKY_LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))
    img = T.render_linear(scene, 32, 24, seed=0, device=cuda_device)
    assert TB.VIEW_LAUNCHES == before[0] + 2
    assert bool(torch.isfinite(img).all()) and img.std() > 0
    scene.materials.albedo.requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        T.render_linear(scene, 8, 8, device=cuda_device)


@pytest.mark.gpu
def test_sky_fit_on_card(cuda_device):
    """A sky map without importance sampling under autograd: the record
    kernel, #6 and the replay with the sky on a miss; the gradient in the
    packed tensors and the sky's texels through the kernels (#7 under the
    fetch's backward) agrees with the plain route within rtol 2e-3 of each
    entry plus 2e-5 of the largest (the head has none: under a sky map no
    term of the radiance depends smoothly on the camera); fit launches
    record #5, #6 and #7 once a step, no #8, and its loss falls."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import fetch as TF
    from raytracingrust_tpu_torch.ops import occlusion as TO

    scene = _sky(_sheet())
    w, h = 64, 48
    sc, key, spp, _ = _record_inputs(scene, w, h, 5, cuda_device)
    depth = scene.settings.max_ray_depth
    sky = scene.to(cuda_device).background
    cts = torch.tensor(np.random.default_rng(1).standard_normal(
        (w * h * spp, 3)), dtype=torch.float32, device=cuda_device)
    grads = []
    for route in (False, True):
        rows = [None if v is None else v.detach().requires_grad_(True)
                for v in TB._rows(sc)]
        img = sky.image.detach().requires_grad_(True)
        live = [v for v in rows if v is not None] + [img]
        rad = TB.env_radiance(sc.with_rows(*rows),
                              dataclasses.replace(sky, image=img), key,
                              w * h, spp, w, max_depth=depth, plain=route,
                              mis=False)
        # no term depends smoothly on the camera: the head's is None
        grads.append(torch.autograd.grad(rad, live, cts,
                                         allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert bool(torch.isfinite(a).all())
        tol = 2e-3 * b.abs() + 2e-5 * b.abs().max()
        assert bool(((a - b).abs() <= tol).all())
    assert grads[0][1].abs().sum() > 0 and grads[0][-1].abs().sum() > 0

    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 32, 24, seed=1,
        device=cuda_device)
    counts = (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TF.TRANSPOSE_LAUNCHES,
              TO.LAUNCHES)
    # the target's own rays (seed 1, held): a sun far above the clamp
    # makes a fresh seed's loss noisier than three steps' gain
    _, _, history = fit(scene, target, ["albedo", "emission"], 32, 24,
                        steps=3, device=cuda_device, seed=1,
                        resample_every=0)
    assert (TB.RECORD_LAUNCHES, TF.FETCH_LAUNCHES, TF.TRANSPOSE_LAUNCHES,
            TO.LAUNCHES) == (counts[0] + 3, counts[1] + 3, counts[2] + 3,
                             counts[3])
    assert all(np.isfinite(history)) and history[-1] < history[0]


# ------------- mesh volumes: fog inside a triangle mesh

def _icosphere(center, radius, material, subdiv):
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
    return Mesh.from_buffers(v, v, np.asarray(faces, np.int32), material)


def _cube(center, half, material):
    """tests/test_mesh_volume.py::_cube_mesh: 12 triangles."""
    h = float(half)
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)], np.float32) + np.asarray(center,
                                                              np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    return Mesh.from_buffers(v, v, f, material)


def _fog(depth=6, spp=2, subdiv=3, inside=False):
    """A small fog_sheet (chip_smoke.py phase 12): the 128-triangle sheet
    with its metal and emissive spheres, an icosphere fog of an isotropic
    material and a cube fog whose material is a mix, under a gradient
    background (so the geometry rows, which #7 scatters into, move the
    radiance).  ``inside``: the camera at the icosphere's centre, looking
    at the sheet, so every primary ray starts inside the fog and finds its
    entry crossing behind its origin."""
    b = _sheet_builder(8, depth, spp)
    b.background = T.Background.gradient((0.5, 0.7, 1.0), (1.0, 1.0, 1.0))
    if inside:
        b.camera = T.Camera.create((-0.3, 0.8, 0.2), (0.5, 0, -0.5),
                                   (0, 1, 0), 70.0, 1.0)
    iso = b.add_material(T.Isotropic((0.8, 0.8, 0.9)))
    mix = b.add_material(T.MixMaterial(T.Isotropic((0.9, 0.4, 0.3)),
                                       T.Lambertian((0.2, 0.6, 0.3)), 0.5))
    b.add_volume(b.add_mesh(_icosphere((-0.3, 0.8, 0.2), 0.7, iso, subdiv)),
                 1.5)
    b.add_volume(b.add_mesh(_cube((1.1, 0.6, -0.6), 0.35, mix)), 3.0)
    return b.build()


@pytest.mark.gpu
@pytest.mark.parametrize("depth,inside", [(1, False), (6, False), (6, True)],
                         ids=["1", "6", "inside"])
def test_mesh_volume_kernels_match_plain_on_card(cuda_device, depth, inside):
    """On a small fog_sheet at 64x48 spp 2: #5's mesh-volume variant and
    its record variant equal their plain versions bit for bit (radiance
    and codes, fog hits among them), the Normal and Random views too; #6
    equals its plain version, #7 the float64 sums within rtol 1e-5 of each
    entry plus 1e-6 of the largest; at depth 6 the gradient through the
    kernels agrees with the plain route within rtol 2e-3 plus 2e-5 of the
    largest.  Every launch counts under MV_LAUNCHES.  ``inside``: the
    camera inside the icosphere, every primary entry behind its origin."""
    from raytracingrust_tpu_torch.ops import fetch as TF

    scene = _fog(depth, inside=inside)
    w, h = 64, 48
    sc, key, spp, opts = _record_inputs(scene, w, h, 9, cuda_device)
    assert sc.n_mv == 2 and sc.mixes is not None
    n = w * h * spp
    before = TB.MV_LAUNCHES
    ker = TB.radiance_bvh_cuda(sc, key, n, spp, w, **opts)
    rec, codes = TB.radiance_bvh_cuda(sc, key, n, spp, w, record=True, **opts)
    torch.cuda.synchronize()
    ids, px, py = TK.prep_rays(torch.arange(w * h, device=cuda_device), spp,
                               w)
    plain, want = TB.radiance_bvh_plain(sc, key, ids, px, py, record=True,
                                        **opts)
    assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(rec.view(torch.int32), ker.view(torch.int32))
    assert torch.equal(codes, want)
    fog = (codes >= 0) & ((codes & TB.REC_SLOT) >= sc.mv_base)
    assert bool(fog.any())
    if inside:  # most primary rays scatter in the fog around the camera
        assert float(fog[0].float().mean()) > 0.3
    for view in ("normal", "random"):
        v_opts = dict(opts, max_depth=1)
        got = TB.radiance_bvh_cuda(sc, key, n, spp, w, debug=view, **v_opts)
        plain_v = TB.radiance_bvh_plain(sc, key, ids, px, py, debug=view,
                                        **v_opts)
        assert torch.equal(got.view(torch.int32), plain_v.view(torch.int32))
    assert TB.MV_LAUNCHES == before + 4

    args = (codes, *TB.fetch_inputs(sc))
    rows, kind = TF.fetch_rows_cuda(*args)
    want_rows, want_kind = TF.fetch_rows_plain(*args)
    assert torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
    assert torch.equal(kind, want_kind)
    g = torch.tensor(np.random.default_rng(0).standard_normal(
        tuple(rows.shape)), dtype=torch.float32, device=cuda_device)
    kinds, tri_base, sph_mat, tri_mat, _, sph_geo, tri_geo, raw, mv_base, \
        mv_mat = args[1:]
    targs = (codes, g, tri_base, sph_mat, tri_mat, kinds.shape[0],
             sph_geo.shape[0], tri_geo.shape[0], raw, mv_base, mv_mat)
    exact = TF.fetch_rows_transpose_plain(codes, g.double(), *targs[2:])
    for got, want_t in zip(TF.fetch_rows_transpose_cuda(*targs), exact):
        assert (got is None) == (want_t is None)
        if want_t is not None:
            tol = 1e-5 * want_t.abs() + 1e-6 * want_t.abs().max()
            assert bool(((got.double() - want_t).abs() <= tol).all())

    if depth == 1:  # a primary hit's radiance moves no geometry row
        return
    cts = torch.tensor(np.random.default_rng(1).standard_normal(
        (n, 3)), dtype=torch.float32, device=cuda_device)
    grad_want = TB.radiance_grad_plain(sc, key, cts, w * h, spp, w, **opts)
    rows_in = [None if v is None else v.detach().requires_grad_(True)
               for v in TB._rows(sc)]
    rad = TB.radiance(sc.with_rows(*rows_in), key, w * h, spp, w, **opts)
    got = torch.autograd.grad(rad, [v for v in rows_in if v is not None],
                              cts)
    for a, b in zip(got, [v for v in grad_want if v is not None]):
        assert bool(torch.isfinite(a).all())
        tol = 2e-3 * b.abs() + 2e-5 * b.abs().max()
        assert bool(((a - b).abs() <= tol).all())
    assert got[1].abs().sum() > 0  # the material table


@pytest.mark.gpu
def test_mesh_volume_fit_on_card(cuda_device):
    """The fit of a fog_sheet's albedos and emissions launches record #5,
    #6 and #7 once a step, its mesh-volume variant, and its loss falls."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.ops import fetch as TF

    scene = _fog(4)
    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 32, 24, seed=1,
        device=cuda_device)
    counts = (TB.RECORD_LAUNCHES, TB.MV_LAUNCHES, TF.FETCH_LAUNCHES,
              TF.TRANSPOSE_LAUNCHES)
    _, _, history = fit(scene, target, ["albedo", "emission"], 32, 24,
                        steps=3, device=cuda_device, seed=1,
                        resample_every=0)
    assert (TB.RECORD_LAUNCHES, TB.MV_LAUNCHES, TF.FETCH_LAUNCHES,
            TF.TRANSPOSE_LAUNCHES) == tuple(c + 3 for c in counts)
    assert all(np.isfinite(history)) and history[-1] < history[0]


# ------------------------------------------------ the brute kernels' kTri

def brute_tri_builder(mod, name, depth=3, spp=2, sky=False):
    """Triangle scenes built without their BVH, for either package:
    "tri" is tests/test_pallas.py::_tri_builder (a Lambertian tetrahedron,
    a metal triangle, a ground triangle and an emitter sphere), "tri_only"
    the same without the sphere, "tri_mix" with a mix (Lambertian, metal)
    in the metal triangle's place, "tri_grad" with a metal sphere beside
    the emitter under a gradient background (a path's radiance then
    depends on each triangle's t), "zoo" :func:`brute_ext_builder`'s mini
    zoo (or under its 16x32 sky) with a triangle of its mix material, an
    isotropic triangle beside its fog sphere and a glass one, "fan" the
    600-triangle fan of test_pallas_triangle_chunking (two 512-triangle
    chunks)."""
    mesh = mod.models.mesh.Mesh

    def add(b, verts, faces, mat):
        v = np.asarray(verts, np.float32)
        b.add_mesh(mesh.from_buffers(v, v, np.asarray(faces, np.int32),
                                     mat))

    if name == "zoo":
        b = brute_ext_builder(mod, depth, spp, sky)
        glass = b.add_material(mod.Dielectric(1.5))
        add(b, [[-1.5, 0, -0.8], [-0.3, 0, -0.9], [-0.9, 1.2, -0.85]],
            [[0, 1, 2]], 2)  # the mix
        add(b, [[0.3, -0.2, 0.9], [0.9, -0.2, 0.7], [0.6, 0.7, 0.8]],
            [[0, 1, 2]], 4)  # isotropic, beside the fog
        add(b, [[-0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0, 0.9, 0.2]],
            [[0, 1, 2]], glass)
        return b
    b = mod.SceneBuilder()
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth,
                                    enable_bvh_tree=False)
    if name == "fan":
        n = 600
        ang = np.linspace(0, 2 * np.pi, n + 1)
        rim = np.stack([0.8 * np.cos(ang), 0.3 + 0.0 * ang,
                        -1.0 + 0.8 * np.sin(ang)], -1)
        b.camera = mod.Camera.create((0, 1.5, 1.5), (0, 0.2, -1.0),
                                     (0, 1, 0), 60.0, 1.0)
        faces = np.stack([np.zeros(n), np.arange(1, n + 1),
                          np.arange(2, n + 2)], -1)
        add(b, np.concatenate([[[0.0, 0.3, -1.0]], rim]), faces,
            b.add_material(mod.Lambertian((0.6, 0.6, 0.2))))
        return b
    b.camera = mod.Camera.create((0, 0.6, 2.0), (0, 0.2, 0), (0, 1, 0),
                                 60.0, 1.0)
    if sky:
        b.background = brute_ext_builder(mod, sky=True).background
    elif name == "tri_grad":
        b.background = mod.Background.gradient((0.5, 0.7, 1.0),
                                               (1.0, 1.0, 1.0))
    ml = b.add_material(mod.Lambertian((0.7, 0.4, 0.2)))
    mm = b.add_material(mod.Metal((0.9, 0.9, 0.95), 0.05)
                        if name != "tri_mix" else mod.MixMaterial(
                            mod.Lambertian((0.2, 0.5, 0.8)),
                            mod.Metal((0.9, 0.9, 0.95), 0.05), 0.4))
    add(b, [[0, 0, 0], [0.6, 0, 0.1], [0.3, 0, -0.5], [0.3, 0.7, -0.1]],
        [[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 2, 1]], ml)
    add(b, [[-1.0, 0, -0.5], [-0.2, 0, -0.6], [-0.6, 0.8, -0.55]],
        [[0, 1, 2]], mm)
    add(b, [[-20, 0, -20], [20, 0, -20], [0, 0, 20]], [[0, 1, 2]], ml)
    if name != "tri_only":
        b.add_sphere((1.2, 1.5, 0.5), 0.5,
                     b.add_material(mod.Emission((2.0, 1.8, 1.5))))
    if name == "tri_grad":
        b.add_sphere((0.9, 0.3, 0.1), 0.3,
                     b.add_material(mod.Metal((0.8, 0.85, 0.9), 0.1)))
    return b


# each variant of the kernels' triangle branch: (builder args, kExt, kSky)
_BRUTE_TRI = {
    "tri": (("tri",), False, False),
    "tri_only": (("tri_only",), False, False),
    "ext-tri": (("zoo",), True, False),
    "sky-tri": (("tri",), False, True),
    "ext-sky-tri": (("zoo",), True, True),
}


def _brute_tri(name, depth):
    args, _, sky = _BRUTE_TRI[name]
    return brute_tri_builder(T, *args, depth=depth, sky=sky).build()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_BRUTE_TRI))
def test_brute_tri_kernel_matches_plain_on_card(cuda_device, name):
    """Kernel #1's kTri variants (alone, with kExt, kSky, both) bit for bit
    equal to their plain version at depth 1 and 6 (as chip_smoke.py phase
    14); each launch counts as its variants."""
    w, h = 64, 48
    _, ext, with_sky = _BRUTE_TRI[name]
    for depth in (1, 6):
        scene = _brute_tri(name, depth)
        fp, kinds, opts, sky = _brute_inputs(scene, w, h, cuda_device)
        key = trng.base_key(11)
        spp = scene.settings.samples_per_pixel
        counts = (TK.LAUNCHES, TK.EXT_LAUNCHES, TK.SKY_LAUNCHES,
                  TK.TRI_LAUNCHES)
        ker = TK.radiance_cuda(fp, kinds, key, w * h * spp, spp, w, sky=sky,
                               **opts)
        torch.cuda.synchronize()
        assert (TK.LAUNCHES, TK.EXT_LAUNCHES, TK.SKY_LAUNCHES,
                TK.TRI_LAUNCHES) == (counts[0] + 1, counts[1] + ext,
                                     counts[2] + with_sky, counts[3] + 1)
        ids, px, py = TK.prep_rays(torch.arange(w * h, device=cuda_device),
                                   spp, w)
        plain = TK.radiance_plain(fp, kinds, key, ids, px, py, sky=sky,
                                  **opts)
        assert torch.equal(ker.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_BRUTE_TRI))
def test_brute_tri_gradients_match_plain_on_card(cuda_device, name):
    """Kernel #3's kTri variants and, without a sky map, kernel #4's
    against autograd through the plain version at depth 6: every entry
    within rtol 2e-3 plus 2e-5 of the largest, the triangles' material
    slots included."""
    w, h = 48, 32
    scene = _brute_tri(name, 6)
    fp, kinds, opts, sky = _brute_inputs(scene, w, h, cuda_device)
    key = trng.base_key(5)
    spp = scene.settings.samples_per_pixel
    gen = np.random.default_rng(0)
    cts = torch.tensor(gen.standard_normal((w * h * spp, 3)),
                       dtype=torch.float32, device=cuda_device)
    before = (TR.TRI_LAUNCHES, TM.TRI_LAUNCHES)
    got = TR.radiance_grad_cuda(fp, kinds, key, cts, spp, w, sky=sky, **opts)
    want = TR.radiance_grad_plain(fp, kinds, key, cts, spp, w, sky=sky,
                                  **opts)
    for a, b in zip(*((got, want) if sky is not None else ([got], [want]))):
        assert bool(torch.isfinite(a).all()) and b.abs().max() > 0
        assert _close(a, b)
    if sky is not None:
        assert (TR.TRI_LAUNCHES, TM.TRI_LAUNCHES) == (before[0] + 1,
                                                      before[1])
        return
    slots = (fp.shape[0] - opts["n_tm"] * TK.tri_stride(opts["mix"]))
    assert want[slots:].abs().max() > 0  # the slots' materials
    target = torch.tensor(gen.random((w * h, 3)), dtype=torch.float32,
                          device=cuda_device)
    clamp = scene.settings.clamp_indirect
    loss, dfp = TM.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                 clamp=clamp, **opts)
    assert (TR.TRI_LAUNCHES, TM.TRI_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    fpg = fp.clone().requires_grad_(True)
    p_loss = TM.mse_loss_plain(fpg, kinds, key, target, spp, w, clamp=clamp,
                               **opts)
    (p_dfp,) = torch.autograd.grad(p_loss, fpg)
    assert abs(loss.item() - p_loss.item()) <= 1e-5 * p_loss.item()
    assert _close(dfp, p_dfp)


# each variant of the fused loss kernel: (scene, kExt, kTri)
_FUSED_VARIANTS = {
    "spheres": (lambda: _benchmark_like(gradient=True), 0, 0),
    "ext": (lambda: brute_ext_builder(T, 6).build(), 1, 0),
    "tri": (lambda: brute_tri_builder(T, "tri_grad", depth=6).build(), 0, 1),
    "ext-tri": (lambda: brute_tri_builder(T, "zoo", depth=6).build(), 1, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 5, 8, 48])
@pytest.mark.parametrize("name", list(_FUSED_VARIANTS))
def test_fused_loss_lane_groups_match_plain_on_card(cuda_device, name, spp):
    """Kernel #4's lane groups (one thread a sample, a pixel's samples on
    consecutive lanes): one sample, a group leaving lanes of a warp idle,
    a group of 8, a group spanning warps; on a 13x11 frame, whose 143
    pixels fill no whole block, in each variant.  The loss within 1e-5
    and the gradient within rtol 2e-3 plus 2e-5 of the largest of
    autograd through the plain version."""
    make, ext, tri = _FUSED_VARIANTS[name]
    scene = make()
    w, h = 13, 11
    fp, kinds, opts, _ = _brute_inputs(scene, w, h, cuda_device)
    opts["max_depth"] = 6
    key = trng.base_key(9)
    gen = np.random.default_rng(spp)
    target = torch.tensor(gen.random((w * h, 3)), dtype=torch.float32,
                          device=cuda_device)
    clamp = scene.settings.clamp_indirect
    before = (TM.LAUNCHES, TM.EXT_LAUNCHES, TM.TRI_LAUNCHES)
    loss, dfp = TM.mse_loss_cuda(fp, kinds, key, target, spp, w,
                                 clamp=clamp, **opts)
    assert (TM.LAUNCHES, TM.EXT_LAUNCHES, TM.TRI_LAUNCHES) == (
        before[0] + 1, before[1] + ext, before[2] + tri)
    fpg = fp.clone().requires_grad_(True)
    want = TM.mse_loss_plain(fpg, kinds, key, target, spp, w, clamp=clamp,
                             **opts)
    (want_dfp,) = torch.autograd.grad(want, fpg)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    assert bool(torch.isfinite(dfp).all()) and want_dfp.abs().max() > 0
    assert _close(dfp, want_dfp)


@pytest.mark.gpu
def test_brute_tri_render_and_fit_on_card(cuda_device):
    """A triangle scene built without its BVH renders on #1's kTri variant
    and fits on #4's (make_loss under autograd), the loss falling; built
    with its BVH it takes #5."""
    from raytracingrust_tpu_torch.diff.inverse import fit
    from raytracingrust_tpu_torch.render.render import select_engine

    scene = brute_tri_builder(T, "zoo", depth=4).build()
    assert select_engine(scene) == select_engine(scene, grad=True) == "brute"
    before = (TK.TRI_LAUNCHES, TM.TRI_LAUNCHES, TB.LAUNCHES)
    target = T.render_linear(TG.apply_params(scene, {
        "albedo": scene.materials.albedo * 0.6}), 48, 32, seed=1,
        device=cuda_device)
    _, _, history = fit(scene, target, ["albedo", "emission"], 48, 32,
                        steps=3, device=cuda_device, resample_every=0)
    assert (TK.TRI_LAUNCHES, TM.TRI_LAUNCHES, TB.LAUNCHES) == (
        before[0] + 1, before[1] + 3, before[2])
    assert all(np.isfinite(history)) and history[-1] < history[0]
    with_bvh = brute_tri_builder(T, "zoo", depth=4).build(with_bvh=True)
    assert select_engine(with_bvh) == "bvh"
