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
    return b.build(with_bvh=True)


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
