"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run on a machine that has PyTorch and CUDA alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.utils import rng as trng

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes",
                       "cornell_spheres.json")


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
