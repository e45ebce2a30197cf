"""The port's brute forward megakernel against the JAX package's Pallas
kernel (run in interpret mode on the CPU, as the JAX tests run it).

On the CPU the port runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that plain version on the card by
tests/test_torch_gpu.py.
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.models.scene import SceneBuilder as JBuilder
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render.render import render_linear as j_render_linear
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.render.render import (pixel_radiance,
                                                    render_linear)
from raytracingrust_tpu_torch.utils import rng as trng

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _load_pair(name, depth, mode="Full", spp=None):
    path = os.path.join(SCENES, f"{name}.json")
    out = []
    for builder in (JBuilder, TBuilder):
        b = builder.from_file(path)
        b.settings = dataclasses.replace(
            b.settings, max_ray_depth=depth, mode=mode,
            samples_per_pixel=spp or b.settings.samples_per_pixel)
        out.append(b.build(with_bvh=False) if builder is JBuilder
                   else b.build())
    return out


def _jax_per_ray(scene, w, h, seed):
    """Per-ray radiance (R, 3) straight from the JAX forward kernel."""
    spp = scene.settings.samples_per_pixel
    pid = np.arange(w * h, dtype=np.int32)
    ray_ids, px, py, rows, n = PK._prep_rays(pid, spp, w)
    fn = PK._radiance_cvjp(len(scene.spheres), scene.settings.max_ray_depth,
                           PK._sphere_kinds(scene), scene.background.kind,
                           scene.settings.mode == "Clay", rows, True)
    # the key words' bits as int32 (PK.seed_words converts by value and
    # overflows for words >= 2^31)
    words = np.array(trng.base_key(seed), np.uint32).view(np.int32)
    outs = fn(PK._pack_fparams(scene, w, h), words, ray_ids, px, py)
    return np.stack([np.asarray(o).reshape(-1)[:n] for o in outs], axis=-1)


def _port_per_ray(scene, w, h, seed, fparams=None):
    spp = scene.settings.samples_per_pixel
    ray_ids, px, py = TK.prep_rays(torch.arange(w * h), spp, w)
    if fparams is None:
        fparams = TK.pack_fparams(scene, w, h)
    return TK.radiance_plain(
        fparams, TK.sphere_kinds(scene), trng.base_key(seed), ray_ids, px,
        py, max_depth=scene.settings.max_ray_depth,
        bg_kind=scene.background.kind,
        clay=scene.settings.mode == "Clay").numpy()


@pytest.mark.parametrize("name,mode,seed", [
    ("benchmark", "Full", 0), ("benchmark", "Clay", 0),
    ("benchmark", "Full", 0xDEADBEEFCAFEBABE), ("cornell_spheres", "Full", 3),
])
def test_depth1_bitwise(name, mode, seed):
    """At depth 1 no scattered ray is traced, so camera, closest hit,
    emission and background must agree exactly.  The JAX kernel's own
    packed constants are fed in, so the comparison is of the kernel math
    alone; the port's own constants are equal too."""
    j, t = _load_pair(name, 1, mode, spp=2)
    w, h = 32, 26
    want = _jax_per_ray(j, w, h, seed)
    got = _port_per_ray(t, w, h, seed, fparams=torch.tensor(
        np.asarray(PK._pack_fparams(j, w, h))))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(_port_per_ray(t, w, h, seed), got)
    assert (got > 0).any()


def _benchmark_like(mod, builder, mode="Full", gradient=False):
    """tests/test_pallas.py::benchmark_like_builder, for either package."""
    b = builder()
    b.camera = mod.Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = mod.RenderSettings(samples_per_pixel=2, max_ray_depth=4,
                                    enable_bvh_tree=False, mode=mode)
    if gradient:
        b.background = mod.Background.gradient((0.5, 0.7, 1.0),
                                               (1.0, 1.0, 1.0))
    ground = b.add_material(mod.Lambertian((0.8, 0.8, 0.4)))
    red = b.add_material(mod.Lambertian((0.8, 0.1, 0.1)))
    mirror = b.add_material(mod.Metal((1.0, 1.0, 1.0), 0.03))
    glass = b.add_material(mod.Dielectric(1.5))
    sun = b.add_material(mod.Emission((2.0, 2.0, 2.0)))
    b.add_sphere((10, 15.8, -1), 10.0, sun)
    b.add_sphere((1, 0, -1), 0.5, mirror)
    b.add_sphere((-1, 0, -1), 0.5, glass)
    b.add_sphere((0, -0.2, -1), 0.3, red)
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    return b


@pytest.mark.parametrize("mode,gradient,frac", [
    ("Full", False, 0.08), ("Clay", False, 0.12), ("Full", True, 0.08)])
def test_full_depth_matches_jax_kernel(mode, gradient, frac):
    """Full depth, held to the JAX kernel as tests/test_pallas.py holds the
    JAX kernel to its XLA engine.  The two draw identical uniforms; the
    spread comes from transcendental ulps (sin/cos here, and rsqrt in the
    gradient background) between PyTorch and XLA, which flip discrete path
    decisions on the radius-100 ground sphere now and then."""
    j = _benchmark_like(J, JBuilder, mode, gradient).build(with_bvh=False)
    t = _benchmark_like(T, TBuilder, mode, gradient).build()
    want = np.asarray(j_render_linear(j, 16, 12, seed=0, engine="pallas"))
    got = render_linear(t, 16, 12, seed=0, device="cpu").numpy()
    mismatched = (~np.isclose(want, got, atol=1e-4, rtol=1e-3)).mean()
    assert mismatched <= frac, f"{mismatched:.4f} channels differ"
    assert np.abs(want - got).mean() < 4e-2


def test_gradient_background_depth1_within_one_ulp():
    """The gradient background normalizes with rsqrt in the JAX kernel and
    1/sqrt here: at depth 1 the two may differ by one ulp, no more."""
    j = _benchmark_like(J, JBuilder, gradient=True)
    t = _benchmark_like(T, TBuilder, gradient=True)
    j.settings = dataclasses.replace(j.settings, max_ray_depth=1)
    t.settings = dataclasses.replace(t.settings, max_ray_depth=1)
    want = _jax_per_ray(j.build(with_bvh=False), 16, 12, 1)
    got = _port_per_ray(t.build(), 16, 12, 1)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_pixel_radiance_is_clamped_spp_mean():
    _, t = _load_pair("benchmark", 3, spp=3)
    t.settings = dataclasses.replace(t.settings, clamp_indirect=0.7)
    w, h = 8, 6
    per_ray = _port_per_ray(t, w, h, 5)
    want = np.clip(per_ray, 0.0, 0.7).reshape(w * h, 3, 3).mean(axis=1)
    got = pixel_radiance(t, w, h, trng.base_key(5), torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_cpu_dispatch_runs_plain_version():
    _, t = _load_pair("benchmark", 4, spp=2)
    w, h = 8, 6
    got = TK.radiance(TK.pack_fparams(t, w, h), TK.sphere_kinds(t),
                      trng.base_key(2), w * h, 2, w, max_depth=4, bg_kind=0,
                      clay=False)
    np.testing.assert_array_equal(got.numpy(), _port_per_ray(t, w, h, 2))
    with pytest.raises(ValueError, match="CUDA"):
        TK.radiance_cuda(TK.pack_fparams(t, w, h), TK.sphere_kinds(t),
                         (0, 0), w * h * 2, 2, w, max_depth=4, bg_kind=0,
                         clay=False)


def test_tiles_equal_one_pass(monkeypatch):
    _, t = _load_pair("benchmark", 3, spp=2)
    whole = _port_per_ray(t, 8, 6, 4)
    monkeypatch.setattr(TK, "TILE_RAYS", 7)
    np.testing.assert_array_equal(_port_per_ray(t, 8, 6, 4), whole)


def test_observe_sees_each_bounce_and_changes_nothing():
    """``radiance_plain(observe=...)`` (chip_smoke.py's count of the work
    the rays traced) gets each bounce's masks and leaves the radiance as it
    was."""
    _, t = _load_pair("benchmark", 3, spp=2)
    w, h = 8, 6
    seen = []
    ids, px, py = TK.prep_rays(torch.arange(w * h), 2, w)
    got = TK.radiance_plain(
        TK.pack_fparams(t, w, h), TK.sphere_kinds(t), trng.base_key(4), ids,
        px, py, max_depth=3, bg_kind=0, clay=False,
        observe=lambda alive, hit, kind: seen.append(
            (int(alive.sum()), int((alive & hit).sum()))))
    np.testing.assert_array_equal(got.numpy(), _port_per_ray(t, w, h, 4))
    assert len(seen) == 3 and seen[0][0] == w * h * 2
    # a bounce's rays are among the rays that hit at the one before
    assert all(b[0] <= a[1] for a, b in zip(seen, seen[1:]))
