"""The port's fit path on the CPU: ``make_loss`` (the fused loss's plain
version), ``fit`` and the CLI ``fit``, against the JAX package's
``make_loss(engine="pallas")`` (the fused kernel in interpret mode) and
``fit``."""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import jax
import numpy as np

from raytracingrust_tpu.diff import grad as JG
from raytracingrust_tpu.diff.inverse import fit as j_fit
from raytracingrust_tpu.models.scene import SceneBuilder as JBuilder
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.diff.inverse import fit
from raytracingrust_tpu_torch.io.png import read_png
from raytracingrust_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracingrust_tpu_torch.utils import rng as trng

BENCH = os.path.join(os.path.dirname(__file__), "..", "scenes",
                     "benchmark.json")
W, H = 16, 12
BENCH_PARAMS = ("albedo", "fuzz", "ir", "emission", "cam_lookfrom",
                "bg_color_a")


def _bench_pair(spp, depth):
    out = []
    for builder in (JBuilder, TBuilder):
        b = builder.from_file(BENCH)
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                         max_ray_depth=depth)
        out.append(b.build(with_bvh=False) if builder is JBuilder
                   else b.build())
    return out


def _target():
    return np.random.default_rng(1).random((H, W, 3)).astype(np.float32)


# ------------------------------------------------- (c) the fused loss path

# depth 3, not bench.py's 6: the JAX fused kernel's interpret-mode compile
# takes ~35 s at depth 6 and ~15 s at depth 3
FUSED_CASES = [(5, 1), (4, 1), (5, 3), (4, 3)]


@pytest.fixture(scope="module")
def fused_refs():
    """jax.value_and_grad of the JAX fused kernel's loss (interpret mode)
    with bench.py's six parameters, for each (spp, depth) of FUSED_CASES:
    all lowered first, then compiled together on threads at XLA's backend
    optimisation level 0 (the same IEEE operations, less LLVM work)."""
    target = _target()
    jobs = {}
    for spp, depth in FUSED_CASES:
        j, _ = _bench_pair(spp, depth)
        params = JG.extract_params(j, BENCH_PARAMS)
        jobs[spp, depth] = (jax.jit(jax.value_and_grad(JG.make_loss(
            j, target, W, H, engine="pallas"))).lower(params), params)
    with ThreadPoolExecutor(len(jobs)) as ex:
        compiled = dict(zip(jobs, ex.map(
            lambda job: job[0].compile(compiler_options={
                "xla_backend_optimization_level": 0}), jobs.values())))
    return {k: compiled[k](params) for k, (_, params) in jobs.items()}


@pytest.mark.parametrize("spp,depth", FUSED_CASES)
def test_make_loss_matches_jax_fused(fused_refs, spp, depth):
    """Port make_loss against jax.value_and_grad of the JAX fused kernel
    (interpret mode), with bench.py's six parameters.  At depth 1 the
    radiance is bit for bit equal, so only the sums' order differs; deeper,
    a few sin/cos-ulp path flips remain, and the bounds are the JAX
    package's own fused-vs-two-pass ones (tests/test_pallas.py)."""
    _, t = _bench_pair(spp, depth)
    target = _target()
    want_v, want_g = fused_refs[spp, depth]
    got_v, got_g = TG.render_and_grad(t, target, BENCH_PARAMS, W, H,
                                      device="cpu")
    if depth == 1:
        rtol_v, rtol_g, atol_g = 1e-6, 1e-5, 0.0
    else:
        rtol_v, rtol_g, atol_g = 1e-2, 5e-2, 1e-3
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=rtol_v)
    for k in BENCH_PARAMS:
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=rtol_g, atol=atol_g, err_msg=k)
    # the no-grad loss (the kernel #2 path on the card) equals it
    loss = TG.make_loss(t, target, W, H, device="cpu")
    with torch.no_grad():
        plain = float(loss(TG.extract_params(t, BENCH_PARAMS)))
    np.testing.assert_allclose(plain, float(got_v), rtol=1e-5)


def test_loss_key_overrides_seed():
    _, t = _bench_pair(2, 3)
    loss = TG.make_loss(t, _target(), W, H, seed=0, device="cpu")
    params = TG.extract_params(t, ["albedo"])
    with torch.no_grad():
        a = float(loss(params))
        b = float(loss(params, trng.base_key(0)))
        c = float(loss(params, trng.base_key(1)))
    assert a == b and a != c


def test_unported_options_raise():
    _, t = _bench_pair(2, 2)
    with pytest.raises(NotImplementedError, match="A9"):
        TG.make_loss(t, _target(), W, H, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A10"):
        fit(t, _target(), ["albedo"], W, H, steps=1, device="cpu",
            checkpoint_path="ckpt")
    with pytest.raises(NotImplementedError, match="A9"):
        fit(t, _target(), ["albedo"], W, H, steps=1, device="cpu",
            sharded=True)


# -------------------------------------------------------------- (e) the fit

def test_fit_history_matches_jax():
    """Three Adam steps, each on a fresh seed, against the JAX fit through
    its fused kernel: the loss histories agree within 1%."""
    j, t = _bench_pair(4, 3)
    target = T.render_linear(t, W, H, seed=7, device="cpu").numpy() * 0.9
    names = ["albedo", "emission", "bg_color_a"]
    _, _, want = j_fit(j, target, names, W, H, steps=3, engine="pallas")
    _, params, got = fit(t, target, names, W, H, steps=3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert set(params) == set(names)


def _builder(spp):
    """tests/test_grad.py::builder, in the port."""
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0, 0, 0.4), (0, 0, -1), (0, 1, 0), 70.0, 1.0)
    b.settings = T.RenderSettings(samples_per_pixel=spp, max_ray_depth=4)
    m1 = b.add_material(T.Lambertian((0.6, 0.3, 0.2)))
    m2 = b.add_material(T.Metal((0.9, 0.8, 0.7), 0.2))
    m3 = b.add_material(T.Emission((1.5, 1.0, 0.5)))
    m4 = b.add_material(T.Dielectric(1.5))
    b.add_sphere((0.0, -0.25, -1.0), 0.35, m1)
    b.add_sphere((0.75, 0.1, -1.3), 0.4, m2)
    b.add_sphere((-0.75, 0.1, -1.3), 0.4, m3)
    b.add_sphere((0.0, 0.65, -1.2), 0.3, m4)
    return b


def test_inverse_rendering_recovers_albedo():
    """tests/test_grad.py::test_inverse_rendering_recovers_albedo on the
    port's plain path: perturb an albedo, fit it back against a spp-32
    target; the loss falls to the Monte-Carlo noise floor and the albedo
    is recovered."""
    w = h = 8
    target = T.render_linear(_builder(32).build(), w, h, seed=7,
                             device="cpu")
    scene = _builder(8).build()
    albedo = scene.materials.albedo.clone()
    albedo[0] = torch.tensor([0.2, 0.7, 0.6])
    wrong = TG.apply_params(scene, {"albedo": albedo})
    out, params, history = fit(
        wrong, target, ["albedo"], w, h, steps=60, learning_rate=5e-2,
        constraints={"albedo": (0.0, 1.0)}, device="cpu")
    floor = float(torch.mean(
        (T.render_linear(scene, w, h, seed=999, device="cpu") - target) ** 2))
    tail = float(np.mean(history[-5:]))
    assert tail < max(3.0 * floor, 0.3 * history[0]), (
        f"tail={tail:.5g} floor={floor:.5g} start={history[0]:.5g}")
    np.testing.assert_allclose(out.materials.albedo[0].numpy(),
                               [0.6, 0.3, 0.2], atol=0.08)
    assert float(params["albedo"].min()) >= 0.0


# ------------------------------------------------------------- (f) the CLI

def test_cli_fit_on_cpu(tmp_path, capsys):
    target = str(tmp_path / "target.png")
    out = str(tmp_path / "fitted.png")
    flags = ["--spp", "2", "--depth", "2", "--device", "cpu"]
    assert cli.main(["render", BENCH, "--width", "12", "--height", "8",
                     "-o", target, *flags]) == 0
    assert cli.main(["fit", BENCH, target, "--params", "albedo,bg_color_a",
                     "--steps", "2", "--lr", "0.01", "-o", out,
                     *flags]) == 0
    text = capsys.readouterr().out
    assert "step 0: loss" in text and "final loss" in text
    final = float(text.split("final loss")[1].split()[0])
    assert np.isfinite(final)
    assert read_png(out).shape == (8, 12, 4)
