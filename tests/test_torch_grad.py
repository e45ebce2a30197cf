"""The port's gradients against the JAX package's, and against finite
differences of the port's own loss.

On the CPU the port differentiates its plain PyTorch version with autograd;
the CUDA gradient kernels are held to that on the card by
tests/test_torch_gpu.py and chip_smoke.py.  The JAX references run the
Pallas kernels in interpret mode, as the JAX package's own tests run them,
once per module.
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
from raytracingrust_tpu.models.scene import SceneBuilder as JBuilder
from raytracingrust_tpu.ops import pallas_megakernel as PK
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.models.backgrounds import UNIFORM
from raytracingrust_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.ops import radiance_grad as TR
from raytracingrust_tpu_torch.utils import rng as trng

BENCH = os.path.join(os.path.dirname(__file__), "..", "scenes",
                     "benchmark.json")
W, H = 16, 12


def _bench_pair(spp, depth, gradient=False):
    """scenes/benchmark.json in both packages, optionally with a gradient
    background (the radiance then depends on ray directions)."""
    out = []
    for mod, builder in ((J, JBuilder), (T, TBuilder)):
        b = builder.from_file(BENCH)
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                         max_ray_depth=depth)
        if gradient:
            b.background = mod.Background.gradient((0.5, 0.7, 1.0),
                                                   (1.0, 1.0, 1.0))
        out.append(b.build(with_bvh=False) if builder is JBuilder
                   else b.build())
    return out


# --------------------------------------------------------------- (a) params

def test_param_paths_match_jax():
    assert TG.PARAM_PATHS == JG.PARAM_PATHS


def test_extract_apply_round_trip():
    _, t = _bench_pair(2, 2)
    names = list(TG.PARAM_PATHS)
    params = TG.extract_params(t, names)
    assert set(params) == set(names)
    bumped = {k: v + 0.25 for k, v in params.items()}
    back = TG.extract_params(TG.apply_params(t, bumped), names)
    for k in names:
        assert torch.equal(back[k], bumped[k]), k
    # the original scene is untouched
    for k, v in TG.extract_params(t, names).items():
        assert torch.equal(v, params[k]), k


# ------------------------------------------- (b) the radiance gradient path

# (background, depth): the kernel pair's interpret-mode compile grows by
# ~7 s a bounce (~95 s at depth 6), so both run at depth 2, one scattering
# bounce and the bounce after it; depth 6 is held on the card
# (tests/test_torch_gpu.py, chip_smoke.py), kernels against autograd
VJP_CASES = [("uniform", 2), ("gradient", 2)]


def _vjp_job(bg, depth):
    """One case of :func:`radiance_vjps`: its scenes and inputs, the
    port's forward radiance, and JAX's jitted forward-and-vjp, lowered."""
    j, t = _bench_pair(4, depth, bg == "gradient")
    spp = 4
    ray_ids, px, py, rows, n = PK._prep_rays(
        np.arange(W * H, dtype=np.int32), spp, W)
    fn = PK._radiance_cvjp(len(j.spheres), depth, PK._sphere_kinds(j),
                           j.background.kind, False, rows, True)
    words = np.array(trng.base_key(0), np.uint32).view(np.int32)
    fp = np.asarray(PK._pack_fparams(j, W, H))
    cts = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)

    ids_t, px_t, py_t = TK.prep_rays(torch.arange(W * H), spp, W)
    kinds = TK.sphere_kinds(t)
    port_rad = TK.radiance_plain(torch.tensor(fp), kinds, trng.base_key(0),
                                 ids_t, px_t, py_t, max_depth=depth,
                                 bg_kind=t.background.kind,
                                 clay=False).numpy()

    def fwd_vjp(f, c):
        outs, vjp = jax.vjp(lambda f: fn(f, words, ray_ids, px, py), f)
        return outs, vjp(c)[0]

    def blocks(col):
        v = np.zeros(rows * PK.BLOCK_COLS, np.float32)
        v[:n] = col
        return jnp.asarray(v.reshape(rows, PK.BLOCK_COLS))

    zero = tuple(blocks(cts[:, c] * 0) for c in range(3))
    lowered = jax.jit(fwd_vjp).lower(jnp.asarray(fp), zero)
    return dict(t=t, fp=fp, cts=cts, port_rad=port_rad, n=n, spp=spp,
                depth=depth, blocks=blocks, zero=zero, lowered=lowered)


@pytest.fixture(scope="module")
def radiance_vjps():
    """JAX's jax.vjp of _radiance_cvjp (the two-pass kernel pair) on
    numpy-seeded per-ray cotangents, at benchmark 16x12 spp 4, for each
    case of VJP_CASES: both lowered first, then compiled together on
    threads at XLA's backend optimisation level 0 (the same IEEE
    operations, less LLVM work).  Cotangents are zeroed on rays whose
    forward radiance differs from the port's by more than 1e-5
    (sin/cos-ulp path flips)."""
    jobs = {case: _vjp_job(*case) for case in VJP_CASES}
    with ThreadPoolExecutor(len(jobs)) as ex:
        compiled = dict(zip(jobs, ex.map(
            lambda job: job["lowered"].compile(compiler_options={
                "xla_backend_optimization_level": 0}), jobs.values())))
    out = {}
    for case, r in jobs.items():
        run, n, fp = compiled[case], r["n"], jnp.asarray(r["fp"])
        # the forward alone first, to find the flipped rays
        outs, _ = run(fp, r["zero"])
        jax_rad = np.stack([np.asarray(o).reshape(-1)[:n] for o in outs], -1)
        flipped = (np.abs(jax_rad - r["port_rad"]) > 1e-5).any(axis=1)
        cts = r["cts"]
        cts[flipped] = 0.0
        _, want = run(fp, tuple(r["blocks"](cts[:, c]) for c in range(3)))
        out[case] = dict(t=r["t"], fp=r["fp"], cts=cts, want=np.asarray(want),
                         flipped=int(flipped.sum()), n=n, spp=r["spp"],
                         depth=r["depth"])
    return out


@pytest.fixture(scope="module", params=VJP_CASES,
                ids=["uniform-d2", "gradient-d2"])
def radiance_vjp(request, radiance_vjps):
    """One case of :func:`radiance_vjps`."""
    return radiance_vjps[request.param]


def test_radiance_grad_matches_jax(radiance_vjp):
    """The port's gradient by autograd (the plain version of kernel #3)
    against jax.vjp of the JAX kernel pair, with the bounds of
    tests/test_pallas.py's kernel-vs-XLA gradient checks.  Where JAX's
    gradient is NaN (a gradient background: jax.vjp differentiates
    sqrt(max(disc, 0)) on spheres the ray misses), only its finite entries
    are compared, and the port's must be finite everywhere."""
    r = radiance_vjp
    t = r["t"]
    assert r["flipped"] <= 0.02 * r["n"]
    got = TR.radiance_grad_plain(
        torch.tensor(r["fp"]), TK.sphere_kinds(t), trng.base_key(0),
        torch.tensor(r["cts"]), r["spp"], W, max_depth=r["depth"],
        bg_kind=t.background.kind, clay=False).numpy()
    want = r["want"]
    assert np.isfinite(got).all()
    finite = np.isfinite(want)
    if t.background.kind == UNIFORM:
        assert finite.all()
    scale = np.abs(want[finite]).max()
    np.testing.assert_allclose(got[finite], want[finite], rtol=2e-3,
                               atol=2e-5 * scale)
    # the gradient reaches the parameters the fit trains
    assert np.abs(got[TK._BG:TK._BG + 3]).min() > 0


def test_render_linear_differentiable_on_cpu():
    """render_linear under autograd reaches the scene's leaves."""
    _, t = _bench_pair(2, 3, gradient=True)
    params = {k: v.clone().requires_grad_(True) for k, v in
              TG.extract_params(t, ["albedo", "bg_color_b",
                                    "cam_fov"]).items()}
    img = T.render_linear(TG.apply_params(t, params), 8, 6, seed=1,
                          device="cpu")
    img.sum().backward()
    for k, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k
        assert p.grad.abs().sum() > 0, k


def test_grad_kernel_depth_gate():
    _, t = _bench_pair(2, 13)
    with pytest.raises(ValueError, match="at most 12"):
        TK.check_depth(13)
    assert TK.MAX_DEPTH == PK.UNROLL_MAX_DEPTH
    from raytracingrust_tpu_torch.ops.mse_loss import supports_fused_mse
    assert not supports_fused_mse(t)
    assert supports_fused_mse(_bench_pair(2, 12)[1])


# --------------------------------------------------- (d) finite differences

def _builder():
    """tests/test_grad.py::builder, in the port."""
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0, 0, 0.4), (0, 0, -1), (0, 1, 0), 70.0, 1.0)
    b.settings = T.RenderSettings(samples_per_pixel=2, max_ray_depth=4)
    m1 = b.add_material(T.Lambertian((0.6, 0.3, 0.2)))
    m2 = b.add_material(T.Metal((0.9, 0.8, 0.7), 0.2))
    m3 = b.add_material(T.Emission((1.5, 1.0, 0.5)))
    m4 = b.add_material(T.Dielectric(1.5))
    b.add_sphere((0.0, -0.25, -1.0), 0.35, m1)
    b.add_sphere((0.75, 0.1, -1.3), 0.4, m2)
    b.add_sphere((-0.75, 0.1, -1.3), 0.4, m3)
    b.add_sphere((0.0, 0.65, -1.2), 0.3, m4)
    return b


def _bg_only():
    """tests/test_grad.py's bg_only scene: a gradient background only."""
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0.2, -0.1, 0.3), (0.1, 0.2, -1), (0, 1, 0),
                               70.0, 1.0)
    b.settings = T.RenderSettings(samples_per_pixel=2, max_ray_depth=3)
    b.background = T.Background.gradient((0.2, 0.4, 0.9), (0.9, 0.9, 0.8))
    m = b.add_material(T.Lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, 50.0), 0.5, m)  # behind the camera: never seen
    return b


def _wall():
    """tests/test_grad.py's wall scene: a sphere filling the frame."""
    b = T.SceneBuilder()
    b.camera = T.Camera.create((0, 0, 2.0), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    b.settings = T.RenderSettings(samples_per_pixel=8, max_ray_depth=2)
    b.background = T.Background.gradient((0.1, 0.3, 0.9), (1.0, 0.9, 0.7))
    m = b.add_material(T.Lambertian((0.6, 0.4, 0.3)))
    b.add_sphere((0, 0, 0), 1.5, m)
    return b


def fd_check(names, rel_tol=5e-2, abs_floor=1e-4, eps=3e-4,
             make_builder=_builder):
    """tests/test_grad.py::fd_check on the port's plain loss: AD against
    central differences, skipping coordinates whose FD at eps and 4 eps
    disagree (a visibility or branch discontinuity straddled)."""
    scene = make_builder().build()
    w = h = 8
    target = np.random.RandomState(0).rand(h, w, 3).astype(np.float32)
    loss = TG.make_loss(scene, target, w, h, seed=0, device="cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in TG.extract_params(scene, names).items()}
    val = loss(params)
    assert np.isfinite(val.item())
    grads = dict(zip(names, torch.autograd.grad(val, [params[k]
                                                      for k in names])))

    for name in names:
        g = grads[name].numpy().astype(np.float64)
        assert np.isfinite(g).all(), name
        p0 = params[name].detach().numpy().astype(np.float64)
        flat = p0.reshape(-1)
        idxs = np.linspace(0, flat.size - 1, min(6, flat.size)).astype(int)

        def fd_at(i, e):
            def at(sign):
                delta = np.zeros_like(flat)
                delta[i] = sign * e
                pp = {k: v.detach() for k, v in params.items()}
                pp[name] = torch.tensor((flat + delta).reshape(p0.shape),
                                        dtype=torch.float32)
                with torch.no_grad():
                    return float(loss(pp))
            return (at(1) - at(-1)) / (2 * e)

        validated = 0
        for i in idxs:
            fd1 = fd_at(i, eps)
            fd2 = fd_at(i, eps * 4)
            if abs(fd1 - fd2) > 0.25 * max(abs(fd1), abs(fd2)) + abs_floor:
                continue  # straddles a visibility/branch discontinuity
            ad = g.reshape(-1)[i]
            err = abs(fd1 - ad)
            tol = rel_tol * max(abs(fd1), abs(ad)) + abs_floor
            assert err <= tol, (
                f"{name}[{i}]: AD={ad:.6g} FD={fd1:.6g} err={err:.3g}")
            validated += 1
        need = min(2, len(idxs))
        assert validated >= need, (
            f"{name}: too few smooth probes ({validated}/{len(idxs)})")


@pytest.mark.parametrize("names,kw", [
    (["albedo"], {}),
    (["emission"], {}),
    (["fuzz"], dict(rel_tol=0.1, abs_floor=3e-4)),
    (["bg_color_a"], {}),
    (["cam_fov"], dict(rel_tol=0.1, abs_floor=1e-5, eps=0.03,
                       make_builder=_bg_only)),
    (["cam_lookat"], dict(rel_tol=0.05, abs_floor=1e-5, eps=1e-3,
                          make_builder=_bg_only)),
    (["cam_lookfrom"], dict(rel_tol=0.1, abs_floor=1e-3, eps=2e-3,
                            make_builder=_wall)),
    (["sphere_radius"], dict(rel_tol=0.15, abs_floor=2e-3, eps=1e-4)),
], ids=["albedo", "emission", "fuzz", "bg", "cam_fov", "cam_lookat",
        "cam_lookfrom", "sphere_radius"])
def test_grad_matches_fd(names, kw):
    """tests/test_grad.py's FD checks, on the port.  These cover the
    gradients that are NaN in the JAX kernel's (fuzz, camera, geometry)."""
    fd_check(names, **kw)
