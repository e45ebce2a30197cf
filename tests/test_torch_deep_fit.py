"""Gradients of paths deeper than the brute kernels' 12-bounce tape.

The brute path's gradient kernels record at most ``megakernel.MAX_DEPTH``
bounces a ray, so a sphere scene the brute kernel renders takes the BVH
route (the record walk and the replay, which have no depth cap) when a
gradient is asked of a deeper render, and raises naming ROADMAP A6 when it
was built without its BVH: the JAX package's ``resolve_fit_engine`` sends
such chains to its BVH kernel too.  On the CPU the routes run their plain
versions; tests/test_torch_gpu.py fits the same scene on the card.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.diff import grad as JG
from raytracingrust_tpu.render.render import render_linear as j_render
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.diff import grad as TG
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.render.render import (render_linear,
                                                    select_engine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "scenes", "cornell_spheres.json")
BENCH = os.path.join(ROOT, "scenes", "benchmark.json")


def cornell(mod, depth=13, with_bvh=True):
    b = mod.SceneBuilder.from_file(CORNELL)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=1,
                                     max_ray_depth=depth)
    return b.build(with_bvh=with_bvh)


def test_deep_gradient_routing(tmp_path, capsys, monkeypatch):
    """Forward renders stay on the brute kernel at any depth; a gradient
    of a render deeper than 12 bounces takes "bvh" with the scene's BVH
    and raises naming ROADMAP A6 without it; at 12 it stays brute.
    ``render_linear`` under autograd takes the same route, and CLI ``info``
    names the same fit engine."""
    t = cornell(T)
    assert select_engine(t) == "brute"
    assert select_engine(t, grad=True) == "bvh"
    assert select_engine(cornell(T, depth=TK.MAX_DEPTH), grad=True) == "brute"
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        select_engine(cornell(T, with_bvh=False), grad=True)
    assert select_engine(cornell(T, with_bvh=False)) == "brute"

    calls = []
    real = BK.radiance

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(BK, "radiance", spy)
    t.materials.albedo.requires_grad_(True)
    render_linear(t, 4, 3, device="cpu").sum().backward()
    assert calls and t.materials.albedo.grad is not None
    with torch.no_grad():  # no gradient asked for: the brute kernel
        render_linear(t, 4, 3, device="cpu")
    assert len(calls) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TG.render_and_grad(cornell(T, with_bvh=False),
                           np.zeros((3, 4, 3), np.float32), ["albedo"], 4,
                           3, device="cpu")

    with open(BENCH) as f:
        d = json.load(f)
    d["settings"]["enable_bvh_tree"] = False
    deep = str(tmp_path / "bench_no_bvh.json")
    with open(deep, "w") as f:
        json.dump(d, f)
    for path, want in ((CORNELL, "bvh: record mode of #5"),
                       (deep, "unsupported: gradients of paths deeper")):
        assert cli.main(["info", path, "--depth", "13"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["render_engine"] == "brute: kernel #1"
        assert info["fit_engine"].startswith(want), info["fit_engine"]
    assert "ROADMAP A6" in info["fit_engine"]


@pytest.mark.parametrize("engine", ["auto", "pallas_bvh"])
def test_deep_cornell_gradient_matches_jax(engine):
    """The port's ``make_loss`` gradient of scenes/cornell_spheres.json at
    depth 13 (8x6 spp 1; the BVH route) against jax.grad of JAX
    ``make_loss`` with its own routing on this machine ("auto", its XLA
    integrator on a CPU) and with its BVH kernel (interpret mode): within
    rtol 1e-3 of each entry plus 1e-5 of the largest, in the albedos,
    emissions and sphere centers.  A pixel whose radiance differs between
    the two forwards by more than 1e-4 (a path flipped on the radius-1000
    walls' self-hit band; 1 of 48 here) is left out of both losses: its
    target is each package's own render there.  At this size no other
    scattered path reaches the lamp within 13 bounces in either package, so
    only the emission is live; test_deep_replay_matches_jax holds every
    bounce's gradient."""
    w, h = 8, 6
    j, t = cornell(J), cornell(T)
    names = ["albedo", "emission", "sphere_center"]
    target = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    eng = JG.resolve_fit_engine(j) if engine == "auto" else engine
    img_j = np.asarray(j_render(j, w, h, seed=3, engine=eng))
    t.materials.albedo.requires_grad_(True)
    img_t = render_linear(t, w, h, seed=3, device="cpu").detach().numpy()
    t.materials.albedo.requires_grad_(False)
    flip = (np.abs(img_j - img_t) > 1e-4).any(-1)
    assert flip.sum() <= 2, flip.sum()
    want = jax.jit(jax.grad(JG.make_loss(
        j, np.where(flip[..., None], img_j, target), w, h, seed=3,
        engine=engine)))(JG.extract_params(j, names))
    _, got = TG.render_and_grad(t, np.where(flip[..., None], img_t, target),
                                names, w, h, seed=3, device="cpu")
    live = 0
    for k in names:
        g, ref = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(g).all(), k
        tol = 1e-3 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert (np.abs(g - ref) <= tol).all(), (k, g, ref)
        live += bool(np.abs(ref).max() > 0)
    assert live >= 1 and np.abs(np.asarray(want["emission"])).max() > 0


def test_deep_replay_matches_jax():
    """The replay at depth 13 over the port's own record codes against JAX
    ``replay_radiance`` on the same codes, op by op, on the Cornell box
    under a gray sky (8x6 spp 2, so scattered paths escape and every bounce
    carries a gradient): radiance equal within atol 1e-5 (measured 0.0),
    and the VJP of a numpy-seeded cotangent in the albedos, emissions,
    sphere centers and radii and the background within rtol 1e-3 of each
    entry plus 1e-5 of the largest."""
    import jax.numpy as jnp

    import raytracingrust_tpu.ops.pallas_megakernel as PK
    from raytracingrust_tpu.diff.replay import replay_radiance
    from raytracingrust_tpu_torch.utils import rng as trng

    w, h, spp = 8, 6, 2
    j, t = (m.SceneBuilder.from_file(CORNELL) for m in (J, T))
    for b, mod in ((j, J), (t, T)):
        b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                         max_ray_depth=13)
        b.background = mod.Background.uniform((0.5, 0.5, 0.5))
    j, t = j.build(with_bvh=True), t.build(with_bvh=True)
    opts = dict(max_depth=13, bg_kind=t.background.kind, clay=False)
    ids, px, py = TK.prep_rays(torch.arange(w * h), spp, w)
    key = trng.base_key(3)
    with torch.no_grad():
        rad, codes = BK.radiance_bvh_plain(BK.pack(t, w, h, "cpu"), key,
                                           ids, px, py, record=True, **opts)
    assert (codes[-1] >= 0).any()  # paths alive at the last bounce
    n = rad.shape[0]
    cts = np.random.default_rng(0).standard_normal((n, 3)).astype(
        np.float32)
    jids, jpx, jpy, *_ = PK._prep_rays(jnp.arange(w * h, dtype=jnp.int32),
                                       spp, w)
    flat = lambda v: jnp.asarray(v).reshape(-1)[:n]
    rec = jnp.asarray(codes.numpy().T)
    words = jnp.asarray(np.array(key, np.uint32).view(np.int32))
    want, vjp = jax.vjp(lambda s: replay_radiance(
        s, rec, words, flat(jids), flat(jpx), flat(jpy), w, h), j)
    (d_scene,) = vjp(jnp.asarray(cts))
    names = ["albedo", "emission", "sphere_center", "sphere_radius",
             "bg_color_a"]
    params = {k: v.clone().requires_grad_(True) for k, v in
              TG.extract_params(t, names).items()}
    got = BK.replay(BK.pack(TG.apply_params(t, params), w, h, "cpu"), codes,
                    key, w * h, spp, w, **opts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    want_grads = JG.extract_params(d_scene, names)
    grads = torch.autograd.grad(got, list(params.values()), torch.tensor(cts))
    for k, g in zip(names, grads):
        ref = np.asarray(want_grads[k])
        tol = 1e-3 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert np.isfinite(g.numpy()).all(), k
        assert (np.abs(g.numpy() - ref) <= tol).all(), k
    for k in ("albedo", "emission", "bg_color_a"):
        assert np.abs(np.asarray(want_grads[k])).max() > 0, k
