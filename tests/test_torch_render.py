"""The port's render slice end to end on the CPU: scene JSON -> render_linear
-> gamma/RGBA8 -> PNG, and the CLI, against the JAX package."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from raytracingrust_tpu import cli as j_cli
from raytracingrust_tpu.io.png import read_png
from raytracingrust_tpu.models.scene import SceneBuilder as JBuilder
from raytracingrust_tpu.render.render import render_linear as j_render_linear
from raytracingrust_tpu_torch import cli
from raytracingrust_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracingrust_tpu_torch.ops.megakernel import select_engine
from raytracingrust_tpu_torch.render import render as R
from raytracingrust_tpu_torch.utils.color import to_rgba8

ROOT = os.path.join(os.path.dirname(__file__), "..")
BENCH = os.path.join(ROOT, "scenes", "benchmark.json")
CORNELL = os.path.join(ROOT, "scenes", "cornell_spheres.json")
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "benchmark.npz")


@pytest.fixture(scope="module")
def golden():
    rec = np.load(GOLDEN)
    return rec["img"], int(rec["width"]), int(rec["height"]), int(rec["seed"])


def test_render_linear_matches_golden(golden):
    """The port's image of the vendored benchmark scene against the JAX
    golden: mean abs diff within 1.5x the JAX engine's own seed-0-vs-1
    Monte-Carlo noise (bench.py::run_parity's full-depth criterion)."""
    img, w, h, seed = golden
    got = R.render_linear(TBuilder.from_file(BENCH).build(), w, h, seed=seed,
                          device="cpu")
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    other = np.asarray(j_render_linear(JBuilder.from_file(BENCH).build(), w,
                                       h, seed=seed + 1, engine="xla"))
    noise = np.abs(other - img).mean()
    assert np.abs(got.numpy() - img).mean() <= 1.5 * noise + 1e-6


def test_render_rgba8():
    img = R.render(TBuilder.from_file(BENCH).build(), 16, 12, seed=3,
                   device="cpu")
    assert img.shape == (12, 16, 4) and img.dtype == np.uint8
    assert (img[..., 3] == 255).all() and img[..., :3].std() > 0


def test_to_rgba8_floor_and_saturate():
    rgb = torch.tensor([[0.0, 0.5, 1.0], [-1.0, 2.0, 0.999]])
    np.testing.assert_array_equal(
        to_rgba8(rgb).numpy(),
        [[0, 127, 255, 255], [0, 255, 254, 255]])


def test_default_device_without_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = TBuilder.from_file(BENCH).build()
    with pytest.raises(RuntimeError, match="CUDA"):
        R.render_linear(scene, 4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render", BENCH, "--width", "4", "--height", "3", "-o",
                  os.devnull])


def test_select_engine():
    assert select_engine(torch.device("cpu")) == "torch"
    assert select_engine(torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        select_engine(torch.device("meta"))


def test_cli_render_writes_png(tmp_path, capsys):
    out = str(tmp_path / "bench.png")
    assert cli.main(["render", BENCH, "--width", "24", "--height", "20",
                     "--spp", "2", "--depth", "3", "--seed", "4", "-o", out,
                     "--device", "cpu"]) == 0
    assert "Last render took" in capsys.readouterr().out
    img = read_png(out)  # the JAX package's reader
    assert img.shape == (20, 24, 4) and img[..., :3].std() > 0


def test_cli_rejects_unserved_flags():
    for flag in ("--engine", "--sharded", "--progressive", "--bvh",
                 "--profile", "--checkpoint"):
        with pytest.raises(SystemExit):
            cli.main(["render", BENCH, flag])


def test_cli_info_matches_jax(capsys):
    class Args:
        scene = CORNELL
        spp = depth = clamp = mode = None
        bvh = no_bvh = False

    assert j_cli.cmd_info(Args()) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["info", CORNELL]) == 0
    got = json.loads(capsys.readouterr().out)
    for k in ("objects", "spheres", "volumes", "triangles", "materials",
              "settings"):
        assert got[k] == want[k], k


def test_port_never_imports_jax():
    code = ("import sys, raytracingrust_tpu_torch, raytracingrust_tpu_torch."
            "cli, raytracingrust_tpu_torch.models.convert, "
            "raytracingrust_tpu_torch.ops._build, "
            "raytracingrust_tpu_torch.ops.radiance_grad, "
            "raytracingrust_tpu_torch.ops.mse_loss, "
            "raytracingrust_tpu_torch.diff.grad, "
            "raytracingrust_tpu_torch.diff.inverse, "
            "raytracingrust_tpu_torch.ops.bvh, "
            "raytracingrust_tpu_torch.ops.bvh_kernel, "
            "raytracingrust_tpu_torch.ops.fetch, "
            "raytracingrust_tpu_torch.diff.replay, "
            "raytracingrust_tpu_torch.io.obj, "
            "raytracingrust_tpu_torch.io.exr, "
            "raytracingrust_tpu_torch.ops.occlusion, "
            "raytracingrust_tpu_torch.models.mesh, "
            "raytracingrust_tpu_torch.utils.aabb; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'raytracingrust_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
