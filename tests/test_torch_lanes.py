"""Host code around kernel #1's persistent lanes, on the CPU: the C entries'
signatures that ops/_build.py declares for ctypes (#1's entry took a
scratch word for its ray counter), and chip_smoke.py's lane efficiency of a
plain run (warps of 32 consecutive ray ids, each running to its longest
path), against the per-ray path lengths counted apart."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import chip_smoke as C
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.ops import _build
from raytracingrust_tpu_torch.ops import megakernel as TK
from raytracingrust_tpu_torch.utils import rng as trng

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


def _entries():
    """C entry name -> its parameter count, from every kernel source."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" [\w\s\*]+?\b(rtrt_\w+)\(([^)]*)\)',
                             text):
            out[m.group(1)] = len([a for a in m.group(2).split(",")
                                   if a.strip()])
    return out


def test_signatures_match_the_sources():
    """Each entry that ctypes binds takes as many arguments as its source
    declares, and every entry of the sources is bound."""
    entries = _entries()
    assert set(entries) == set(_build._SIGNATURES)
    for name, (args, _) in _build._SIGNATURES.items():
        assert len(args) == entries[name], name
    # #1's entry: ..., the sky's texels, height, width, the counter, out,
    # the stream
    assert _build._SIGNATURES["rtrt_radiance"][0][-6:] == [
        _build._P, _build._I32, _build._I32, _build._P, _build._P,
        _build._P]


def _scene():
    """tests/test_torch_gpu.py::brute_ext_builder's mini zoo: paths of
    every length, from a miss at the first bounce to depth 5."""
    from test_torch_gpu import brute_ext_builder

    return brute_ext_builder(T, depth=5, spp=3).build()


class _Lengths:
    """Each ray's bounces, from the plain version's masks."""

    def __init__(self):
        self.n = None

    def __call__(self, alive, hit, kind, **_):
        self.n = alive.long() if self.n is None else self.n + alive.long()


@pytest.mark.parametrize("n_pix", [37, 64])
def test_lane_efficiency_of_a_plain_run(n_pix):
    """_Count's lane efficiency: the bounces over 32 lanes times, for each
    warp of 32 consecutive ray ids (the last one padded), its longest
    path."""
    scene = _scene()
    w, spp = 8, scene.settings.samples_per_pixel
    fp, kinds = TK.pack_fparams(scene, w, 8), TK.brute_kinds(scene)
    opts = TK.scene_opts(scene)
    ids, px, py = TK.prep_rays(torch.arange(n_pix), spp, w)
    count, lengths = C._Count(), _Lengths()

    def both(*args, **kw):
        count(*args, **kw)
        lengths(*args, **kw)

    TK.radiance_plain(fp, kinds, trng.base_key(2), ids, px, py,
                      observe=both, **opts)
    n = lengths.n
    pad = torch.cat([n, n.new_zeros((-n.numel()) % 32)])
    slots = 32 * int(pad.view(-1, 32).max(dim=1).values.sum())
    assert count.bounces == int(n.sum())
    assert count.warp_slots == slots
    assert count.lane_efficiency == int(n.sum()) / slots
    assert 0.0 < count.lane_efficiency < 1.0
    assert int(n.min()) == 1 and int(n.max()) > 1  # paths of many lengths
