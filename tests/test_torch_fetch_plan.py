"""Kernel #7's host-side plan (ops/fetch.transpose_plan: which path, the
warps a block, the tiles, the code ranges and the partials' shape) at the
tables the port's scenes give it, and the plain transpose
(ops/fetch.fetch_rows_transpose_plain) against float64 sums made here with
numpy, on the CPU.

The plan is a function of the table's size alone, so the kernel groups its
sums the same way on every run and every card; these tests hold it to the
card's shared memory (sm_90's opt-in 227 KB a block) at the small/large
threshold and around it.  The codes and cotangents are made
with numpy from a seed: hits piled on 1-3 rows, tables of 2,000 materials,
mesh-volume codes (material rows only), raw mode (geometry only), misses
and the code's bits above the slot.  No JAX: the plain transpose is held
to the JAX kernel in tests/test_torch_bvh_grad.py, and the kernel to the
plain transpose on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

from raytracingrust_tpu_torch.ops import fetch as TF

SLOT = (1 << 27) - 1
# the segments' two tables in shared memory, in whole float4s
TABLES = 16 * ((2 * TF.SEGMENTS + 4) // 4)
# the slots of a raw sphere table at the small/large threshold: its
# SMALL_WARPS copies and the segments' tables within the shared memory
EDGE_SPHERES = (TF.SMEM_BYTES - TABLES) // (4 * TF.SMALL_WARPS) // 4


def transpose_case(n_sph, n_tri, n_mats, raw=False, n_mv=0, hot=None,
                   n=60_000, miss=0.3, seed=0):
    """A seeded input of the transpose: codes (4, n / 4) over ``n_sph``
    sphere-like slots, then ``n_tri`` triangle slots, then ``n_mv`` mesh
    volumes (all of them, or only the slots ``hot``), a share ``miss`` of
    misses (-1), random bits above the slot; the slots' material ids among
    ``n_mats``; standard normal cotangents (G (+ 8), 4, n / 4).  -> the
    arguments of fetch_rows_transpose_plain / _cuda, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_slots = n_sph + n_tri + n_mv
    slot = (rng.choice(np.asarray(hot), n) if hot is not None
            else rng.integers(0, n_slots, n))
    code = slot | (rng.integers(0, 16, n) << 27)
    code = np.where(rng.random(n) < miss, -1, code).astype(np.int32)
    g = 4 if n_tri == 0 else 12
    rows = rng.standard_normal((g + (0 if raw else 8), n)).astype(np.float32)

    def mats(k):
        return rng.integers(0, n_mats, k).astype(np.int32) if k else None

    return (code.reshape(4, -1), rows.reshape(rows.shape[0], 4, -1), n_sph,
            mats(n_sph), mats(n_tri), n_mats, n_sph, n_tri, raw,
            n_sph + n_tri if n_mv else None, mats(n_mv))


def case_args(case, device="cpu", dtype=torch.float32):
    """:func:`transpose_case`'s arrays as tensors on ``device``, the
    cotangents in ``dtype``."""
    return tuple(torch.tensor(a, dtype=dtype if a.dtype == np.float32
                              else None, device=device)
                 if isinstance(a, np.ndarray) else a for a in case)


def numpy_sums(case, magnitudes=False):
    """The transpose in float64 with numpy (np.add.at): the sphere-like,
    triangle and material rows' sums (None where absent); of |cotangent|
    with ``magnitudes``."""
    (codes, g, tri_base, sph_mat, tri_mat, n_mats, n_sph, n_tri, raw,
     mv_base, mv_mat) = case
    code = codes.reshape(-1)
    g = g.reshape(g.shape[0], -1).astype(np.float64)
    if magnitudes:
        g = np.abs(g)
    geo_w = g.shape[0] - (0 if raw else 8)
    hit = code >= 0
    slot = code & SLOT
    mv = hit & (mv_base is not None) & (slot >= (mv_base or 0))
    tri = hit & ~mv & (slot >= tri_base)
    sph = hit & ~mv & ~tri
    out = []
    mid = np.zeros(code.shape, np.int64)
    for won, base, n_rows, w, mat in ((sph, 0, n_sph, 4, sph_mat),
                                      (tri, tri_base, n_tri, 12, tri_mat),
                                      (mv, mv_base, None, 0, mv_mat)):
        if mat is None:
            if n_rows is not None:
                out.append(None)
            continue
        s = slot[won] - base
        if n_rows is not None:
            d = np.zeros((n_rows, w))
            np.add.at(d, s, g[:w, won].T)
            out.append(d)
        mid[won] = mat[s]
    if raw:
        return out[0], out[1], None
    d_mats = np.zeros((n_mats, 8))
    np.add.at(d_mats, mid[hit], g[geo_w:, hit].T)
    return out[0], out[1], d_mats


# label -> (n_sph, n_tri, n_mats, raw), then the plan's path, warps a
# block, blocks and rows of partials.  The scenes' tables as the BVH packs
# them, in chunks of 128 slots: the zoo's 47 spheres and its fog sphere
# (raw), bvh_stress's 1,189 spheres, grid8k's 8,000 and the sheet's 8,192
# triangles with its 2 spheres, alone and as fog_sheet (raw)
PLAN_CASES = {
    "zoo": ((256, 0, 48, True), ("small", 8, 528, 528)),
    "bvh_stress": ((2048, 0, 4, False), ("large", 4, 264, 1056)),
    "grid8k": ((8192, 0, 1, False), ("large", 4, 264, 1056)),
    "sheet64": ((128, 8192, 3, False), ("large", 4, 127, 508)),
    "fog_sheet": ((128, 8192, 5, True), ("large", 4, 127, 508)),
    "mats2000": ((47, 0, 2000, False), ("large", 4, 264, 1056)),
    "below": ((EDGE_SPHERES, 0, 1, True), ("small", 8, 528, 528)),
    "above": ((EDGE_SPHERES + 1, 0, 1, True), ("large", 4, 264, 1056)),
}


@pytest.mark.parametrize("label", list(PLAN_CASES))
def test_plan_at_the_port_s_tables(label):
    """Which path, the warps a block, the blocks and the partials' shape
    at the zoo's raw sphere table, bvh_stress's and grid8k's spheres, the
    sheet's 8,192 triangles (with its materials, and raw as fog_sheet),
    2,000 materials, and a raw sphere table one slot below and one above
    the threshold."""
    (n_sph, n_tri, n_mats, raw), want = PLAN_CASES[label]
    n_floats = TF.table_floats(n_sph, n_tri, n_mats, raw)
    plan = TF.transpose_plan(n_floats)
    assert (plan["path"], plan["warps"], plan["blocks"],
            plan["partials"][0]) == want
    assert plan["partials"] == (want[3], n_floats)
    assert plan["shared"] == (want[0] == "small")
    assert plan["segments"] == TF.SEGMENTS


@pytest.mark.parametrize("seed", range(3))
def test_plan_fits_its_budget(seed):
    """Over tables from 1 to a million float4s: the small path takes every
    table whose SMALL_WARPS shared copies fit beside the segments' tables,
    a partials row a block; the large path a partials row a warp, whole
    blocks of LARGE_WARPS, as many as COPY_BYTES holds within MIN_COPIES
    and MAX_COPIES.  A table that is no whole number of float4s is
    refused."""
    rng = np.random.default_rng(seed)
    sizes = 4 * np.concatenate([np.arange(1, 40),
                                rng.integers(1, 10 ** 6, 200),
                                EDGE_SPHERES + np.arange(-3, 4)])
    for n_floats in map(int, sizes):
        p = TF.transpose_plan(n_floats)
        rows = p["partials"][0]
        assert p["partials"] == (rows, n_floats)
        small = 4 * TF.SMALL_WARPS * n_floats + TABLES <= TF.SMEM_BYTES
        assert (p["path"] == "small") == small == p["shared"]
        if small:
            assert p["warps"] == TF.SMALL_WARPS
            assert p["smem"] == 4 * p["warps"] * n_floats + TABLES
            assert p["smem"] <= TF.SMEM_BYTES
            assert p["blocks"] == rows == TF.RANGES
        else:
            assert p["warps"] == TF.LARGE_WARPS and p["smem"] == TABLES
            assert rows == p["blocks"] * p["warps"]
            assert TF.MIN_COPIES <= rows <= TF.MAX_COPIES
            assert (4 * rows * n_floats <= TF.COPY_BYTES
                    or rows == TF.MIN_COPIES)
            assert 4 * (rows + TF.LARGE_WARPS) * n_floats > TF.COPY_BYTES \
                or rows == TF.MAX_COPIES
    for bad in (0, 2, 4 * 1000 + 2):
        with pytest.raises(ValueError):
            TF.transpose_plan(bad)


# label -> transpose_case's arguments
PLAIN_CASES = {
    "mats2000": dict(n_sph=47, n_tri=0, n_mats=2000),
    "mats2000_tri": dict(n_sph=5, n_tri=300, n_mats=2000),
    "mesh_volumes": dict(n_sph=3, n_tri=200, n_mats=6, n_mv=2),
    "mesh_volumes_hot": dict(n_sph=3, n_tri=200, n_mats=6, n_mv=2,
                             hot=[203, 204, 7]),
    "raw": dict(n_sph=48, n_tri=0, n_mats=48, raw=True),
    "raw_tri": dict(n_sph=4, n_tri=320, n_mats=9, raw=True),
    "raw_hot": dict(n_sph=47, n_tri=0, n_mats=48, raw=True, hot=[0, 46]),
    "triangles_only": dict(n_sph=0, n_tri=500, n_mats=3),
}


@pytest.mark.parametrize("label", list(PLAIN_CASES))
def test_plain_transpose_against_float64_sums(label):
    """fetch_rows_transpose_plain in float32 within 1e-5 of each entry's
    summed magnitudes plus 1e-6 of the largest (the bound #7 is held to on
    the card) of numpy's float64 sums, and in float64 within 1e-12 of
    them; raw mode gives no material rows, a mesh volume's code adds to
    its material's row only."""
    case = transpose_case(**PLAIN_CASES[label], seed=len(label))
    want = numpy_sums(case)
    mag = numpy_sums(case, magnitudes=True)
    got32 = TF.fetch_rows_transpose_plain(*case_args(case))
    got64 = TF.fetch_rows_transpose_plain(*case_args(case,
                                                     dtype=torch.float64))
    for a32, a64, w, m in zip(got32, got64, want, mag):
        assert (a32 is None) == (w is None) and (a64 is None) == (w is None)
        if w is None:
            continue
        assert a32.dtype == torch.float32 and a32.shape == w.shape
        tol = 1e-5 * m + 1e-6 * m.max()
        assert (np.abs(a32.double().numpy() - w) <= tol).all()
        np.testing.assert_allclose(a64.numpy(), w, rtol=1e-12, atol=1e-12)
    if PLAIN_CASES[label].get("raw"):
        assert got32[2] is None
    else:
        assert got32[2].abs().sum() > 0


def test_plain_transpose_of_mesh_volume_codes():
    """Codes of mesh volumes only: no geometry row moves, and each
    volume's material row gets its codes' material cotangents."""
    case = transpose_case(n_sph=3, n_tri=10, n_mats=5, n_mv=2,
                          hot=[13, 14], miss=0.1, seed=5)
    d_sph, d_tri, d_mats = TF.fetch_rows_transpose_plain(*case_args(case))
    assert not d_sph.any() and not d_tri.any()
    codes, g, mv_mat = case[0].reshape(-1), case[1], case[10]
    g = g.reshape(g.shape[0], -1).astype(np.float64)
    want = np.zeros((5, 8))
    for v in range(2):
        on = (codes >= 0) & ((codes & SLOT) == 13 + v)
        want[mv_mat[v]] += g[12:, on].sum(axis=1)
    np.testing.assert_allclose(d_mats.double().numpy(), want, rtol=1e-5,
                               atol=1e-3)


def test_transpose_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors fetch_rows_transpose is the plain version; the
    kernel's wrapper refuses them (it never falls back)."""
    case = case_args(transpose_case(n_sph=47, n_tri=0, n_mats=48, n=4_000))
    got = TF.fetch_rows_transpose(*case)
    assert got[1] is None
    for a, b in zip(got, TF.fetch_rows_transpose_plain(*case)):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TF.fetch_rows_transpose_cuda(*case)
