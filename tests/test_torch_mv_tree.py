"""The mesh volumes' boundary trees (ops/bvh.build_mv_trees) and the plain
version of kernel #5's walk of them (ops/bvh_kernel._mv_walk), on the CPU,
against the dense crossing scan ``_mv_min_t`` (the port of the JAX
kernel's ``_mv_min_t``, pallas_megakernel.py:1116).

The walk has to give the dense scan's t1 (the least raw Moller-Trumbore t
at any sign) and t2 (the least t at or past t1 + T_MIN) bit for bit, so it
may never prune a triangle the dense scan accepts.  The rays are made with
numpy from a seed against an icosphere of 128 triangles and an
axis-aligned cube, the two boundaries the JAX package's mesh-volume tests
use: random lines, origins inside either mesh (entries behind the origin),
lines through vertices, along shared edges and through their midpoints,
lines in the plane of a cube face and just off it, lines along an axis or
in an axis plane, and lines that graze a triangle of the icosphere (where
the Moller-Trumbore t is least accurate).  The scene-level equality with
the JAX package is tests/test_torch_mesh_volume.py's.
"""

import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.ops import bvh as TBV
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.utils.types import T_MIN
from test_torch_mesh_volume import cube, icosphere

ICO = ((-0.3, 0.8, 0.2), 0.7)
CUBE = ((1.1, 0.6, -0.6), 0.35)
INF = float("inf")


def _builder():
    b = T.SceneBuilder()
    iso = b.add_material(T.Isotropic((0.8, 0.8, 0.9)))
    lam = b.add_material(T.Lambertian((0.6, 0.5, 0.3)))
    b.add_volume(b.add_mesh(icosphere(T, *ICO, iso, 2)), 1.5)
    b.add_sphere((0.8, 1.2, 0.0), 0.4, lam)
    b.add_volume(b.add_mesh(cube(T, *CUBE, iso)), 3.0)
    return b


@pytest.fixture(scope="module")
def scene():
    return _builder().build(with_bvh=True)


@pytest.fixture(scope="module")
def packed(scene):
    return BK.pack(scene, 8, 8, "cpu")


def _corners(scene, v):
    """(T, 3, 3) the vertices of volume v's triangles as the rows hold
    them: v0, v0 + e1, v0 + e2 in float32."""
    tri = scene.triangles
    ids = (tri.volume == v).nonzero().squeeze(1)
    v0, e1, e2 = (x[ids].numpy() for x in (tri.v0, tri.e1, tri.e2))
    return np.stack([v0, v0 + e1, v0 + e2], axis=1)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rays(scene, kind, gen):
    """(origins, directions) (N, 3) float32 of one adversarial family."""
    ico, box = _corners(scene, 0), _corners(scene, 1)
    both = np.concatenate([ico, box])
    c_ico, c_box = np.float32(ICO[0]), np.float32(CUBE[0])
    if kind == "random":
        o = gen.uniform(-3, 3, (800, 3))
        d = gen.standard_normal((800, 3)) * gen.uniform(0.1, 10, (800, 1))
    elif kind == "inside":
        o = np.concatenate([c_ico + 0.5 * _unit(gen.standard_normal(
            (300, 3))) * gen.uniform(0, 1, (300, 1)),
            c_box + gen.uniform(-0.34, 0.34, (300, 3))])
        d = gen.standard_normal((600, 3))
    elif kind == "vertices":
        p = both[gen.integers(0, len(both), 600), gen.integers(0, 3, 600)]
        o = gen.uniform(-3, 3, (600, 3))
        d = p - o
    elif kind == "edges":
        tri = both[gen.integers(0, len(both), 600)]
        a, b = tri[:, 0], tri[:, 1]
        along = np.arange(600) % 2 == 0  # the line of the edge itself
        o = np.where(along[:, None], a - 0.5 * (b - a),
                     gen.uniform(-3, 3, (600, 3)))
        d = np.where(along[:, None], b - a, 0.5 * (a + b) - o)
    elif kind == "faces":
        # in the plane of a cube face (d's axis component exactly 0), just
        # off it, and through it at a shallow angle
        face = np.float32(c_box + np.float32(CUBE[1]))
        axis = gen.integers(0, 3, 600)
        o = c_box + gen.uniform(-0.6, 0.6, (600, 3))
        d = gen.standard_normal((600, 3))
        rows = np.arange(600)
        o[rows, axis] = face[axis]
        off = rows % 3
        d[rows, axis] = np.where(off == 0, 0.0, np.where(
            off == 1, 1e-7, 1e-3)) * np.sign(d[rows, axis])
    elif kind == "axes":
        axis = gen.integers(0, 3, 600)
        d = np.zeros((600, 3))
        d[np.arange(600), axis] = gen.choice([-1.0, 1.0], 600)
        two = np.arange(600) % 2 == 1  # one zero component, not two
        d[two] = gen.standard_normal((int(two.sum()), 3))
        d[two, axis[two]] = 0.0
        centre = np.where((np.arange(600) % 4 < 2)[:, None], c_ico, c_box)
        o = centre + gen.uniform(-0.8, 0.8, (600, 3))
        o[np.arange(600), axis] = centre[np.arange(600), axis] - 2.0 * d[
            np.arange(600), axis]
    elif kind == "grazing":
        tri = ico[gen.integers(0, len(ico), 800)]
        w = gen.dirichlet((1, 1, 1), 800)
        p = np.einsum("nk,nkc->nc", w, tri)
        n = _unit(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
        side = _unit(np.cross(n, gen.standard_normal((800, 3))))
        tilt = gen.choice([0.0, 1e-7, 1e-5, 1e-3], 800)
        d = side + tilt[:, None] * n
        o = p - gen.uniform(0.2, 4, (800, 1)) * d
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


KINDS = ("random", "inside", "vertices", "edges", "faces", "axes", "grazing")


def _dense(mv, v, o, d):
    """(t1, t2) of volume v by the dense scan, t2 inf where t1 is."""
    start, count = mv.spans[v]
    t1 = BK._mv_min_t(mv, start, count, o, d, torch.full((o[0].numel(),),
                                                           -INF), None)
    t2 = BK._mv_min_t(mv, start, count, o, d, t1 + T_MIN, None)
    return t1, torch.where(t1 < INF, t2, INF)


def _walked(mv, v, o, d, tally=None):
    """(t1, t2, the rays that needed the exit walk) of volume v by the
    walks as the scan runs them, without its early-outs: t2 from the
    entry walk's kept crossings, else from the exit walk."""
    inv = [1.0 / x for x in d]
    low = torch.full((o[0].numel(),), -INF)
    t1, t2 = BK._mv_walk(mv, v, o, d, inv, low, low, -low, tally, keep=True)
    again = (t1 < INF) & torch.isnan(t2)
    floor = t1[again] + T_MIN
    t2[again] = BK._mv_walk(mv, v, *([x[again] for x in y]
                                     for y in (o, d, inv)),
                            floor, floor, -low[again], tally)
    return t1, torch.where(t1 < INF, t2, INF), again


def _dense_scan(mv, o, d, a, u_vol, t_best):
    """The crossing scan over the dense _mv_min_t (the JAX kernel's, as
    the port ran it before the trees): -> (t_best, winning volume)."""
    tb, w = t_best.clone(), torch.full(a.shape, -1, dtype=torch.long)
    ray_len = torch.sqrt(a)
    for v in range(len(mv.spans)):
        t1, t2 = _dense(mv, v, o, d)
        h1 = torch.clamp(t1, min=T_MIN)
        valid = (t1 < INF) & (t2 < INF) & (h1 < t2)
        h1 = torch.clamp(h1, min=0.0)
        hit_dist = mv.nid[v] * torch.log(torch.clamp(u_vol[:, v], min=1e-37))
        ti = h1 + hit_dist / ray_len
        won = valid & (hit_dist <= (t2 - h1) * ray_len) & (ti < tb)
        tb, w = torch.where(won, ti, tb), torch.where(won, v, w)
    return tb, w


@pytest.mark.parametrize("kind", KINDS)
def test_walk_equals_dense_scan(scene, packed, kind):
    """For every ray of the family and both volumes, the walk's t1 and t2
    equal the dense scan's bit for bit; the families reach both signs of
    t1, crossings and misses."""
    o, d = _rays(scene, kind, np.random.default_rng(KINDS.index(kind)))
    o, d = o.unbind(1), d.unbind(1)
    mv = packed.mesh_vols
    crossed = 0
    for v in range(2):
        want = _dense(mv, v, o, d)
        got = _walked(mv, v, o, d)[:2]
        for name, a, b in zip(("t1", "t2"), got, want):
            bad = a.view(torch.int32) != b.view(torch.int32)
            assert not bool(bad.any()), (
                f"{kind}, volume {v}: {name} differs on {int(bad.sum())} "
                f"rays, e.g. {a[bad][:4].tolist()} against "
                f"{b[bad][:4].tolist()}")
        crossed += int((want[1] < INF).sum())
    assert crossed > 0
    if kind == "inside":  # every origin inside a mesh: entry behind it
        t1 = torch.cat([_dense(mv, v, [x[300 * v:300 * v + 300] for x in o],
                               [x[300 * v:300 * v + 300] for x in d])[0]
                        for v in range(2)])
        assert bool((t1 < 0).all())


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_scan_equals_dense_scan(scene, packed, sign):
    """The plain crossing scan, whose entry walks skip a line that crosses
    a volume only before T_MIN and boxes past t_best, gives the dense
    scan's nearest hit and winner bit for bit, on every family at once,
    with t_best inf, random, or a hair either side of the volumes'
    crossings, and free flights from random uniforms; ``sign`` -1 flips
    -1/density positive, where the kernel keeps no t_best bound."""
    gen = np.random.default_rng(7)
    rays = [_rays(scene, k, np.random.default_rng(KINDS.index(k)))
            for k in KINDS]
    o = torch.cat([r[0] for r in rays]).unbind(1)
    d = torch.cat([r[1] for r in rays]).unbind(1)
    n = o[0].numel()
    mv = packed.mesh_vols._replace(nid=sign * packed.mesh_vols.nid)
    sc = packed._replace(mesh_vols=mv)
    a = BK._dot3(*d, *d)
    u_vol = torch.tensor(gen.random((n, 2)), dtype=torch.float32)
    near = torch.stack([_dense(mv, v, o, d)[0] for v in range(2)]).amin(0)
    near = torch.where(near < INF, near, 1.0)
    pick = gen.integers(0, 4, n)
    t_best = torch.tensor(np.select(
        [pick == 0, pick == 1], [np.inf, gen.uniform(1e-3, 5, n)],
        near.numpy() * np.where(pick == 2, 1 + 1e-6, 1 - 1e-6)),
        dtype=torch.float32).clamp(min=T_MIN)
    want = _dense_scan(mv, o, d, a, u_vol, t_best)
    got_t = t_best.clone()
    tally = collections.Counter()
    got_w = BK._mesh_volume_scan(sc, o, d, a, torch.ones(n, dtype=bool),
                                 u_vol, got_t, tally)
    assert torch.equal(got_t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got_w, want[1])
    assert int((want[1] >= 0).sum()) > n // 20  # the fogs win often
    assert tally["mv_draws"] > 0


def test_exit_from_kept_crossings_or_a_second_walk(scene, packed):
    """Most lines that cross the icosphere get t2 from the crossings the
    entry walk kept; a line through a vertex, which crosses every
    triangle there, walks again."""
    mv = packed.mesh_vols
    for kind, kept in (("random", True), ("vertices", False)):
        o, d = _rays(scene, kind, np.random.default_rng(KINDS.index(kind)))
        t1, _, again = _walked(mv, 0, o.unbind(1), d.unbind(1))
        crossed = int((t1 < INF).sum())
        assert crossed > 0
        if kept:
            assert int(again.sum()) < crossed / 10
        else:
            assert bool(again.any())


def test_walk_prunes(scene, packed):
    """On random lines the walk tests a fraction of the triangles the
    dense scan tests, and counts its node visits."""
    o, d = _rays(scene, "random", np.random.default_rng(0))
    o, d = o.unbind(1), d.unbind(1)
    mv = packed.mesh_vols
    walked, dense = collections.Counter(), collections.Counter()
    for v in range(2):
        _walked(mv, v, o, d, walked)
        start, count = mv.spans[v]
        t1 = BK._mv_min_t(mv, start, count, o, d,
                          torch.full((o[0].numel(),), -INF), dense)
        enter = t1 < INF
        BK._mv_min_t(mv, start, count, [x[enter] for x in o],
                     [x[enter] for x in d], t1[enter] + T_MIN, dense)
    assert walked["mv_nodes"] > 0
    assert 0 < walked["mv_tests"] < dense["mv_tests"] / 4


def test_tree_covers_each_triangle_once(scene):
    """Each volume's tree holds every boundary triangle of that volume in
    exactly one leaf and nothing else; each leaf's box holds its
    triangles' vertices with room on every side, and each node's box holds
    every box below it."""
    cb = scene.cbvh
    assert len(cb.mv_trees) == 2
    vol = scene.triangles.volume.numpy()
    for v, t in enumerate(cb.mv_trees):
        assert t.leaf_size == TBV.MV_LEAF
        live = t.perm[t.perm >= 0]
        np.testing.assert_array_equal(np.sort(live),
                                      np.nonzero(vol == v)[0])
        lo, hi = t.nodes_f[:, :3], t.nodes_f[:, 3:]
        v0 = scene.triangles.v0.numpy()
        pts = np.stack([v0, v0 + scene.triangles.e1.numpy(),
                        v0 + scene.triangles.e2.numpy()], axis=1)
        for k, (hit, miss, chunk) in enumerate(t.nodes_i):
            assert (lo[k:miss] >= lo[k]).all() and (hi[k:miss] <= hi[k]).all()
            if chunk < 0:
                assert hit == k + 1 and miss > k + 2
                continue
            assert hit == miss == k + 1
            ids = t.perm[chunk * t.leaf_size:(chunk + 1) * t.leaf_size]
            p = pts[ids[ids >= 0]].reshape(-1, 3)
            assert (lo[k] < p.min(axis=0)).all()
            assert (hi[k] > p.max(axis=0)).all()
        # the cube's faces are flat on one axis: their leaves still have a
        # slab of thickness on every axis
        assert (hi - lo > 0).all()


def test_missing_trees_built_once(scene, packed):
    """A scene whose BVH lacks the volumes' trees gets them built when it
    is packed, kept in its BVH, equal to the build's."""
    bare = dataclasses.replace(scene, cbvh=dataclasses.replace(
        scene.cbvh, mv_trees=()))
    sc = BK.pack(bare, 8, 8, "cpu")
    assert len(bare.cbvh.mv_trees) == 2
    for a, b in zip(bare.cbvh.mv_trees, scene.cbvh.mv_trees):
        for f in ("nodes_f", "nodes_i", "perm"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert sc.mesh_vols.walks == packed.mesh_vols.walks
    assert torch.equal(sc.mesh_vols.tree.geo, packed.mesh_vols.tree.geo)
