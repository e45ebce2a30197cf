"""The small trees inside the chunks of the BVH's sphere and triangle trees
(ops/bvh.build_sub_trees, ops/bvh_kernel.sub_boxes) and the plain twin of
kernel #5's walk of them (ops/bvh_kernel._sub_leaf, run by ``_twin_check``
on every leaf the dense walk tests), on the CPU, against the dense walk
``_walk`` that #5 is held to.

Inside a chunk the twin tests only the slots in the small leaves whose
padded box the ray's line reaches, so its nearest t and its winner must
be the dense leaf test's bit for bit, ties included (the nearest t, then
the lowest slot).  The scenes and rays are made with numpy from a seed:
random rays over a few hundred random spheres, over chunks of 128, 128,
37 and 1 slots, over tests/test_torch_tri_cull.py's height field built
with its BVH; rays that graze spheres or touch them, from near and far;
rays from points on sphere and triangle surfaces (t near T_MIN) and from
inside spheres; axis-parallel rays whose origins lie on a small node's
box planes (NaN slabs); coincident spheres (ties), spheres of radius 0;
rows moved after the build while the chunk boxes stay as built.  No JAX:
the dense walk is held to the JAX package in tests/test_torch_bvh_*.py.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.models.mesh import Mesh
from raytracingrust_tpu_torch.models.scene import ChunkTree
from raytracingrust_tpu_torch.ops import bvh as TBV
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.utils.types import T_MIN
from test_torch_tri_cull import icosphere, sheet

INF = float("inf")


def _spheres(n: int, seed: int = 16):
    """(centers, radii) of n random spheres in a 6-wide cube, with
    coincident pairs (slots far apart in the build's order, so in other
    leaves or chunks), radius 0 and a few large ones."""
    gen = np.random.default_rng(seed)
    c = gen.uniform(-3, 3, (n, 3)).astype(np.float32)
    r = gen.uniform(0.05, 0.3, n).astype(np.float32)
    r[::37] = 0.0
    r[5::53] = gen.uniform(0.8, 1.5, len(r[5::53]))
    for i in range(0, n // 2, 23):  # a coincident twin at the far end
        c[n - 1 - i], r[n - 1 - i] = c[i], r[i]
    return c, r


def _sphere_scene(n: int, seed: int = 16):
    b = T.SceneBuilder()
    m = b.add_material(T.Lambertian((0.5, 0.5, 0.5)))
    for c, r in zip(*_spheres(n, seed)):
        b.add_sphere(tuple(float(x) for x in c), float(r), m)
    return b.build(with_bvh=True)


def _sheet_scene():
    b = T.SceneBuilder()
    m = b.add_material(T.Lambertian((0.5, 0.5, 0.5)))
    v, f = sheet(16, 12)
    b.add_mesh(Mesh.from_buffers(v, v, f, m))
    v, f = icosphere((0.3, 0.2, -1.6), 0.4, 1)
    b.add_mesh(Mesh.from_buffers(v, v, f, m))
    return b.build(with_bvh=True)


@pytest.fixture(scope="module")
def spheres():
    scene = _sphere_scene(420)
    return scene, BK.pack(scene, 8, 8, "cpu")


@pytest.fixture(scope="module")
def tris():
    scene = _sheet_scene()
    return scene, BK.pack(scene, 8, 8, "cpu")


def _ragged_tree(sizes=(128, 128, 67, 1), seed: int = 5):
    """A sphere Tree over chunks of ``sizes`` slots (a root and one leaf
    a chunk, each chunk's box its spheres'), with its small trees."""
    c, r = _spheres(sum(sizes), seed)
    r[-1] = 0.3  # the last chunk's sphere, live
    lo, hi = c - r[:, None], c + r[:, None]
    perm = np.full((len(sizes), 128), -1, np.int64)
    nodes_f = [np.concatenate([lo.min(0), hi.max(0)])]
    start = 0
    for k, n in enumerate(sizes):
        perm[k, :n] = np.arange(start, start + n)
        nodes_f.append(np.concatenate([lo[start:start + n].min(0),
                                       hi[start:start + n].max(0)]))
        start += n
    k = len(sizes)
    nodes_i = [[1, k + 1, -1]] + [[j + 2, j + 2, j] for j in range(k)]
    tree = ChunkTree(np.asarray(nodes_f, np.float32),
                     np.asarray(nodes_i, np.int32),
                     perm.reshape(-1).astype(np.int32), 128)
    sub = TBV.build_sub_trees(tree, lo, hi)
    rows = torch.tensor(np.concatenate([c, r[:, None]], 1))
    return BK._tree(tree, rows, torch.zeros(len(r), dtype=torch.int32),
                    "cpu", sub=sub)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _dense(tree, leaf, o, d, t_best=None, entries=None):
    """(t, win) of rays (N, 3) arrays o, d by the dense walk of one tree
    from the bound ``t_best`` (inf if None), its leaves into ``entries``."""
    o, d = _t(o).unbind(1), _t(d).unbind(1)
    a = BK._dot3(*d, *d)
    tb = torch.full_like(a, INF) if t_best is None else _t(t_best)
    win = torch.full(a.shape, -1, dtype=torch.long)
    BK._walk(tree, leaf, o, d, [1.0 / v for v in d], a,
             torch.ones_like(a, dtype=torch.bool), tb, win, None, "tests",
             entries=entries)
    return tb, win


def _same(tree, leaf, o, d, t_best=None):
    """The twin inside the chunks (_sub_leaf, run by _twin_check on every
    leaf the dense walk tests, from the same bound) finds the dense test's
    nearest t and slot bit for bit at every leaf, so the twin's walk ends
    with the dense walk's t and winner; -> the dense (t, win) and the
    twin's tally."""
    entries, tally = [], collections.Counter()
    t, win = _dense(tree, leaf, o, d, t_best, entries)
    o, d = _t(o).unbind(1), _t(d).unbind(1)
    BK._twin_check(tree, leaf, o, d, [1.0 / v for v in d], BK._dot3(*d, *d),
                   entries, tally, "tests")
    assert tally["sub_mismatch"] == 0, (
        f"the twin differs from the dense test at {tally['sub_mismatch']} "
        f"of {sum(e[0].numel() for e in entries)} leaves")
    return (t, win), tally


def _sphere_rows(tree):
    g = tree.geo.numpy()
    live = (tree.geo[:, 3] > 0).numpy()
    return g[:, :3], g[:, 3], live


def _on_spheres(tree, gen, n):
    """Points on the surfaces of random live spheres (float32 rounding),
    their slots and outward normals."""
    c, r, live = _sphere_rows(tree)
    s = gen.choice(np.nonzero(live)[0], n)
    u = _unit(gen.standard_normal((n, 3)))
    return (c[s] + r[s, None] * u).astype(np.float32), s, u


def _families(tree, gen):
    """Ray families over a sphere tree: {name: (o, d, t_best or None)}."""
    c, r, live = _sphere_rows(tree)
    n = 1500
    fam = {"random": (gen.uniform(-8, 8, (n, 3)),
                      gen.standard_normal((n, 3)), None)}
    # tangent and grazing lines, from near and far: the line touches
    # sphere s at c + r u and runs along a direction w perpendicular to u,
    # nudged in or out by a few parts in 10^7 of the distance
    s = gen.choice(np.nonzero(live)[0], n)
    u = _unit(gen.standard_normal((n, 3)))
    w = _unit(np.cross(u, gen.standard_normal((n, 3))))
    far = gen.choice([0.5, 5.0, 50.0, 400.0], n)[:, None]
    nudge = gen.choice([0.0, 1.0, -1.0, 3.0, -3.0], n)[:, None] * 1e-7 * far
    touch = c[s] + (r[s, None] + nudge) * u
    fam["grazing"] = (touch - far * w, w * gen.uniform(0.1, 10, (n, 1)),
                      None)
    # from a surface (a bounce: t near T_MIN), either hemisphere, and from
    # inside a sphere
    p, _, nrm = _on_spheres(tree, gen, n)
    d = gen.standard_normal((n, 3))
    fam["surface"] = (p, d, None)
    s = gen.choice(np.nonzero(live)[0], n)
    fam["inside"] = (c[s] + 0.5 * r[s, None] * _unit(gen.standard_normal(
        (n, 3))), gen.standard_normal((n, 3)), None)
    # along an axis, origins on the planes of small boxes: NaN slabs
    boxes = BK.sub_boxes(tree).numpy()
    used = np.nonzero(np.isfinite(boxes[:, 0]))[0]
    k = gen.choice(used, n)
    axis = gen.integers(0, 3, n)
    o = gen.uniform(boxes[k, :3], boxes[k, 4:7])
    other = (axis + gen.integers(1, 3, n)) % 3  # on a plane across it
    rows = np.arange(n)
    o[rows, other] = np.where(gen.random(n) < 0.5, boxes[k, other],
                              boxes[k, 4 + other])
    d = np.zeros((n, 3))
    d[rows, axis] = gen.choice([-1.0, 1.0], n)
    o[rows, axis] -= 10.0 * d[rows, axis]
    fam["axes"] = (o, d, None)
    # a bound at exactly a candidate's t, and random bounds
    o = gen.uniform(-8, 8, (n, 3))
    d = c[gen.choice(np.nonzero(live)[0], n)] - o
    dense = _dense(tree, BK._sphere_leaf, o, d)[0].numpy()
    bound = np.where(np.isfinite(dense), dense,
                     gen.uniform(0.01, 2.0, n)).astype(np.float32)
    fam["bounds"] = (o, d, bound)
    return fam


@pytest.mark.parametrize("kind", ["random", "grazing", "surface", "inside",
                                  "axes", "bounds"])
def test_twin_equals_dense_walk_over_spheres(spheres, kind):
    """420 random spheres (4 chunks, coincident twins, radius 0): for every
    ray of the family the twin's t and winner equal the dense walk's bit
    for bit; the families hit, and the twin tests fewer slots."""
    _, sc = spheres
    o, d, tb = _families(sc.spheres, np.random.default_rng(1))[kind]
    (t, win), tally = _same(sc.spheres, BK._sphere_leaf, o, d, tb)
    assert bool((t < INF).any()) and tally["sub_nodes"] > 0
    assert tally["tests_sub"] < 128 * tally["sub_chunks"]


def test_coincident_spheres_go_to_the_lowest_slot(spheres):
    """Rays at the centers of coincident twins, which lie in other leaves
    (or chunks), hit both at the same t; the winner is the lower slot, in
    the dense walk and the twin."""
    scene, sc = spheres
    tree = sc.spheres
    g = tree.geo.numpy()
    key = {}
    twins = []
    for slot in range(g.shape[0]):
        if g[slot, 3] > 0:
            k = g[slot].tobytes()
            if k in key:
                twins.append((key[k], slot))
            key.setdefault(k, slot)
    assert len(twins) >= 5
    gen = np.random.default_rng(2)
    lo = np.asarray([a for a, _ in twins])
    o = g[lo, :3] + _unit(gen.standard_normal((len(lo), 3))) * (
        g[lo, 3:4] * 1.2)
    (t, win), _ = _same(tree, BK._sphere_leaf, o, g[lo, :3] - o)
    hit_twin = (g[win.numpy()] == g[lo]).all(1)
    assert hit_twin.sum() >= 3
    assert (win.numpy()[hit_twin] == lo[hit_twin]).all()


@pytest.mark.parametrize("dense", [BK.SUB_DENSE, 0],
                         ids=["kernel", "every-chunk"])
def test_ragged_chunks_and_a_chunk_of_one_slot(monkeypatch, dense):
    """Chunks of 128, 128, 67 and 1 slots: random rays and rays at every
    sphere of the short chunks; with the kernel's SUB_DENSE (the one-slot
    chunk takes the dense test) and with every chunk's small tree walked,
    the one-slot chunk's and the ragged leaves' of the 67 too."""
    monkeypatch.setattr(BK, "SUB_DENSE", dense)
    tree = _ragged_tree()
    gen = np.random.default_rng(3)
    c, r, live = _sphere_rows(tree)
    aim = np.repeat(np.r_[256:323, 384], 4)  # the short chunks' slots
    near = c[aim] + _unit(gen.standard_normal((aim.size, 3))) * (
        1.3 * r[aim, None] + 0.01)
    o = np.concatenate([gen.uniform(-8, 8, (1200, 3)), near])
    d = np.concatenate([gen.standard_normal((1200, 3)), c[aim] - near])
    (t, win), tally = _same(tree, BK._sphere_leaf, o, d)
    assert int((win.numpy() == 3 * 128).sum()) > 0  # the one-slot chunk
    assert int(((win >= 256) & (win < 323)).sum()) > 100
    if dense == 0:
        assert tally["sub_chunks"] > 0


def test_moved_rows_keep_the_chunk_boxes(spheres):
    """A fit moves the rows, not the chunk boxes: the small boxes come from
    the rows (shifted by up to 0.4 and, for a few spheres, by 3), and the
    twin still equals the dense walk."""
    _, sc = spheres
    gen = np.random.default_rng(4)
    geo = sc.spheres.geo.clone()
    shift = gen.uniform(-0.4, 0.4, (geo.shape[0], 3))
    shift[::29] *= 7.5
    geo[:, :3] += _t(shift) * (geo[:, 3:4] > 0)
    tree = sc.spheres._replace(geo=geo)
    for kind in ("random", "surface", "grazing"):
        o, d, tb = _families(tree, gen)[kind]
        _same(tree, BK._sphere_leaf, o, d, tb)


def _tri_points(tree, gen, n):
    """Points on random live triangles of the triangle tree (float32) and
    their unit normals."""
    g = tree.geo.numpy()
    live = np.nonzero(np.abs(g[:, 3:9]).sum(1) > 0)[0]
    s = gen.choice(live, n)
    w = gen.dirichlet((1, 1, 1), n)
    p = g[s, :3] + w[:, 1:2] * g[s, 3:6] + w[:, 2:3] * g[s, 6:9]
    return p.astype(np.float32), _unit(np.cross(g[s, 3:6], g[s, 6:9]))


@pytest.mark.parametrize("kind", ["random", "surface", "grazing", "axes"])
def test_twin_equals_dense_walk_over_the_height_field(tris, kind):
    """tests/test_torch_tri_cull.py's height field and an icosphere, built
    with their BVH: random rays, rays from points on the triangles (either
    side), rays that graze the field (tilts 0 to 1e-3 out of a triangle's
    plane) and axis-parallel rays on small boxes' planes."""
    _, sc = tris
    tree = sc.triangles
    gen = np.random.default_rng(5 + ["random", "surface", "grazing",
                                     "axes"].index(kind))
    n = 1500
    if kind == "random":
        o = gen.uniform(-3, 3, (n, 3))
        d = gen.standard_normal((n, 3))
    elif kind == "surface":
        o, nrm = _tri_points(tree, gen, n)
        d = gen.standard_normal((n, 3))
    elif kind == "grazing":
        p, nrm = _tri_points(tree, gen, n)
        side = _unit(np.cross(nrm, gen.standard_normal((n, 3))))
        tilt = gen.choice([0.0, 1e-7, 1e-5, 1e-3], n)[:, None]
        d = side + tilt * nrm
        o = p - gen.uniform(0.05, 6, (n, 1)) * d
    else:
        boxes = BK.sub_boxes(tree).numpy()
        k = gen.choice(np.nonzero(np.isfinite(boxes[:, 0]))[0], n)
        axis = gen.integers(0, 3, n)
        o = gen.uniform(boxes[k, :3], boxes[k, 4:7])
        rows = np.arange(n)
        other = (axis + 1) % 3
        o[rows, other] = boxes[k, other]
        d = np.zeros((n, 3))
        d[rows, axis] = gen.choice([-1.0, 1.0], n)
        o[rows, axis] -= 5.0 * d[rows, axis]
    (t, _), tally = _same(tree, BK._triangle_leaf, o, d)
    assert bool((t < INF).any())
    assert tally["tests_sub"] < 128 * tally["sub_chunks"]


def test_plain_render_tallies_the_twin(tris, spheres, monkeypatch):
    """A plain render with a tally runs the twin on every leaf the dense
    walk tests, from the same bound, a few hundred entries at a time, and
    counts no mismatch; the twin tests a fraction of the dense leaves'
    slots."""
    from raytracingrust_tpu_torch.ops import megakernel as K
    from raytracingrust_tpu_torch.utils import rng

    monkeypatch.setattr(BK, "SUB_ENTRIES", 256)

    for scene, sc in (tris, spheres):
        ids, px, py = K.prep_rays(torch.arange(12 * 12), 2, 12)
        tally = collections.Counter()
        BK.radiance_bvh_plain(BK.pack(scene, 12, 12, "cpu"), rng.base_key(0),
                              ids, px, py, max_depth=3, bg_kind=0,
                              clay=False, tally=tally)
        assert tally["sub_mismatch"] == 0 and tally["sub_nodes"] > 0
        dense = tally["sphere_tests"] + tally["triangle_tests"]
        sub = tally["sphere_tests_sub"] + tally["triangle_tests_sub"]
        assert 0 < sub < dense / 2


@pytest.mark.parametrize("which", ["spheres", "triangles", "ragged"])
def test_small_trees_cover_each_live_slot_once(spheres, tris, which):
    """Each chunk's small tree holds every live slot of the chunk in
    exactly one leaf; a node's members are its children's; leaves hold at
    most SUB_LEAF slots; the root's skip link ends the chunk's nodes; and
    every node's padded box holds its members' boxes with room."""
    if which == "ragged":
        tree = _ragged_tree()
        s = None
    else:
        scene, sc = spheres if which == "spheres" else tris
        tree = getattr(sc, which)
        s = scene.cbvh.sub_trees[0 if which == "spheres" else 1]
    words = tree.sub.words.numpy().astype(np.int64)
    order = tree.sub.order.numpy().astype(np.int64)
    stride, leaf = tree.sub.stride, tree.leaf_size
    boxes = BK.sub_boxes(tree).numpy()
    g = tree.geo.numpy()
    if g.shape[1] == 4:
        lo, hi = g[:, :3] - np.abs(g[:, 3:4]), g[:, :3] + np.abs(g[:, 3:4])
    else:
        pts = np.stack([g[:, :3], g[:, :3] + g[:, 3:6],
                        g[:, :3] + g[:, 6:9]], 1)
        lo, hi = pts.min(1), pts.max(1)
    for c, n in enumerate(tree.chunk_len.numpy()):
        run = order[c * leaf:c * leaf + n]
        assert sorted(run) == list(range(n))
        w = words[c * stride:(c + 1) * stride]
        end = w[0] & 0xFF
        seen = []
        for j in range(end):
            first, count = (w[j] >> 8) & 0xFF, w[j] >> 16
            skip = w[j] & 0xFF
            assert j < skip <= end
            if count:  # a leaf
                assert count <= TBV.SUB_LEAF and skip == j + 1
                seen += list(run[first:first + count])
            else:
                assert skip > j + 2  # two children at least
            if s is not None:
                f, k = s.first[c * stride + j], s.count[c * stride + j]
                members = c * leaf + run[f:f + k]
                b = boxes[c * stride + j]
                assert (b[:3] < lo[members].min(0)).all()
                assert (b[4:7] > hi[members].max(0)).all()
        assert sorted(seen) == list(range(n))


def test_scene_without_small_trees_gets_them_once(spheres):
    """A BVH without small trees gets them when the scene is packed, kept
    in the scene's BVH, equal to the build's."""
    scene, sc = spheres
    bare = dataclasses.replace(scene, cbvh=dataclasses.replace(
        scene.cbvh, sub_trees=()))
    got = BK.pack(bare, 8, 8, "cpu")
    assert bare.cbvh.sub_trees[1] is None
    assert torch.equal(got.spheres.sub.words, sc.spheres.sub.words)
    assert torch.equal(got.spheres.sub.order, sc.spheres.sub.order)
