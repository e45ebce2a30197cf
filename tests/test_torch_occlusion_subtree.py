"""Kernel #8's walk of the small trees inside the chunks, on the CPU: the
any-hit twin of the walk (ops/bvh_kernel._sub_leaf with ``any_hit``, which
``occluded_plain``'s tally runs on every leaf of more than SUB_DENSE slots
that the dense walk tests) against ``occluded_plain``, the dense any-hit
walk #8 is held to on the card.

Inside a chunk the twin stops at the first slot, in the kernel's order
(small leaves by node, slots in leaf order), whose candidate lies below the
bound; a chunk must have such a candidate under the twin exactly when it
has one under the dense test, so every shadow ray gets the dense walk's
answer.  The scenes and rays are tests/test_torch_bvh_subtree.py's, made
with numpy from a seed: random rays over 420 random spheres (four chunks
of up to 128 slots), rays that graze spheres or touch them from near and
far, rays from points on the spheres (t near T_MIN) and from inside them,
axis-parallel rays on small boxes' planes (NaN slabs), rays at coincident
spheres and at spheres of radius 0; the height field of
tests/test_torch_tri_cull.py built with its BVH; the spheres with a fog
sphere (a volume tree, walked densely, its free flight from the NEE
stream); ragged chunks, with every chunk's small tree walked too.  No JAX:
``occluded_plain`` is held to the JAX occlusion kernel in
tests/test_torch_env.py and tests/test_torch_zoo.py.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.ops import bvh_kernel as BK
from raytracingrust_tpu_torch.ops import occlusion as OC
from raytracingrust_tpu_torch.utils import rng as trng
from raytracingrust_tpu_torch.utils.rng import ray_uniforms
from raytracingrust_tpu_torch.utils.types import T_MIN
from test_torch_bvh_subtree import (_families, _ragged_tree, _sheet_scene,
                                    _sphere_rows, _spheres, _tri_points,
                                    _unit)

INF = float("inf")
KEY = trng.base_key(19)
STREAM = 6


def _rays(o, d):
    """(3, R) float32 origins and directions from (R, 3) arrays."""
    return tuple(torch.tensor(np.asarray(v, np.float32).T.copy())
                 for v in (o, d))


def _twin_occluded(sc, o, d, ray_ids=None, key=None, stream=0):
    """Each ray's answer by #8's route: each tree's any-hit walk in the
    kernel's order (spheres, volumes, triangles, a ray occluded by one
    walking no other), each chunk of more than SUB_DENSE slots of the
    sphere and triangle trees answered by the small trees' any-hit twin,
    every other chunk by the dense test."""
    o3, d3 = list(o.unbind(0)), list(d.unbind(0))
    a = BK._dot3(*d3, *d3)
    inv = [1.0 / v for v in d3]
    u_vol = None
    if sc.volumes is not None:
        u_vol = ray_uniforms(key, ray_ids, stream,
                             OC.NEE_VOL_COL + sc.n_vol)[:, OC.NEE_VOL_COL:]
    hit = torch.zeros(a.shape, dtype=torch.bool)
    for tree, leaf, extra in (
            (sc.spheres, BK._sphere_leaf, ()),
            (sc.volumes, BK._volume_leaf, (torch.sqrt(a), u_vol)),
            (sc.triangles, BK._triangle_leaf, ())):
        if tree is None:
            continue
        tb = torch.full_like(a, INF)
        win = torch.full(a.shape, -1, dtype=torch.long)
        entries = []
        BK._walk(tree, leaf, o3, d3, inv, a, ~hit, tb, win, None, "tests",
                 any_hit=True, extra=extra, entries=entries)
        n = tree.chunk_len.tolist()
        boxes = None if tree.sub is None else BK.sub_boxes(tree)
        for rays, chunk, bound, t_min, _, _ in entries:
            got = t_min < bound
            if boxes is not None and n[chunk] > BK.SUB_DENSE:
                t, _ = BK._sub_leaf(
                    tree, leaf, boxes, torch.full_like(rays, chunk),
                    *([v[rays] for v in x] for x in (o3, d3, inv)), a[rays],
                    bound, None, "tests", any_hit=True)
                got = t < bound
            hit[rays[got]] = True
    return hit


def _check(sc, o, d, ray_ids=None, key=None, stream=0):
    """The twin's answer equals ``occluded_plain``'s on every ray, the
    tally's twin counts no leaf where the two differ; -> (the answers,
    the tally)."""
    tally = collections.Counter()
    want = OC.occluded_plain(sc, o, d, ray_ids, key, stream, tally=tally)
    assert tally["sub_mismatch"] == 0, tally["sub_mismatch"]
    got = _twin_occluded(sc, o, d, ray_ids, key, stream)
    assert torch.equal(got, want), int((got != want).sum())
    return want, tally


def _fewer(tally, name):
    """The twin reached small trees and tested fewer slots than the dense
    walk of the same chunks."""
    assert tally["sub_chunks"] > 0 and tally["sub_nodes"] > 0
    assert tally[name + "_sub"] < tally[name], (tally[name + "_sub"],
                                                 tally[name])


@pytest.fixture(scope="module")
def spheres():
    """The 420 random spheres, packed, and the ray families over them."""
    b = T.SceneBuilder()
    m = b.add_material(T.Lambertian((0.5, 0.5, 0.5)))
    for c, r in zip(*_spheres(420)):
        b.add_sphere(tuple(float(x) for x in c), float(r), m)
    sc = BK.pack(b.build(with_bvh=True), 8, 8, "cpu")
    gen = np.random.default_rng(11)
    fam = _families(sc.spheres, gen)
    c, r, live = _sphere_rows(sc.spheres)
    zero = np.nonzero(r == 0)[0]
    o = gen.uniform(-8, 8, (600, 3))
    fam["radius0"] = (o, c[gen.choice(zero, 600)] - o, None)
    # lines tangent to a live sphere s, nudged in or out by a few parts in
    # 10^7 of their origin's distance, from 50, 400 and 1,000 units away
    # (the cone pad's case: without it a few at 1,000 lose their sphere),
    # kept where the line meets that sphere alone (one candidate over
    # every slot): their answer is that one grazing test's
    n = 4000
    s = gen.choice(np.nonzero(live)[0], n)
    u = _unit(gen.standard_normal((n, 3)))
    w = _unit(np.cross(u, gen.standard_normal((n, 3))))
    far = gen.choice([50.0, 400.0, 1000.0], n)[:, None]
    nudge = gen.choice([0.0, 1.0, -1.0, 3.0, -3.0], n)[:, None] * 1e-7 * far
    o = c[s] + (r[s, None] + nudge) * u - far * w
    d = w * gen.uniform(0.1, 10, (n, 1))
    o3, d3 = (list(v.unbind(0)) for v in _rays(o, d))
    ti = BK._sphere_leaf(sc.spheres, slice(0, sc.spheres.geo.shape[0]), o3,
                         d3, BK._dot3(*d3, *d3),
                         torch.full((o.shape[0],), INF))
    lone = (ti < INF).sum(1).numpy() == 1
    fam["lone"] = (o[lone], d[lone], None)
    return sc, fam


@pytest.mark.parametrize("kind", ["random", "grazing", "surface", "inside",
                                  "axes", "radius0", "lone"])
def test_twin_answers_as_the_dense_walk_over_spheres(spheres, kind):
    """Every family over the 420 spheres: the any-hit twin's answer is
    ``occluded_plain``'s on every ray, some rays blocked and some not
    (from inside a sphere, all: its far root; along a line that meets one
    sphere alone, grazing it from as far as 1,000 units, all but the few
    whose top-level box test misses), and the twin tests fewer slots."""
    sc, fam = spheres
    o, d, _ = fam[kind]
    if kind == "lone":
        assert o.shape[0] > 500
    want, tally = _check(sc, *_rays(o, d))
    assert bool(want.any())
    if kind == "inside":
        assert bool(want.all())
    elif kind == "lone":
        assert float(want.float().mean()) > 0.95
    else:
        assert not bool(want.all())
    _fewer(tally, "sphere_tests")


def test_rays_at_coincident_spheres(spheres):
    """Rays aimed at the centers of coincident twins (slots in other
    leaves or chunks) from outside: blocked under both walks."""
    sc, _ = spheres
    g = sc.spheres.geo.numpy()
    seen, lo = {}, []
    for slot in range(g.shape[0]):
        if g[slot, 3] > 0:
            k = g[slot].tobytes()
            if k in seen:
                lo.append(seen[k])
            seen.setdefault(k, slot)
    assert len(lo) >= 5
    lo = np.asarray(lo)
    gen = np.random.default_rng(12)
    o = g[lo, :3] + _unit(gen.standard_normal((len(lo), 3))) * (
        g[lo, 3:4] * 1.2)
    want, _ = _check(sc, *_rays(o, g[lo, :3] - o))
    assert bool(want.all())


def _serial_walk(tree, leaf, boxes, chunk, o, d, a, tb):
    """One ray's any-hit walk of one chunk's small tree as the kernel's
    stackless loop makes it (bvh_walk.cuh ``sub_walk<kKind, true>``):
    nodes in order by their skip links, each leaf's slots in leaf order,
    the walk ending at the first candidate below ``tb``; the slab test in
    the twin's float32 operations.  -> (t, slot, tests, node visits)."""
    sub = tree.sub
    n0, base = chunk * sub.stride, chunk * tree.leaf_size
    words = sub.words.tolist()
    order = sub.order.tolist()
    o3, d3 = torch.stack(o, 1), torch.stack(d, 1)
    inv3 = 1.0 / d3
    end, node, tests, visits = words[n0] & 0xFF, 0, 0, 0
    while node < end:
        box, word = boxes[n0 + node][None], words[n0 + node]
        near, far = box[:, :3] - o3, box[:, 4:7] - o3
        m = torch.fmax(near.abs(), far.abs())
        e = (torch.fmax(torch.fmax(m[:, 0], m[:, 1]), m[:, 2])
             * BK.SUB_CONE)[:, None]
        near, far = (near - e) * inv3, (far + e) * inv3
        nan = torch.isnan(near) | torch.isnan(far)
        entry = torch.where(nan, -INF, torch.minimum(near, far)).amax(1)
        exit_ = torch.where(nan, INF, torch.maximum(near, far)).amin(1)
        visits += 1
        if not bool((entry <= exit_) & (entry <= tb) & (exit_ >= T_MIN)):
            node = word & 0xFF
            continue
        node += 1
        start, count = (word >> 8) & 0xFF, word >> 16
        for j in range(count):  # a leaf's slots; an inner node has none
            slot = base + order[base + start + j]
            ti = leaf(tree, torch.tensor([slot]), o, d, a, tb)[0, 0]
            tests += 1
            if bool(ti < tb[0]):
                return float(ti), slot, tests, visits
    return INF, tree.geo.shape[0], tests, visits


@pytest.mark.parametrize("which", ["spheres", "triangles"])
def test_twin_counts_the_kernels_walk(spheres, tris, which):
    """On the (ray, chunk) entries of random and grazing rays, the twin's
    any-hit answer (its candidate's t and slot) is the kernel's loop's
    (:func:`_serial_walk`) entry for entry, and its tally counts the same
    node visits and tests: up to the first candidate, where the kernel
    stops."""
    if which == "spheres":
        sc, fam = spheres
        rays = [fam[k][:2] for k in ("random", "grazing")]
        tree, leaf = sc.spheres, BK._sphere_leaf
    else:
        fam = _tri_families(tris.triangles, np.random.default_rng(16))
        rays = [fam[k] for k in ("random", "grazing")]
        tree, leaf = tris.triangles, BK._triangle_leaf
    o, d = _rays(np.concatenate([r[0][:120] for r in rays]),
                 np.concatenate([r[1][:120] for r in rays]))
    o3, d3 = list(o.unbind(0)), list(d.unbind(0))
    a, inv = BK._dot3(*d3, *d3), [1.0 / v for v in d3]
    tb = torch.full_like(a, INF)
    entries = []
    BK._walk(tree, leaf, o3, d3, inv, a, torch.ones_like(a, dtype=torch.bool),
             tb, torch.full(a.shape, -1, dtype=torch.long), None, "tests",
             any_hit=True, entries=entries)
    boxes = BK.sub_boxes(tree)
    n_len = tree.chunk_len.tolist()
    got, want, n_entries = collections.Counter(), collections.Counter(), 0
    for rays_k, chunk, bound, *_ in entries:
        if n_len[chunk] <= BK.SUB_DENSE:
            continue
        t, slot = BK._sub_leaf(
            tree, leaf, boxes, torch.full_like(rays_k, chunk),
            *([v[rays_k] for v in x] for x in (o3, d3, inv)), a[rays_k],
            bound, got, "tests", any_hit=True)
        for i, ray in enumerate(rays_k.tolist()):
            wt, ws, tests, visits = _serial_walk(
                tree, leaf, boxes, chunk, [v[ray:ray + 1] for v in o3],
                [v[ray:ray + 1] for v in d3], a[ray:ray + 1],
                bound[i:i + 1])
            assert (float(t[i]), int(slot[i])) == (wt, ws), ray
            want["tests"] += tests
            want["sub_nodes"] += visits
            n_entries += 1
    assert n_entries > 40 and want["tests"] > 0
    assert (got["tests"], got["sub_nodes"]) == (want["tests"],
                                                want["sub_nodes"])


@pytest.fixture(scope="module")
def tris():
    return BK.pack(_sheet_scene(), 8, 8, "cpu")


def _tri_families(tree, gen, n: int = 1200) -> dict:
    """Ray families over a triangle tree: {name: (o, d)}: random rays,
    rays from points on the triangles (either side), rays that graze them
    (tilts 0 to 1e-3 out of a triangle's plane), axis-parallel rays on
    small boxes' planes."""
    fam = {"random": (gen.uniform(-3, 3, (n, 3)),
                      gen.standard_normal((n, 3)))}
    o, _ = _tri_points(tree, gen, n)
    fam["surface"] = (o, gen.standard_normal((n, 3)))
    p, nrm = _tri_points(tree, gen, n)
    side = _unit(np.cross(nrm, gen.standard_normal((n, 3))))
    d = side + gen.choice([0.0, 1e-7, 1e-5, 1e-3], n)[:, None] * nrm
    fam["grazing"] = (p - gen.uniform(0.05, 6, (n, 1)) * d, d)
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
    fam["axes"] = (o, d)
    return fam


def occlusion_families(sc, gen, kinds=("grazing", "surface", "axes")):
    """{"spheres <kind>" or "triangles <kind>": (o, d) arrays} of the
    families over the sphere tree and the triangle tree of ``sc``, packed
    on the CPU (tests/test_torch_gpu.py holds #8 to its plain version on
    them)."""
    out = {}
    if sc.spheres is not None and bool((sc.spheres.geo[:, 3] > 0).any()):
        fam = _families(sc.spheres, gen)
        out.update({f"spheres {k}": fam[k][:2] for k in kinds})
    if sc.triangles is not None:
        fam = _tri_families(sc.triangles, gen)
        out.update({f"triangles {k}": fam[k] for k in kinds})
    return out


@pytest.mark.parametrize("kind", ["random", "surface", "grazing", "axes"])
def test_twin_answers_as_the_dense_walk_over_the_height_field(tris, kind):
    """The height field and an icosphere, built with their BVH: random
    rays, rays from points on the triangles (either side), rays that graze
    the field (tilts 0 to 1e-3 out of a triangle's plane), axis-parallel
    rays on small boxes' planes."""
    o, d = _tri_families(tris.triangles, np.random.default_rng(13))[kind]
    want, tally = _check(tris, *_rays(o, d))
    assert bool(want.any()) and not bool(want.all())
    _fewer(tally, "triangle_tests")


def test_spheres_with_a_fog_volume():
    """The 420 spheres with a fog sphere of radius 1.2 among them: the
    sphere tree through the small trees, the volume tree densely with each
    ray's free flight from the NEE stream's column 2 by its id; the twin's
    route answers as ``occluded_plain`` on every ray, some rays blocked by
    the fog alone."""
    b = T.SceneBuilder()
    m = b.add_material(T.Lambertian((0.5, 0.5, 0.5)))
    for c, r in zip(*_spheres(420)):
        b.add_sphere(tuple(float(x) for x in c), float(r), m)
    iso = b.add_material(T.Isotropic((0.8, 0.8, 0.9)))
    b.add_volume(b.add_sphere((0.5, 0.5, 1.0), 1.2, iso), 0.8)
    sc = BK.pack(b.build(with_bvh=True), 8, 8, "cpu")
    assert sc.volumes is not None and sc.spheres.sub is not None
    gen = np.random.default_rng(14)
    n = 1500
    o = gen.uniform(-8, 8, (n, 3))
    aim = np.asarray([0.5, 0.5, 1.0]) + gen.uniform(-1.0, 1.0, (n, 3))
    d = np.where(np.arange(n)[:, None] < n // 2, aim - o,
                 gen.standard_normal((n, 3)))
    ids = torch.tensor(gen.permutation(4 * n)[:n].astype(np.int32))
    o, d = _rays(o, d)
    want, tally = _check(sc, o, d, ids, KEY, STREAM)
    solid = OC.occluded_plain(sc._replace(volumes=None), o, d)
    assert bool((want & ~solid).any())  # blocked by the fog alone
    assert tally["volume_tests"] > 0
    _fewer(tally, "sphere_tests")


@pytest.mark.parametrize("dense", [BK.SUB_DENSE, 0],
                         ids=["kernel", "every-chunk"])
def test_ragged_chunks(spheres, monkeypatch, dense):
    """Chunks of 128, 128, 67 and 1 slots, random rays and rays at every
    sphere of the short chunks: with the kernel's SUB_DENSE and with every
    chunk's small tree walked (the one-slot chunk's too)."""
    monkeypatch.setattr(BK, "SUB_DENSE", dense)
    sc = spheres[0]._replace(spheres=_ragged_tree())
    gen = np.random.default_rng(15)
    c, r, _ = _sphere_rows(sc.spheres)
    aim = np.repeat(np.r_[256:323, 384], 3)
    near = c[aim] + _unit(gen.standard_normal((aim.size, 3))) * (
        1.3 * r[aim, None] + 0.01)
    o = np.concatenate([gen.uniform(-8, 8, (800, 3)), near])
    d = np.concatenate([gen.standard_normal((800, 3)), c[aim] - near])
    want, tally = _check(sc, *_rays(o, d))
    live = torch.tensor(r[aim] > 0)  # radius 0 never blocks
    assert bool(want[800:][live].all()) and not bool(want[800:].all())
    _fewer(tally, "sphere_tests")


def test_scene_without_small_trees_is_refused(spheres, tris):
    """#8 (as #5) has no dense walk of a chunk to fall back to: its
    arguments refuse a sphere or triangle tree without small trees."""
    for sc, name in ((spheres[0], "spheres"), (tris, "triangles")):
        tree = getattr(sc, name)
        bare = sc._replace(**{name: tree._replace(sub=None)})
        with pytest.raises(ValueError, match="small trees"):
            BK._sub_args(bare)
        args, stride, boxes = BK._sub_args(sc, BK.scene_sub_boxes(sc))
        assert stride == tree.sub.stride and len(boxes) == 1
