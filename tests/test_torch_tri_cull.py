"""The brute kernels' triangle clusters (ops/megakernel.pack_tri_boxes) and
the plain twin of their culled loop (ops/megakernel.tri_closest_culled,
csrc/radiance.cuh cluster_thr), on the CPU, against the dense triangle test
``tri_closest`` that kernels #1, #3 and #4 are held to.

The culled loop skips a cluster of consecutive rows only where none of its
rows can pass the dense test below the best t so far, so its winner and t
must be the dense loop's bit for bit, ties included (the lowest t, then
the lowest index).  The rays are made with numpy from a seed: grazing rays
in a flat cluster's plane and just off it, rays through the edges and
vertices that two clusters share (equal t: the lower index wins), a bound
at exactly a triangle's t (the bound keeps it), origins inside a box and
on a triangle (T_MIN), determinants just above TRI_DET_EPS, directions
with zero components (inf and NaN slabs, origins on a slab's plane), a
ragged last cluster, one triangle and 8,192, zero-area triangles, and
random rays over chip_smoke.py's height field and icosphere at small
sizes.  No JAX: the dense test is held to the JAX package in
tests/test_torch_brute_tri.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.models.mesh import Mesh
from raytracingrust_tpu_torch.ops import megakernel as K
from raytracingrust_tpu_torch.utils.types import T_MIN

C = K.TRI_CLUSTER


def sheet(nx: int, nz: int, bump: float = 0.08, seed: int = 14):
    """chip_smoke.py's height field at nx x nz quads (two triangles each,
    x in [-2, 2], z in [-3, -0.2]), heights from a numpy seed (flat for
    ``bump`` 0): (vertices, faces) in its row order."""
    xs = np.linspace(-2.0, 2.0, nx + 1)
    zs = np.linspace(-3.0, -0.2, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = -0.55 + bump * np.random.default_rng(seed).random(gx.shape)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(nx):
        for j in range(nz):
            a = i * (nz + 1) + j
            faces += [(a, a + 1, a + nz + 1), (a + 1, a + nz + 2, a + nz + 1)]
    return verts, np.asarray(faces, np.int32)


def icosphere(center, radius: float, subdiv: int):
    """chip_smoke.py's icosphere (an icosahedron subdivided ``subdiv``
    times, 20 * 4^subdiv triangles): (vertices, faces)."""
    p = (1 + 5 ** 0.5) / 2
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in (
        (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p),
        (0, 1, p), (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1),
        (-p, 0, -1), (-p, 0, 1))]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        cache, new = {}, []

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new
    v = (np.asarray(verts, np.float32) * np.float32(radius)
         + np.asarray(center, np.float32))
    return v, np.asarray(faces, np.int32)


def _zero_area(verts, faces):
    """The mesh with a zero-area triangle (a repeated vertex) and a
    collinear one appended."""
    v = np.concatenate([verts, [[0.1, -0.5, -1.0], [0.3, -0.5, -1.0],
                                [0.5, -0.5, -1.0]]]).astype(np.float32)
    n = verts.shape[0]
    f = np.concatenate([faces, [[n, n, n + 1], [n, n + 1, n + 2]]])
    return v, f.astype(np.int32)


def cull_builder(name: str, depth: int = 3, spp: int = 2):
    """Brute triangle scenes that press on the clusters, built without
    their BVH, a Lambertian emitter sphere above each: "graze", a flat
    16 x 16 sheet (16 clusters) under a camera a hair above its plane
    looking along it, over a metal half; "ragged", the 8 x 4 height field
    and one triangle more (a last cluster of one), with a zero-area and a
    collinear triangle; "single", one triangle; "max", a 64 x 64 height
    field, 8,192 triangles."""
    b = T.SceneBuilder()
    b.settings = T.RenderSettings(samples_per_pixel=spp,
                                  max_ray_depth=depth,
                                  enable_bvh_tree=False)
    lam = b.add_material(T.Lambertian((0.6, 0.55, 0.5)))
    metal = b.add_material(T.Metal((0.85, 0.85, 0.9), 0.0))
    b.add_sphere((0.0, 1.2, -1.5), 0.4,
                 b.add_material(T.Emission((3.0, 2.8, 2.5))))

    def add(verts, faces, mat):
        b.add_mesh(Mesh.from_buffers(verts, verts, faces, mat))

    if name == "graze":
        v, f = sheet(16, 8, bump=0.0)
        add(v, f[:128], metal)
        add(v, f[128:], lam)
        b.camera = T.Camera.create((0.05, -0.55 + 2e-4, 0.5),
                                   (0.05, -0.55 + 2e-4, -3.0), (0, 1, 0),
                                   40.0, 1.0)
        return b
    b.camera = T.Camera.create((0.0, 0.6, 1.5), (0.0, -0.4, -1.5),
                               (0, 1, 0), 60.0, 1.0)
    if name == "ragged":
        v, f = _zero_area(*sheet(8, 4))
        add(v, f[:32], lam)
        add(v, f[32:], metal)
    elif name == "single":
        add(np.asarray([[-1, -0.5, -2], [1, -0.5, -2], [0, 0.8, -2.2]],
                       np.float32), np.asarray([[0, 1, 2]], np.int32), lam)
    else:
        v, f = sheet(64, 64)
        add(v, f[:4096], lam)
        add(v, f[4096:], metal)
    return b


def _scene(verts, faces):
    b = T.SceneBuilder()
    b.settings = T.RenderSettings(enable_bvh_tree=False)
    b.add_mesh(Mesh.from_buffers(verts, verts, faces,
                                 b.add_material(T.Lambertian((0.5,) * 3))))
    return b.build()


def _rays(o, d):
    o = np.asarray(o, np.float32).reshape(-1, 3)
    d = np.asarray(d, np.float32).reshape(-1, 3)
    return ([torch.from_numpy(o[:, k].copy()) for k in range(3)],
            [torch.from_numpy(d[:, k].copy()) for k in range(3)])


def _same(scene, o, d, bound=None):
    """tri_closest_culled == tri_closest on the rays, bit for bit; -> the
    dense winners and the culled twin's tally."""
    tri, boxes = K.pack_tri(scene), K.pack_tri_boxes(scene)
    o, d = _rays(o, d)
    if bound is not None:
        bound = torch.as_tensor(bound, dtype=torch.float32)
    t_d, i_d = K.tri_closest(tri, o, d, bound)
    tally = {}
    t_c, i_c = K.tri_closest_culled(tri, boxes, o, d, bound, tally=tally)
    assert torch.equal(i_c, i_d)
    assert torch.equal(t_c.view(torch.int32), t_d.view(torch.int32))
    return t_d, i_d, tally


def _points(scene, ids, u, v):
    tris = scene.triangles
    ids = np.asarray(ids)
    return (tris.v0.numpy()[ids] + u * tris.e1.numpy()[ids]
            + v * tris.e2.numpy()[ids]).astype(np.float64)


GEN = np.random.default_rng(15)


@pytest.mark.parametrize("mesh", ["sheet", "ragged", "single", "max"])
def test_boxes_hold_every_vertex_with_the_pad(mesh):
    """Each record's box holds its rows' vertices (v0, v0 + e1, v0 + e2,
    summed exactly) grown by at least BOX_PAD of the cluster's extent plus
    BOX_PAD_COORD of its largest coordinate; its normal box holds its
    rows' n; omax and coef are as stated; its half-precision normals are
    the rows' n times sc rounded to nearest (sc a power of 2 putting the
    largest in [0.5, 1)), 0 past the last row."""
    scene = cull_builder({"sheet": "graze"}.get(mesh, mesh)).build()
    boxes = K.pack_tri_boxes(scene).double().numpy()
    tri = K.pack_tri(scene).double().numpy()
    tris = scene.triangles
    v0, e1, e2 = (x.double().numpy() for x in (tris.v0, tris.e1, tris.e2))
    verts = np.stack([v0, v0 + e1, v0 + e2], 1)
    assert boxes.shape == (-(-len(tris) // C), K.BOX_COLS)
    for c, bx in enumerate(boxes):
        vs = verts[c * C:(c + 1) * C].reshape(-1, 3)
        lo, hi = vs.min(0), vs.max(0)
        ext = (hi - lo).max()
        pad = (K.BOX_PAD * ext + K.BOX_PAD_COORD
               * np.abs(np.concatenate([lo, hi])).max())
        assert (bx[0:3] <= lo - pad).all() and (bx[4:7] >= hi + pad).all()
        assert bx[3] == np.abs(np.concatenate([bx[0:3], bx[4:7]])).max()
        n = tri[c * C:(c + 1) * C, 0:3]
        assert (bx[8:11] == n.min(0)).all() and (bx[12:15] == n.max(0)).all()
        assert bx[11] > 1000 * ext  # omax: any camera of these scenes
        scale = (np.abs(e1[c * C:(c + 1) * C]).max(1)
                 * np.abs(e2[c * C:(c + 1) * C]).max(1)).max()
        grown = min((lo - bx[0:3]).min(), (bx[4:7] - hi).min())
        assert bx[7] >= K.BOX_GRAZE * scale / grown > 0
        sc = bx[15]
        assert np.frexp(sc)[0] == 0.5
        assert 0.5 <= np.abs(n).max() * sc < 1.0 or not np.abs(n).any()
        half = (bx[16:].astype(np.float32).view(np.float16)
                .reshape(3, C).T.astype(np.float64))
        want = np.zeros((C, 3))
        want[:n.shape[0]] = (n.astype(np.float32) * np.float32(sc)).astype(
            np.float16)
        assert (half == want).all()


def test_random_rays_over_height_field_and_icosphere():
    """Random lines (origins above, inside and below the sheet, any
    direction) over chip_smoke.py's height field at 8 x 16 quads and a
    320-triangle icosphere in one scene: the twin's winners and t equal
    the dense test's, and it tests fewer rows."""
    v1, f1 = sheet(16, 8)
    v2, f2 = icosphere((-1.0, -0.2, -1.2), 0.3, 2)
    scene = _scene(np.concatenate([v1, v2]),
                   np.concatenate([f1, f2 + v1.shape[0]]))
    n = 1500
    o = GEN.uniform((-2.5, -0.9, -3.5), (2.5, 1.0, 0.5), (n, 3))
    d = GEN.standard_normal((n, 3))
    o[:300] = _points(scene, GEN.integers(0, 576, 300), 0.3, 0.3) + 0.5
    d[:300] = _points(scene, GEN.integers(0, 576, 300), 0.2, 0.5) - o[:300]
    _, idx, tally = _same(scene, o, d)
    assert int((idx >= 0).sum()) > 400
    assert tally["tests"] < 0.25 * n * 576


@pytest.mark.parametrize("lift", [0.0, 1e-7, 3e-5, -2e-6])
def test_grazing_rays_in_a_flat_clusters_plane(lift):
    """Rays in the plane of a flat sheet and a hair above or below it,
    nearly parallel to it (|a| from 0 up): where the sums' rounding can
    put t anywhere, the clusters are tested, so the twin equals the dense
    test."""
    v, f = sheet(16, 8, bump=0.0)
    scene = _scene(v, f)
    n = 600
    y = np.float32(-0.55 + lift)
    o = np.stack([GEN.uniform(-2.5, 2.5, n), np.full(n, y),
                  GEN.uniform(-3.2, 0.2, n)], -1)
    tilt = GEN.choice([0.0, 1e-9, -1e-8, 3e-8, -1e-6, 1e-4], n)
    d = np.stack([GEN.standard_normal(n), tilt, GEN.standard_normal(n)], -1)
    _same(scene, o, d)


def test_shared_edges_and_vertices_across_a_cluster_boundary():
    """A strip of 96 triangles (row k on vertices k, k + 1, k + 2, bent up
    and down), so rows 31 and 32, and 63 and 64, share an edge across a
    cluster boundary: rays through the shared edges' midpoints, through
    the shared vertices and near them hit two or three rows at equal or
    nearly equal t, and the lower index wins, as in the dense loop."""
    k = np.arange(98)
    v = np.stack([-2.0 + 0.04 * k, -0.5 + 0.03 * (k % 3 == 0),
                  -1.0 - 0.2 * (k % 2)], -1).astype(np.float32)
    f = np.stack([k[:96], k[1:97], k[2:98]], -1).astype(np.int32)
    scene = _scene(v, f)
    vv = v.astype(np.float64)
    pts = []
    for a in (31, 32, 63, 64, 15, 47):
        pts += [(vv[a + 1] + vv[a + 2]) / 2, vv[a + 1], vv[a + 2],
                (vv[a] + vv[a + 1]) / 2]
    pts = np.asarray(pts)
    pts = np.concatenate([pts, pts + GEN.normal(0, 1e-6, pts.shape)])
    o = pts + np.asarray([0.3, 1.5, 0.7])
    d = pts - o
    _, idx, _ = _same(scene, o, d)
    assert {31, 63, 64} <= set(idx.tolist())


def test_bound_at_exactly_a_triangles_t():
    """A bound (the spheres' best t) at exactly a triangle's t keeps the
    bound: the test is strict, culled or not; one ulp above it lets the
    triangle win."""
    v, f = sheet(8, 8)
    scene = _scene(v, f)
    n = 400
    o = GEN.uniform((-2, 0.5, -3), (2, 1.5, 0), (n, 3))
    d = _points(scene, GEN.integers(0, 128, n), 0.25, 0.25) - o
    t, idx, _ = _same(scene, o, d)
    hit = idx >= 0
    assert bool(hit.all())
    _, idx2, _ = _same(scene, o, d, t.numpy())
    assert bool((idx2 == -1).all())
    above = np.nextafter(t.numpy(), np.float32(np.inf))
    _, idx3, _ = _same(scene, o, d, above)
    assert torch.equal(idx3, idx)


def test_origins_inside_a_box_and_on_a_triangle():
    """Origins inside a cluster's box (entries behind them) and exactly on
    a triangle (its own t is below T_MIN or 0): the twin equals the dense
    test, and some rays hit the triangle they start on's neighbours."""
    v, f = sheet(8, 8)
    scene = _scene(v, f)
    n = 500
    ids = GEN.integers(0, 128, n)
    o = _points(scene, ids, GEN.uniform(0, 0.5, n)[:, None],
                GEN.uniform(0, 0.5, n)[:, None])
    o[:250, 1] += GEN.uniform(-0.04, 0.04, 250)  # inside the boxes
    d = GEN.standard_normal((n, 3))
    t, idx, _ = _same(scene, o, d)
    assert bool(((t > T_MIN) | (idx < 0)).all())


def test_determinants_just_above_the_epsilon():
    """Directions whose determinant a = -n . d lies just above and below
    TRI_DET_EPS for one row of the icosphere, aimed at it from outside."""
    v, f = icosphere((0.0, 0.0, -1.0), 0.5, 2)
    scene = _scene(v, f)
    tri = K.pack_tri(scene).double().numpy()
    n = 300
    rows = GEN.integers(0, 320, n)
    target = _points(scene, rows, 0.3, 0.3)
    nrm = tri[rows, 0:3]
    side = np.cross(nrm, GEN.standard_normal((n, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    # a = -n . d = k TRI_DET_EPS for k about 1
    k = GEN.choice([0.5, 0.999, 1.001, 1.5, 3.0], n)
    d = side - (k * K.TRI_DET_EPS / (nrm * nrm).sum(1))[:, None] * nrm
    o = target - 2.0 * d
    _same(scene, o, d)


@pytest.mark.parametrize("zeros", [1, 2])
def test_zero_direction_components(zeros):
    """Directions with one or two components exactly 0 (slabs of +-inf,
    and NaN where the origin lies on a box's plane), from origins on the
    boxes' planes and off them."""
    v, f = sheet(16, 8)
    scene = _scene(v, f)
    boxes = K.pack_tri_boxes(scene).numpy()
    n = 600
    d = GEN.standard_normal((n, 3))
    d[:, GEN.permutation(3)[:zeros]] = 0.0
    d[d.sum(1) == 0, 1] = -1.0
    o = GEN.uniform((-2.2, -0.7, -3.2), (2.2, 0.5, 0.0), (n, 3))
    pick = GEN.integers(0, boxes.shape[0], n)
    on = GEN.random(n) < 0.5
    for k in range(3):  # half the origins on a plane of a box
        o[on, k] = np.where(GEN.random(on.sum()) < 0.5,
                            boxes[pick[on], k], boxes[pick[on], 4 + k])
    _same(scene, o, d)


@pytest.mark.parametrize("name", ["ragged", "single", "max"])
def test_ragged_single_and_largest_meshes(name):
    """A last cluster of one row (with a zero-area and a collinear
    triangle among the rows), one triangle, and 8,192 triangles, against
    rays at the sheet from above and random lines."""
    scene = cull_builder(name).build()
    n = 200 if name == "max" else 500
    n_tri = len(scene.triangles)
    o = GEN.uniform((-2, -0.3, -3), (2, 1.0, 0), (n, 3))
    d = _points(scene, GEN.integers(0, n_tri, n), 0.2, 0.3) - o
    d[: n // 4] = GEN.standard_normal((n // 4, 3))
    _same(scene, o, d)
