"""The port's chunk-leaf BVH, meshes and OBJ loader against the JAX
package's: the same arrays, node for node and slot for slot."""

import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the host's cores

import numpy as np

import raytracingrust_tpu as J
from raytracingrust_tpu.io.obj import load_obj as j_load_obj
from raytracingrust_tpu.models.mesh import Mesh as JMesh
from raytracingrust_tpu.ops import bvh as jbvh
import raytracingrust_tpu_torch as T
from raytracingrust_tpu_torch.io.obj import load_obj
from raytracingrust_tpu_torch.models.mesh import Mesh as TMesh
from raytracingrust_tpu_torch.ops import bvh as tbvh

ROOT = os.path.join(os.path.dirname(__file__), "..")
STRESS = os.path.join(ROOT, "scenes", "bvh_stress.json")


def grid_builder(mod, n=7, depth=4, spp=2, spacing=0.8, radius=0.3,
                 mode="Full"):
    """tests/test_pallas_bvh.py::grid_builder for either package: an n^3
    sphere grid with four materials."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((6, 5, 8), (0, 0, 0), (0, 1, 0), 50.0, 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth, mode=mode)
    mats = [b.add_material(mod.Lambertian((0.7, 0.3, 0.2))),
            b.add_material(mod.Metal((0.9, 0.9, 0.9), 0.1)),
            b.add_material(mod.Emission((2.0, 1.5, 1.0))),
            b.add_material(mod.Dielectric(1.5))]
    rs = np.random.RandomState(0)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                b.add_sphere(((i - n / 2) * spacing, (j - n / 2) * spacing,
                              (k - n / 2) * spacing), radius,
                             mats[rs.randint(4)])
    return b


def sheet_buffers(n_side):
    """The triangle sheet of tests/test_pallas_bvh.py::mesh_builder:
    (vertices, faces), 2 n_side^2 triangles."""
    xs = np.linspace(-2, 2, n_side + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.3 * np.sin(gx * 2.1) * np.cos(gz * 1.7)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(n_side):
        for j in range(n_side):
            a = i * (n_side + 1) + j
            faces.append([a, a + 1, a + n_side + 1])
            faces.append([a + 1, a + n_side + 2, a + n_side + 1])
    return verts, np.asarray(faces, np.int32)


def mesh_builder(mod, n_side=12, depth=3, spp=1, mesh=None):
    """tests/test_pallas_bvh.py::mesh_builder for either package: the sheet
    and two spheres.  ``mesh(material)`` may give the mesh instead."""
    b = mod.SceneBuilder()
    b.camera = mod.Camera.create((0, 2.5, 4), (0, 0, 0), (0, 1, 0), 55.0,
                                 1.0)
    b.settings = mod.RenderSettings(samples_per_pixel=spp,
                                    max_ray_depth=depth)
    ml = b.add_material(mod.Lambertian((0.6, 0.5, 0.3)))
    mm = b.add_material(mod.Metal((0.9, 0.85, 0.8), 0.05))
    me = b.add_material(mod.Emission((2.5, 2.2, 1.8)))
    if mesh is None:
        verts, faces = sheet_buffers(n_side)
        Mesh = JMesh if mod is J else TMesh
        mesh = lambda m: Mesh.from_buffers(verts, verts, faces, m)
    b.add_mesh(mesh(ml))
    b.add_sphere((0.8, 1.2, 0.0), 0.4, mm)
    b.add_sphere((-1.2, 1.8, 0.5), 0.35, me)
    return b


def pair(name):
    """(JAX scene, port scene), both built with their BVH."""
    if name == "stress":
        return (J.SceneBuilder.from_file(STRESS).build(with_bvh=True),
                T.SceneBuilder.from_file(STRESS).build(with_bvh=True))
    if name == "grid9":
        return tuple(grid_builder(m, n=9).build(with_bvh=True)
                     for m in (J, T))
    return tuple(mesh_builder(m, n_side=12).build(with_bvh=True)
                 for m in (J, T))


def assert_tree_equal(tree, nf, ni, perm):
    """A port ChunkTree against the JAX ChunkedBVH's flat arrays."""
    k = np.asarray(nf).size // 6
    assert tree.n_nodes == k
    np.testing.assert_array_equal(
        tree.nodes_f.view(np.uint32),
        np.asarray(nf, np.float32).reshape(k, 6).view(np.uint32))
    np.testing.assert_array_equal(tree.nodes_i,
                                  np.asarray(ni).reshape(k, 3))
    np.testing.assert_array_equal(tree.perm, np.asarray(perm))
    assert tree.nodes_f.dtype == np.float32
    assert tree.nodes_i.dtype == tree.perm.dtype == np.int32


@pytest.mark.parametrize("name", ["stress", "grid9", "mesh12"])
def test_chunked_bvh_equals_jax(name):
    """Nodes (boxes, links, chunk ids) and the slot permutation equal the
    JAX builder's exactly, for the sphere tree and the triangle tree."""
    j, t = pair(name)
    jc, tc = j.cbvh, t.cbvh
    for kind, pre in (("spheres", "sph"), ("triangles", "tri")):
        tree = getattr(tc, kind)
        perm = np.asarray(getattr(jc, f"{pre}_perm"))
        if perm.size == 0:
            assert tree is None
            continue
        assert tree.leaf_size == jc.leaf_size == 128
        assert_tree_equal(tree, getattr(jc, f"{pre}_nodes_f"),
                          getattr(jc, f"{pre}_nodes_i"), perm)
    if name == "stress":  # 1,189 spheres: 31 nodes, 16 chunks
        assert (tc.spheres.n_nodes, tc.spheres.n_chunks) == (31, 16)


@pytest.mark.parametrize("name", ["stress", "grid9", "mesh12"])
def test_chunked_tree_invariants(name):
    """tests/test_pallas_bvh.py::test_chunked_builder_invariants, on the
    port's trees."""
    _, t = pair(name)
    mins, maxs = tbvh.primitive_bounds(t.spheres, t.triangles)
    n_sph = len(t.spheres)
    for tree, lo, hi, base in ((t.cbvh.spheres, mins, maxs, 0),
                               (t.cbvh.triangles, mins, maxs, n_sph)):
        if tree is None:
            continue
        k = tree.n_nodes
        hit, miss, chunk = tree.nodes_i.T
        real = tree.perm[tree.perm >= 0]
        n_prim = n_sph if base == 0 else len(t.triangles)
        assert sorted(real.tolist()) == list(range(n_prim))
        # links always advance (a stackless walk ends) and stay in [1, k]
        assert (hit > np.arange(k)).all() and (hit <= k).all()
        assert (miss > np.arange(k)).all() and (miss <= k).all()
        leaf = chunk >= 0
        assert (hit[leaf] == miss[leaf]).all()
        assert (hit[~leaf] == np.arange(k)[~leaf] + 1).all()
        # each leaf's primitives lie in its box; a chunk's real slots come
        # first, and chunk_len counts them
        lens = tree.chunk_len
        for node in np.nonzero(leaf)[0]:
            c = chunk[node]
            ids = tree.perm[c * 128:(c + 1) * 128]
            assert (ids[:lens[c]] >= 0).all() and (ids[lens[c]:] < 0).all()
            ids = ids[ids >= 0] + base
            assert (lo[ids] >= tree.nodes_f[node, :3] - 1e-6).all()
            assert (hi[ids] <= tree.nodes_f[node, 3:] + 1e-6).all()


@pytest.mark.parametrize("name", ["grid9", "mesh12"])
def test_primitive_bounds_equal_jax(name):
    j, t = pair(name)
    for got, want in zip(tbvh.primitive_bounds(t.spheres, t.triangles),
                         jbvh.primitive_bounds(j.spheres, j.triangles)):
        np.testing.assert_array_equal(got, want)


def assert_triangles_equal(t, j):
    for field in ("v0", "e1", "e2", "normal", "material"):
        got = getattr(t.triangles, field).numpy()
        want = np.asarray(getattr(j.triangles, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_triangle_soa_from_buffers_equals_jax():
    j, t = pair("mesh12")
    assert len(t.triangles) == len(j.triangles) == 288
    assert_triangles_equal(t, j)
    np.testing.assert_array_equal(t.spheres.center.numpy(),
                                  np.asarray(j.spheres.center))


def _write_obj(path, verts, faces):
    """An OBJ with normals, a quad, a comment and relative indices."""
    lines = ["# sheet", "o sheet"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += ["vn 0 1 0", "vn 0 0.6 0.8"]
    for n, (a, b, c) in enumerate(faces):
        lines.append(f"f {a + 1}//{n % 2 + 1} {b + 1}//1 {c + 1}//2")
    nv = len(verts)
    lines.append(f"f -{nv} -{nv - 1} -{nv - 2} -{nv - 3}")  # a quad
    path.write_text("\n".join(lines) + "\n")


def test_obj_loader_equals_jax(tmp_path):
    verts, faces = sheet_buffers(6)
    path = tmp_path / "sheet.obj"
    _write_obj(path, verts, faces)
    for got, want in zip(load_obj(str(path)), j_load_obj(str(path))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_obj_through_json_mesh_equals_jax(tmp_path):
    """The same OBJ named by a JSON ``Mesh`` object loads into equal
    triangles and an equal tree in both packages (``smooth`` is read and
    ignored)."""
    verts, faces = sheet_buffers(9)
    obj = tmp_path / "sheet.obj"
    _write_obj(obj, verts, faces)
    d = mesh_builder(J, n_side=1, mesh=lambda m: JMesh.from_buffers(
        verts, verts, faces, m)).to_json()
    d["objects"][0] = {"type": "Mesh", "path": str(obj), "material": 0,
                       "smooth": True}
    scene_json = tmp_path / "mesh.json"
    scene_json.write_text(json.dumps(d))
    j = J.SceneBuilder.from_file(str(scene_json)).build(with_bvh=True)
    t = T.SceneBuilder.from_file(str(scene_json)).build(with_bvh=True)
    assert len(t.triangles) == 2 * 81 + 2
    assert_triangles_equal(t, j)
    assert_tree_equal(t.cbvh.triangles, j.cbvh.tri_nodes_f,
                      j.cbvh.tri_nodes_i, j.cbvh.tri_perm)
    # the port writes the mesh back by its path
    back = T.SceneBuilder.from_file(str(scene_json)).to_json()
    assert back["objects"][0] == {"type": "Mesh", "path": str(obj),
                                  "material": 0}


def test_build_follows_enable_bvh_tree():
    b = grid_builder(T, n=3)
    assert b.build().cbvh is not None  # RenderSettings' default: True
    assert b.build(with_bvh=False).cbvh is None
    b.settings = T.RenderSettings(enable_bvh_tree=False)
    assert b.build().cbvh is None and b.build(with_bvh=True).cbvh
