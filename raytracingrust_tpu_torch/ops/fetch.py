"""Winner-row fetch (#6) and its transpose (#7): the wrappers, their plain
PyTorch versions and the autograd Function that pairs them.

Replaces raytracingrust_tpu/ops/pallas_megakernel.py's fetch kernel pair
(``_make_fetch_kernel`` with ``bwd=False`` and ``bwd=True``, reached
through ``_fetch_rows_cvjp``'s ``run_fwd`` and ``run_bwd``).  For each
(bounce, ray) record code of the BVH kernel's record mode
(ops/bvh_kernel.py) the fetch writes the winner's rows, field-major as
(F, max_depth, R) float32 so the replay (diff/replay.py) takes each field
as a contiguous view:

- fields 0 .. G-1, its geometry row: [center, radius] for a sphere
  (G = 4 when the scene has no triangle, else the rest of the 12 is 0),
  [v0, e1, e2, flat normal] for a triangle (G = 12);
- fields G .. G+7, its material row: albedo rgb, fuzz, ir, emission rgb;

and the winner's material kind, (max_depth, R) int32.  A miss (code -1)
gives zero rows and kind -1.  A mesh volume's code (``mv_base + v``) gives
zero geometry and the material row of the volume's phase material, read
from the (V,) table of the volumes' material ids: the JAX record of a mesh
volume comes from a per-volume table too (``_pack_fparams``), not from a
chunk.  The transpose scatter-adds row cotangents
into the geometry rows by slot and into the material table by material
id.  On the TPU the pair was one-hot matrix products over wide tables; here
it is a gather and a scatter-add whose sums are grouped by the inputs
alone (:func:`transpose_plan`), the same bits on every run and card.

The sphere-like table holds the solid spheres' slots and then the volume
spheres' (ops/bvh_kernel.fetch_inputs), as the codes number them.  In raw
mode (a scene with mixes, whose winner's material depends on the bounce's
coins) the fetch writes the G geometry fields only and, in place of the
kind, the winner's raw material id; the transpose then scatters geometry
only, and the material table's gradient comes from the replay's own
indexing of it.

On a CPU tensor the wrappers run the plain versions (index gathers and
``index_add_``); on a CUDA tensor they launch the kernels or raise.
``FETCH_LAUNCHES`` and ``TRANSPOSE_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import megakernel as K

# the code's slot bits (ops/bvh_kernel.REC_SLOT)
_SLOT = (1 << 27) - 1
MAT_FIELDS = 8

FETCH_LAUNCHES = 0
TRANSPOSE_LAUNCHES = 0

# #7's plan (csrc/fetch_rows.cu takes it as given): the dynamic shared
# memory a block may take on the card (sm_90's opt-in maximum, 227 KB);
# the segments of the codes the hits are compacted in; the small path's
# blocks and its warps a block, each holding a copy of the table in shared
# memory; the large path's warps a block, each with a copy of the table in
# global memory, and the bytes those copies may take, within the fewest
# and the most copies
SMEM_BYTES = 227 * 1024
SEGMENTS = 264
RANGES = 528
SMALL_WARPS = 8
LARGE_WARPS = 4
COPY_BYTES = 192 << 20
MIN_COPIES = 16
MAX_COPIES = 1056


def geo_fields(tri_geo: Optional[torch.Tensor]) -> int:
    """G: the geometry fields of a fetched row."""
    return 4 if tri_geo is None else 12


def _winners(codes: torch.Tensor, tri_base: int, mv_base=None):
    """(hit, is_sphere, is_triangle, is_mesh_volume, slot within its tree or
    the mesh volume) of flat codes."""
    hit = codes >= 0
    slot = codes & _SLOT
    is_mv = hit & (slot >= (_SLOT + 1 if mv_base is None else mv_base))
    is_tri = hit & (slot >= tri_base) & ~is_mv
    slot = torch.where(is_tri, slot - tri_base, slot)
    if mv_base is not None:
        slot = torch.where(is_mv, slot - mv_base, slot)
    return hit, hit & ~is_tri & ~is_mv, is_tri, is_mv, slot.long()


def fetch_rows_plain(codes, kinds, tri_base, sph_mat, tri_mat, mats, sph_geo,
                     tri_geo, raw=False, mv_base=None, mv_mat=None):
    """-> (rows (G + 8, *codes.shape) float32, kind codes.shape int32); in
    raw mode (G, *codes.shape) rows and the raw material id for the
    kind.  ``mv_base`` and ``mv_mat`` (V,): the mesh volumes' first code
    and material ids, None without mesh volumes."""
    flat = codes.reshape(-1)
    hit, is_sph, is_tri, is_mv, slot = _winners(flat, tri_base, mv_base)
    g = geo_fields(tri_geo)
    f = g if raw else g + MAT_FIELDS
    rows = torch.zeros((f, flat.shape[0]), dtype=torch.float32,
                       device=flat.device)
    mid = torch.zeros_like(slot)
    for geo, mat, won in ((sph_geo, sph_mat, is_sph),
                          (tri_geo, tri_mat, is_tri)):
        if geo is not None:
            at = torch.where(won, slot, 0)
            w = geo.shape[1]
            rows[:w] = torch.where(won, geo[at].T, rows[:w])
            mid = torch.where(won, mat[at].long(), mid)
    if mv_mat is not None:
        mid = torch.where(is_mv, mv_mat[torch.where(is_mv, slot, 0)].long(),
                          mid)
    if not raw:
        rows[g:] = torch.where(hit, mats[mid].T, 0.0)
    kind = torch.where(hit, mid if raw else kinds[mid], -1).to(torch.int32)
    return rows.view(f, *codes.shape), kind.view(codes.shape)


def fetch_rows_transpose_plain(codes, g_rows, tri_base, sph_mat, tri_mat,
                               n_mats, n_sph, n_tri, raw=False, mv_base=None,
                               mv_mat=None):
    """Row cotangents (G + 8, *codes.shape), or (G, ...) in raw mode ->
    (d sphere-like rows (n_sph, 4) or None, d triangle rows (n_tri, 12) or
    None, d material table (n_mats, 8), None in raw mode), in the
    cotangents' dtype.  A mesh volume's code adds its material cotangent
    to its phase material's row, and its geometry's nowhere."""
    flat = codes.reshape(-1)
    g_rows = g_rows.reshape(g_rows.shape[0], -1)
    hit, is_sph, is_tri, is_mv, slot = _winners(flat, tri_base, mv_base)
    g = g_rows.shape[0] - (0 if raw else MAT_FIELDS)
    mid = torch.zeros_like(slot)
    out = []
    for n, w, mat, won in ((n_sph, 4, sph_mat, is_sph),
                           (n_tri, 12, tri_mat, is_tri)):
        if mat is None:
            out.append(None)
            continue
        out.append(torch.zeros((n, w), dtype=g_rows.dtype,
                               device=flat.device).index_add_(
            0, slot[won], g_rows[:w, won].T))
        mid = torch.where(won, mat[torch.where(won, slot, 0)].long(), mid)
    if mv_mat is not None:
        mid = torch.where(is_mv, mv_mat[torch.where(is_mv, slot, 0)].long(),
                          mid)
    if raw:
        return out[0], out[1], None
    d_mats = torch.zeros((n_mats, MAT_FIELDS), dtype=g_rows.dtype,
                         device=flat.device).index_add_(
        0, mid[hit], g_rows[g:, hit].T)
    return out[0], out[1], d_mats


def table_floats(n_sph: int, n_tri: int, n_mats: int, raw: bool) -> int:
    """The floats of #7's flat table: the sphere-like rows, the triangle
    rows and, unless raw, the material rows."""
    return 4 * n_sph + 12 * n_tri + (0 if raw else MAT_FIELDS * n_mats)


def transpose_plan(n_floats: int) -> dict:
    """#7's launch for a flat table of ``n_floats``, a function of that
    size alone, never of the card: the sums group the same way on every
    run and every card.  -> ``path``: "small" where SMALL_WARPS copies of
    the table fit a block's shared memory, each warp summing into its own
    (``shared``), else "large": LARGE_WARPS warps a block, each summing
    into its own copy in global memory, as many copies as COPY_BYTES
    holds within MIN_COPIES and MAX_COPIES; ``warps`` and ``blocks``;
    ``segments``, the compaction's blocks, each a fixed share of the
    codes; ``smem``, the dynamic shared memory of a block of the sums
    (its copies where shared, and two tables of the segments: the
    kernel's ``transpose_smem``); and the shape of the ``partials``
    scratch, a row a block's copies (small) or a copy (large)."""
    if n_floats < 4 or n_floats % 4:
        raise ValueError(f"#7's table has {n_floats} floats")
    segment_bytes = 16 * ((2 * SEGMENTS + 4) // 4)  # from a float4
    if SMALL_WARPS * 4 * n_floats + segment_bytes <= SMEM_BYTES:
        path, shared, warps = "small", True, SMALL_WARPS
        blocks = rows = RANGES
    else:
        copies = max(MIN_COPIES, min(MAX_COPIES, COPY_BYTES // (4 * n_floats)))
        rows = copies // LARGE_WARPS * LARGE_WARPS
        path, shared, warps, blocks = ("large", False, LARGE_WARPS,
                                       rows // LARGE_WARPS)
    return dict(path=path, shared=shared, warps=warps, blocks=blocks,
                segments=SEGMENTS,
                smem=(4 * warps * n_floats if shared else 0) + segment_bytes,
                partials=(rows, n_floats))


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check_trees(fn, codes, tri_base, sph_mat, tri_mat, n_sph, n_tri,
                 mv_base=None, mv_mat=None):
    """Check the codes, the trees' slot material ids and the mesh volumes'
    material ids; -> the device."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    K._check(codes, "codes", torch.int32, tuple(codes.shape), dev)
    if not 0 < codes.numel() < 2 ** 31:
        raise ValueError(f"{fn}: {codes.numel()} codes")
    if sph_mat is None and tri_base:
        raise ValueError("tri_base must be 0 without a sphere tree")
    if sph_mat is not None and n_sph != tri_base:
        raise ValueError(f"{n_sph} sphere slots, tri_base {tri_base}")
    for mat, n in ((sph_mat, n_sph), (tri_mat, n_tri)):
        if mat is not None:
            K._check(mat, "mat", torch.int32, (n,), dev)
    if (mv_base is None) != (mv_mat is None):
        raise ValueError("mesh volumes need mv_base and their material ids")
    if mv_mat is not None:
        K._check(mv_mat, "mv_mat", torch.int32, (mv_mat.shape[0],), dev)
        if mv_base != tri_base + n_tri or mv_mat.shape[0] < 1:
            raise ValueError(f"mv_base {mv_base} is not tri_base {tri_base} "
                             f"+ {n_tri} triangle slots")
    return dev


def _mv_args(mv_base, mv_mat) -> list:
    """(mv_base, material ids pointer, count) of the C entries: -1, null
    and 0 without mesh volumes."""
    if mv_mat is None:
        return [-1, ctypes.c_void_p(0), 0]
    return [mv_base, _ptr(mv_mat), mv_mat.shape[0]]


def fetch_rows_cuda(codes, kinds, tri_base, sph_mat, tri_mat, mats, sph_geo,
                    tri_geo, raw=False, mv_base=None, mv_mat=None):
    """Kernel #6: as :func:`fetch_rows_plain`, on the card."""
    global FETCH_LAUNCHES
    from . import _build

    if (sph_geo is None) != (sph_mat is None) or (
            (tri_geo is None) != (tri_mat is None)):
        raise ValueError("each tree needs its rows and its material ids")
    dev = _check_trees("fetch_rows_cuda", codes, tri_base, sph_mat, tri_mat,
                       0 if sph_geo is None else sph_geo.shape[0],
                       0 if tri_geo is None else tri_geo.shape[0], mv_base,
                       mv_mat)
    m = kinds.shape[0]
    K._check(kinds, "kinds", torch.int32, (m,), dev)
    for name, t, shape in (("mats", mats, (m, MAT_FIELDS)),
                           ("sphere rows", sph_geo, (tri_base, 4)),
                           ("triangle rows", tri_geo, None)):
        if t is None:
            continue
        K._check(t, name, torch.float32, shape or (t.shape[0], 12), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    g = geo_fields(tri_geo)
    rows = torch.empty((g + (0 if raw else MAT_FIELDS), *codes.shape),
                       dtype=torch.float32, device=dev)
    kind = torch.empty(codes.shape, dtype=torch.int32, device=dev)
    lib = _build.load("fetch_rows")
    with torch.cuda.device(dev):
        err = lib.rtrt_fetch_rows(
            _ptr(codes), codes.numel(), _ptr(sph_geo), _ptr(sph_mat),
            _ptr(tri_geo), _ptr(tri_mat), tri_base, _ptr(mats), _ptr(kinds),
            g, int(bool(raw)), _ptr(rows), _ptr(kind),
            *_mv_args(mv_base, mv_mat),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_fetch_rows launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    FETCH_LAUNCHES += 1
    return rows, kind


def fetch_rows_transpose_cuda(codes, g_rows, tri_base, sph_mat, tri_mat,
                              n_mats, n_sph, n_tri, raw=False, mv_base=None,
                              mv_mat=None):
    """Kernel #7: as :func:`fetch_rows_transpose_plain`, on the card, in
    three launches with :func:`transpose_plan`'s grouping: the same
    inputs give the same bits."""
    global TRANSPOSE_LAUNCHES
    from . import _build

    dev = _check_trees("fetch_rows_transpose_cuda", codes, tri_base,
                       sph_mat, tri_mat, n_sph, n_tri, mv_base, mv_mat)
    g = 4 if tri_mat is None else 12
    K._check(g_rows, "g_rows", torch.float32,
             (g + (0 if raw else MAT_FIELDS), *codes.shape), dev)
    if n_mats < 1:
        raise ValueError(f"{n_mats} materials")
    n_sph = 0 if sph_mat is None else n_sph
    n_tri = 0 if tri_mat is None else n_tri
    plan = transpose_plan(table_floats(n_sph, n_tri, n_mats, raw))
    out = [None if mat is None else torch.empty((n, w), dtype=torch.float32,
                                                device=dev)
           for mat, n, w in ((sph_mat, n_sph, 4), (tri_mat, n_tri, 12))]
    d_mats = None if raw else torch.empty((n_mats, MAT_FIELDS),
                                          dtype=torch.float32, device=dev)
    # scratch: the hits' (index, code) pairs, each segment's count, and
    # the copies' sums
    hits = torch.empty((codes.numel(), 2), dtype=torch.int32, device=dev)
    counts = torch.empty(plan["segments"], dtype=torch.int32, device=dev)
    partials = torch.empty(plan["partials"], dtype=torch.float32, device=dev)
    lib = _build.load("fetch_rows")
    with torch.cuda.device(dev):
        err = lib.rtrt_fetch_rows_transpose(
            _ptr(codes), codes.numel(), _ptr(sph_mat), _ptr(tri_mat),
            tri_base, n_tri, _ptr(g_rows), g, int(bool(raw)), n_mats,
            *_mv_args(mv_base, mv_mat), plan["segments"], plan["warps"],
            plan["blocks"], int(plan["shared"]), _ptr(hits), _ptr(counts),
            _ptr(partials), _ptr(out[0]), _ptr(out[1]), _ptr(d_mats),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"rtrt_fetch_rows_transpose launch failed: CUDA "
                           f"error {err} ({_build.error_string(err)})")
    TRANSPOSE_LAUNCHES += 1
    return out[0], out[1], d_mats


def fetch_rows(*args):
    """#6 on a CUDA device, its plain version on the CPU."""
    cuda = K.select_engine(args[0].device) == "cuda"
    return (fetch_rows_cuda if cuda else fetch_rows_plain)(*args)


def fetch_rows_transpose(*args):
    """#7 on a CUDA device, its plain version on the CPU."""
    cuda = K.select_engine(args[0].device) == "cuda"
    return (fetch_rows_transpose_cuda if cuda
            else fetch_rows_transpose_plain)(*args)


class FetchRows(torch.autograd.Function):
    """The winners' rows, differentiable in the material table and the
    primitive rows: #6 forward, #7 backward (the port of
    ``_fetch_rows_cvjp``).  Arguments: codes, kinds, tri_base, the
    sphere-like and the triangle slots' material ids (or None), then the
    differentiable material table and the two tables' rows (or None), raw,
    and mv_base and the mesh volumes' material ids (or None).  -> (rows,
    kind)."""

    @staticmethod
    def forward(ctx, codes, kinds, tri_base, sph_mat, tri_mat, mats, sph_geo,
                tri_geo, raw=False, mv_base=None, mv_mat=None):
        rows, kind = fetch_rows(codes, kinds, tri_base, sph_mat, tri_mat,
                                mats, sph_geo, tri_geo, raw, mv_base, mv_mat)
        ctx.mark_non_differentiable(kind)
        ctx.save_for_backward(codes, sph_mat, tri_mat, mv_mat)
        ctx.sizes = (tri_base, mats.shape[0],
                     0 if sph_geo is None else sph_geo.shape[0],
                     0 if tri_geo is None else tri_geo.shape[0], raw,
                     mv_base)
        return rows, kind

    @staticmethod
    def backward(ctx, g_rows, _g_kind):
        codes, sph_mat, tri_mat, mv_mat = ctx.saved_tensors
        tri_base, n_mats, n_sph, n_tri, raw, mv_base = ctx.sizes
        d_sph, d_tri, d_mats = fetch_rows_transpose(
            codes, g_rows.contiguous(), tri_base, sph_mat, tri_mat, n_mats,
            n_sph, n_tri, raw, mv_base, mv_mat)
        return (None, None, None, None, None, d_mats, d_sph, d_tri, None,
                None, None)
