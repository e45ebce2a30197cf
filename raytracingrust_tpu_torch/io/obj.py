"""Wavefront OBJ loader -> SoA triangle buffers
(raytracingrust_tpu/io/obj.py).

As the reference's obj-rs ingestion uses it (lib/core/mesh.rs:63-76): only
``v``, ``vn`` and ``f`` are read; faces of more than three vertices are
fan-triangulated; negative (relative) indices work; a vertex is a
(position, normal) pair, welded on first use, and a face without normals
gets zero normals.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """-> (positions (V, 3) float32, normals (V, 3) float32, faces (F, 3)
    int32), V indexing the welded (position, normal) pairs."""
    raw_pos: list[tuple[float, float, float]] = []
    raw_nrm: list[tuple[float, float, float]] = []
    welded: dict[tuple[int, int], int] = {}
    positions: list[tuple[float, float, float]] = []
    normals: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    def vertex(token: str) -> int:
        parts = token.split("/")
        pi = resolve(int(parts[0]), len(raw_pos))
        ni = -1
        if len(parts) >= 3 and parts[2]:
            ni = resolve(int(parts[2]), len(raw_nrm))
        if (pi, ni) not in welded:
            welded[(pi, ni)] = len(positions)
            positions.append(raw_pos[pi])
            normals.append(raw_nrm[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return welded[(pi, ni)]

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                raw_pos.append(tuple(float(p) for p in parts[1:4]))
            elif parts[0] == "vn" and len(parts) >= 4:
                raw_nrm.append(tuple(float(p) for p in parts[1:4]))
            elif parts[0] == "f" and len(parts) >= 4:
                idx = [vertex(tok) for tok in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    return (np.asarray(positions, np.float32).reshape(-1, 3),
            np.asarray(normals, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))
