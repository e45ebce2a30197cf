"""Triangle meshes (raytracingrust_tpu/models/mesh.py): host numpy buffers,
flattened into the scene's triangle arrays at build time.

Shading is flat, with the reference's face normal
``normalize((v2 - v1) x (v0 - v1))`` (lib/core/mesh.rs:85-96); its
vertex-normal interpolation is dead code (quirk Q6), so the JAX package's
``smooth`` flag, which nothing reads, is not carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.obj import load_obj


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray    # (V, 3) float32 vertex normals (unused: flat)
    faces: np.ndarray      # (F, 3) int32
    material: int          # material handle
    path: str = ""         # source file, for serialization

    @staticmethod
    def from_file(path: str, material: int) -> "Mesh":
        """Mesh::from_file (lib/core/mesh.rs:63-76)."""
        positions, normals, faces = load_obj(path)
        return Mesh(positions, normals, faces, material, path)

    @staticmethod
    def from_buffers(positions, normals, faces, material: int) -> "Mesh":
        return Mesh(np.asarray(positions, np.float32).reshape(-1, 3),
                    np.asarray(normals, np.float32).reshape(-1, 3),
                    np.asarray(faces, np.int32).reshape(-1, 3), material)

    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    def triangle_soa(self):
        """-> (v0, e1, e2, face normal), (F, 3) float32 each: the
        Moller-Trumbore edges v1 - v0 and v2 - v0 and the reference's flat
        normal."""
        v0 = self.positions[self.faces[:, 0]]
        v1 = self.positions[self.faces[:, 1]]
        v2 = self.positions[self.faces[:, 2]]
        n = np.cross(v2 - v1, v0 - v1)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(norm > 0, norm, 1.0)
        return (v0.astype(np.float32), (v1 - v0).astype(np.float32),
                (v2 - v0).astype(np.float32), n.astype(np.float32))
