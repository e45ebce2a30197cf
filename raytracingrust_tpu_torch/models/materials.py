"""Materials: authoring classes, the struct-of-arrays table and JSON
(raytracingrust_tpu/models/materials.py).

Kind ids and the row layout are those of the JAX package, so a table
built here equals the JAX one array for array.  Mixes resolve to a leaf
material per hit (ops/shade.resolve_mix) on the BVH path; the brute
kernel's envelope refuses them (ops/megakernel.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSION = 3
ISOTROPIC = 4
MIX = 5
MAX_MIX_DEPTH = 4  # mix-of-mix nesting a hit resolves, one coin a level


@dataclasses.dataclass
class Lambertian:
    albedo: tuple


@dataclasses.dataclass
class Metal:
    albedo: tuple
    fuzz: float = 0.0


@dataclasses.dataclass
class Dielectric:
    ir: float


@dataclasses.dataclass
class Emission:
    """``color`` is already multiplied by the emission strength."""
    color: tuple


@dataclasses.dataclass
class Isotropic:
    """Volume phase material."""
    color: tuple


@dataclasses.dataclass
class MixMaterial:
    """Stochastic blend: a uniform >= ``factor`` picks ``first``."""
    first: "AnyMaterial"
    second: "AnyMaterial"
    factor: float


AnyMaterial = (Lambertian | Metal | Dielectric | Emission | Isotropic
               | MixMaterial)


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor        # (M,) int32
    albedo: torch.Tensor      # (M, 3) float32
    fuzz: torch.Tensor        # (M,)
    ir: torch.Tensor          # (M,)
    emission: torch.Tensor    # (M, 3)
    mix_first: torch.Tensor   # (M,) int32, self for non-mix rows
    mix_second: torch.Tensor  # (M,) int32
    mix_factor: torch.Tensor  # (M,)

    @property
    def has_mix(self) -> bool:
        return bool((self.kind == MIX).any())


def build_table(materials: Sequence[AnyMaterial]) -> MaterialTable:
    """Flatten materials (nested mixes included) into a table.  Handle rows
    keep their index; mix children are appended after them."""
    rows: list[dict] = []

    def blank():
        return dict(kind=LAMBERTIAN, albedo=(0.0, 0.0, 0.0), fuzz=0.0, ir=1.0,
                    emission=(0.0, 0.0, 0.0), mix_first=0, mix_second=0,
                    mix_factor=0.0)

    def emit(m: AnyMaterial, slot: int) -> None:
        row = rows[slot]
        if isinstance(m, Lambertian):
            row.update(kind=LAMBERTIAN, albedo=tuple(m.albedo))
        elif isinstance(m, Metal):
            row.update(kind=METAL, albedo=tuple(m.albedo), fuzz=float(m.fuzz))
        elif isinstance(m, Dielectric):
            row.update(kind=DIELECTRIC, ir=float(m.ir))
        elif isinstance(m, Emission):
            row.update(kind=EMISSION, emission=tuple(m.color))
        elif isinstance(m, Isotropic):
            row.update(kind=ISOTROPIC, albedo=tuple(m.color))
        elif isinstance(m, MixMaterial):
            row.update(kind=MIX, mix_first=alloc(m.first),
                       mix_second=alloc(m.second), mix_factor=float(m.factor))
        else:
            raise TypeError(f"unknown material {m!r}")
        if row["kind"] != MIX:
            row["mix_first"] = row["mix_second"] = slot

    def alloc(m: AnyMaterial) -> int:
        slot = len(rows)  # a nested mix appends its children after it
        rows.append(blank())
        emit(m, slot)
        return slot

    rows.extend(blank() for _ in materials)
    if not rows:  # one dummy row keeps the shapes nonzero
        rows.append(blank())
    for i, m in enumerate(materials):
        emit(m, i)

    def col(name, dtype):
        return torch.as_tensor(np.asarray([r[name] for r in rows], dtype))

    return MaterialTable(
        kind=col("kind", np.int32),
        albedo=col("albedo", np.float32),
        fuzz=col("fuzz", np.float32),
        ir=col("ir", np.float32),
        emission=col("emission", np.float32),
        mix_first=col("mix_first", np.int32),
        mix_second=col("mix_second", np.int32),
        mix_factor=col("mix_factor", np.float32),
    )


def material_to_json(m: AnyMaterial) -> dict:
    def rgb(c):
        return {"r": float(c[0]), "g": float(c[1]), "b": float(c[2])}
    if isinstance(m, Lambertian):
        return {"type": "Lambertian", "albedo": rgb(m.albedo)}
    if isinstance(m, Metal):
        return {"type": "Metal", "albedo": rgb(m.albedo),
                "fuzz": float(m.fuzz)}
    if isinstance(m, Dielectric):
        return {"type": "Dielectric", "ir": float(m.ir)}
    if isinstance(m, Emission):
        return {"type": "Emission", "color": rgb(m.color)}
    if isinstance(m, Isotropic):
        return {"type": "Isotropic", "color": rgb(m.color)}
    if isinstance(m, MixMaterial):
        return {"type": "MixMaterial", "first": material_to_json(m.first),
                "second": material_to_json(m.second),
                "factor": float(m.factor)}
    raise TypeError(f"unknown material {m!r}")


def material_from_json(d: dict) -> AnyMaterial:
    def rgb(o):
        return (o["r"], o["g"], o["b"])
    t = d["type"]
    if t == "Lambertian":
        return Lambertian(rgb(d["albedo"]))
    if t == "Metal":
        return Metal(rgb(d["albedo"]), d["fuzz"])
    if t == "Dielectric":
        return Dielectric(d["ir"])
    if t == "Emission":
        return Emission(rgb(d["color"]))
    if t == "Isotropic":
        return Isotropic(rgb(d["color"]))
    if t == "MixMaterial":
        return MixMaterial(material_from_json(d["first"]),
                           material_from_json(d["second"]), d["factor"])
    raise ValueError(f"unknown material type {t!r}")
