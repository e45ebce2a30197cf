"""Backgrounds: uniform color and vertical gradient
(raytracingrust_tpu/models/backgrounds.py).

The HDRI sky map is not ported yet (ROADMAP A5): its JSON raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import vec

UNIFORM = 0
GRADIENT = 1
SKYMAP = 2


@dataclasses.dataclass
class Background:
    kind: int
    color_a: torch.Tensor  # (3,) uniform color, or gradient top
    color_b: torch.Tensor  # (3,) gradient bottom (== color_a when uniform)

    @staticmethod
    def uniform(color) -> "Background":
        c = torch.as_tensor(color, dtype=torch.float32)
        return Background(UNIFORM, c, c)

    @staticmethod
    def gradient(top, bottom) -> "Background":
        return Background(GRADIENT, torch.as_tensor(top, dtype=torch.float32),
                          torch.as_tensor(bottom, dtype=torch.float32))

    def sample(self, directions: torch.Tensor) -> torch.Tensor:
        """Miss radiance for (..., 3) ray directions."""
        if self.kind == UNIFORM:
            return self.color_a.to(directions.device).expand(directions.shape)
        t = 0.5 * (vec.normalize(directions)[..., 1] + 1.0)
        a = self.color_a.to(directions.device)
        b = self.color_b.to(directions.device)
        return a * (1.0 - t)[..., None] + b * t[..., None]

    def to_json(self) -> dict:
        def rgb(c):
            return {"r": float(c[0]), "g": float(c[1]), "b": float(c[2])}
        if self.kind == UNIFORM:
            return {"type": "UniformBackground", "color": rgb(self.color_a)}
        return {"type": "GradientBackground", "top": rgb(self.color_a),
                "bottom": rgb(self.color_b)}

    @staticmethod
    def from_json(d: dict) -> "Background":
        def rgb(o):
            return (o["r"], o["g"], o["b"])
        t = d["type"]
        if t == "UniformBackground":
            return Background.uniform(rgb(d["color"]))
        if t == "GradientBackground":
            return Background.gradient(rgb(d["top"]), rgb(d["bottom"]))
        if t == "SkyMap":
            raise NotImplementedError(
                "SkyMap backgrounds are not ported yet (ROADMAP A5)")
        raise ValueError(f"unknown background type {t!r}")
