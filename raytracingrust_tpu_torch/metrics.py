"""Render statistics (raytracingrust_tpu/metrics.py, ``RenderStats``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_depth: int

    @property
    def primary_rays(self) -> int:
        return self.width * self.height * self.spp

    def mrays_per_s(self, elapsed_s: float) -> float:
        """Primary Mrays/s; bounce rays are a scene-dependent multiple."""
        return self.primary_rays / elapsed_s / 1e6
