"""Color conversion at the output edge (raytracingrust_tpu/utils/color.py)."""

from __future__ import annotations

import torch


def to_rgba8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 -> (..., 4) uint8 RGBA: scale by 255, floor,
    saturate to [0, 255], opaque alpha."""
    raw = torch.clamp(torch.floor(rgb * 255.0), 0.0, 255.0).to(torch.uint8)
    alpha = torch.full(raw.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=raw.device)
    return torch.cat([raw, alpha], dim=-1)
