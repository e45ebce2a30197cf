"""Backgrounds: uniform color, vertical gradient and the equirect HDRI sky
map (raytracingrust_tpu/models/backgrounds.py).

The sky map's lookup follows the reference (theta = acos(-y), phi =
atan2(-z, x) + pi, nearest texel, x wrap, y flip) and is differentiable in
the image.  Beside it the map carries luminance CDFs, built in numpy with
the JAX package's operations (so they are bitwise its CDFs), for the
importance sampler of :func:`sample_skymap_direction`.  Its inversion
searches: rows by ``torch.searchsorted``, columns by a binary search inside
each ray's row, so no (rays, width) intermediate is formed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils import vec
from ..utils.types import PI

UNIFORM = 0
GRADIENT = 1
SKYMAP = 2
# the lookup's angle scales, float32 reciprocals of pi and 2 pi
INV_PI = float(np.float32(1.0) / np.float32(PI))
INV_TWO_PI = float(np.float32(1.0) / np.float32(2.0 * PI))


@dataclasses.dataclass
class Background:
    kind: int
    color_a: torch.Tensor  # (3,) uniform color, or gradient top
    color_b: torch.Tensor  # (3,) gradient bottom (== color_a when uniform)
    image: Optional[torch.Tensor] = None     # (H, W, 3) sky texels
    cdf_rows: Optional[torch.Tensor] = None  # (H,) marginal CDF over rows
    cdf_cols: Optional[torch.Tensor] = None  # (H, W) CDF within each row
    path: str = ""  # the sky's source file, for to_json

    @staticmethod
    def uniform(color) -> "Background":
        c = torch.as_tensor(color, dtype=torch.float32)
        return Background(UNIFORM, c, c)

    @staticmethod
    def gradient(top, bottom) -> "Background":
        return Background(GRADIENT, torch.as_tensor(top, dtype=torch.float32),
                          torch.as_tensor(bottom, dtype=torch.float32))

    @staticmethod
    def skymap_from_array(image, path: str = "") -> "Background":
        """A sky map from (H, W, 3) float32 texels, with the luminance CDFs
        of its importance sampler: luminance times sin(theta), rows stored
        bottom-up as the lookup's y flip reads them."""
        image = np.asarray(image, np.float32)
        h, w, _ = image.shape
        lum = image @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
        weights = lum * np.sin(theta)[::-1, None] + 1e-12
        row_w = weights.sum(axis=1)
        cdf_rows = np.cumsum(row_w) / row_w.sum()
        cdf_cols = np.cumsum(weights, axis=1) / row_w[:, None]
        zero = torch.zeros(3, dtype=torch.float32)
        return Background(SKYMAP, zero, zero, torch.as_tensor(image),
                          torch.as_tensor(cdf_rows), torch.as_tensor(cdf_cols),
                          path)

    @staticmethod
    def skymap(path: str) -> "Background":
        from ..io.exr import read_exr
        return Background.skymap_from_array(read_exr(path), path=path)

    def _texel(self, sph: torch.Tensor):
        """(row, column) of the texel that (theta, phi) falls in: nearest
        texel, x wrapped, y flipped.  The angles are scaled by float32
        reciprocals, so both devices and kernel #5's lookup
        (csrc/radiance.cuh ``sky_radiance``) round alike (PyTorch divides by
        a scalar as such on the CPU, by its reciprocal on the card)."""
        h, w = self.image.shape[0], self.image.shape[1]
        u = sph[..., 0] * INV_PI
        v = sph[..., 1] * INV_TWO_PI
        x = torch.remainder(torch.floor(v * w).to(torch.int32), w)
        y = (h - 1) - torch.remainder(torch.floor(u * h).to(torch.int32), h)
        return y.long(), x.long()

    def sample(self, directions: torch.Tensor) -> torch.Tensor:
        """Miss radiance for (..., 3) ray directions."""
        if self.kind == UNIFORM:
            return self.color_a.to(directions.device).expand(directions.shape)
        if self.kind == GRADIENT:
            t = 0.5 * (vec.normalize(directions)[..., 1] + 1.0)
            a = self.color_a.to(directions.device)
            b = self.color_b.to(directions.device)
            return a * (1.0 - t)[..., None] + b * t[..., None]
        y, x = self._texel(vec.to_spherical_coords(vec.normalize(directions)))
        return self.image[y, x]

    def pdf(self, directions: torch.Tensor) -> torch.Tensor:
        """Solid-angle pdf of :func:`sample_skymap_direction` at (..., 3)
        unit directions (SKYMAP only)."""
        h, w = self.image.shape[0], self.image.shape[1]
        sph = vec.to_spherical_coords(directions)
        y, x = self._texel(sph)
        p_row = self.cdf_rows - torch.cat([self.cdf_rows.new_zeros(1),
                                           self.cdf_rows[:-1]])
        p_col = self.cdf_cols - torch.cat([self.cdf_cols.new_zeros((h, 1)),
                                           self.cdf_cols[:, :-1]], dim=1)
        p_texel = p_row[y] * p_col[y, x]
        sin_t = torch.clamp(torch.sin(sph[..., 0]), min=1e-6)
        return p_texel * (h * w) / (2.0 * PI * PI * sin_t)

    def to_json(self) -> dict:
        def rgb(c):
            return {"r": float(c[0]), "g": float(c[1]), "b": float(c[2])}
        if self.kind == UNIFORM:
            return {"type": "UniformBackground", "color": rgb(self.color_a)}
        if self.kind == GRADIENT:
            return {"type": "GradientBackground", "top": rgb(self.color_a),
                    "bottom": rgb(self.color_b)}
        if not self.path:
            raise ValueError(
                "SkyMap built from an in-memory array (no source path) "
                "is not JSON-serializable; construct it with "
                "Background.skymap(path) to keep scenes savable")
        return {"type": "SkyMap", "path": self.path,
                "width": int(self.image.shape[1]),
                "height": int(self.image.shape[0])}

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
            if "path" in d:
                return Background.skymap(d["path"])
            # the reference's form: {"image": [colors], "width", "height"}
            img = np.asarray([[c["r"], c["g"], c["b"]] for c in d["image"]],
                             np.float32).reshape(d["height"], d["width"], 3)
            return Background.skymap_from_array(img)
        raise ValueError(f"unknown background type {t!r}")


def _lower_bound(flat_cdf: torch.Tensor, row: torch.Tensor, w: int,
                 u: torch.Tensor) -> torch.Tensor:
    """Per ray, the count of entries of its row of a (H, W) CDF, flattened,
    that lie below u: a binary search of w.bit_length() gather steps."""
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    base = row * w
    for _ in range(w.bit_length()):
        mid = (lo + hi) // 2
        below = (lo < hi) & (flat_cdf[base + mid.clamp(max=w - 1)] < u)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    return lo


def sample_skymap_direction(bg: Background, u1: torch.Tensor,
                            u2: torch.Tensor):
    """Directions drawn proportional to sky luminance times sin(theta) from
    uniforms (R,) u1 and u2: the row from the marginal CDF, the column from
    the row's CDF (each the count of entries below its uniform, as the JAX
    package's compare-and-count), the rest of each uniform's mass as the
    jitter inside the texel.  -> (directions (R, 3), solid-angle pdf
    (R,))."""
    h, w = bg.image.shape[0], bg.image.shape[1]
    y = torch.clamp(torch.searchsorted(bg.cdf_rows, u1.contiguous(),
                                       side="left"),
                    0, h - 1)
    cdf_lo = torch.where(y > 0, bg.cdf_rows[torch.clamp(y - 1, min=0)], 0.0)
    p_row = bg.cdf_rows[y] - cdf_lo
    frac_y = torch.clamp((u1 - cdf_lo) / torch.clamp(p_row, min=1e-20),
                         0.0, 1.0)

    flat = bg.cdf_cols.reshape(-1)
    x = torch.clamp(_lower_bound(flat, y, w, u2), 0, w - 1)
    ccdf_lo = torch.where(x > 0, flat[y * w + torch.clamp(x - 1, min=0)],
                          0.0)
    p_col = flat[y * w + x] - ccdf_lo
    frac_x = torch.clamp((u2 - ccdf_lo) / torch.clamp(p_col, min=1e-20),
                         0.0, 1.0)

    # texel -> angles: the inverse of the lookup's y = h-1 - floor(u h)
    iu = (h - 1) - y
    theta = (iu.to(torch.float32) + frac_y) * (PI / h)
    phi = (x.to(torch.float32) + frac_x) * (2.0 * PI / w)
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.cos(phi - PI), -torch.cos(theta),
                     -sin_t * torch.sin(phi - PI)], dim=-1)
    pdf = (p_row * p_col * (h * w) / (2.0 * PI * PI)
           / torch.clamp(sin_t, min=1e-6))
    return d, pdf
