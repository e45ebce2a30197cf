"""Counter-based Threefry-2x32 random numbers, bit-identical to
raytracingrust_tpu/utils/rng.py.

Every draw is a pure function of (seed, ray id, stream, column): uniform
column c of stream s for ray r is word (c % 2) of
``threefry2x32(seed_hi, seed_lo, x0=r, x1=s * CIPHER_BLOCK + c // 2)``.
Stream 0 is the pixel jitter, stream 1 + b is bounce b.

The tensor version runs in int64 with every sum and shift masked to 32
bits: PyTorch on the CPU implements neither ``+`` nor the shifts for
``uint32``.  The CUDA kernels (csrc/radiance.cuh) run the same cipher on
native ``uint32``; chip_smoke.py holds the two to each other bit for bit.
"""

from __future__ import annotations

import torch

from .types import PI

CIPHER_BLOCK = 256
THREEFRY_ROUNDS = 13

_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)
_MASK = 0xFFFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1, rounds: int = THREEFRY_ROUNDS):
    """Threefry-2x32 with any round count (key injection after every 4th
    round).  Arguments are int64 tensors (or Python ints) holding values in
    [0, 2^32); returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(rounds):
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, _ROTS[i % 8]) ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = (x0 + ks[j % 3]) & _MASK
            x1 = (x1 + ks[(j + 1) % 3] + j) & _MASK
    return x0, x1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 holding a uint32) -> float32 in [0, 1): set the
    exponent of 1.0, fill the mantissa with the top 23 bits, subtract 1."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def base_key(seed: int) -> tuple[int, int]:
    """64-bit seed -> (hi, lo) cipher key words, each in [0, 2^32).  The
    words are the seed's bits, not a conversion of its value."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & _MASK


def ray_uniforms(key: tuple[int, int], ray_ids: torch.Tensor, stream: int,
                 n: int) -> torch.Tensor:
    """(R, n) float32 uniforms of one stream for global ``ray_ids`` (R,).
    The stream's ciphers run side by side, one (R, ciphers) tensor."""
    n_ciphers = -(-n // 2)
    if n_ciphers > CIPHER_BLOCK:
        raise ValueError(f"{n} uniforms exceed the stream's cipher block")
    x0 = (ray_ids.to(torch.int64) & _MASK)[:, None]
    base = (int(stream) * CIPHER_BLOCK) & _MASK
    x1 = (base + torch.arange(n_ciphers, device=ray_ids.device)) & _MASK
    a0, a1 = threefry2x32(key[0], key[1], x0, x1[None, :])
    cols = torch.stack([bits_to_uniform(a0), bits_to_uniform(a1)], dim=-1)
    return cols.reshape(ray_ids.shape[0], 2 * n_ciphers)[:, :n].contiguous()


def unit_sphere_surface(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """(..., 3) uniform directions on the unit sphere from two uniforms
    (the distribution of lib/utils/sample.rs:71-79, without its rejection
    loop): z = 1 - 2 u1, the azimuth 2 pi u2."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * PI) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cbrt01(u: torch.Tensor) -> torch.Tensor:
    """The cube root of a uniform as ``exp(log(max(u, 1e-38)) * (1/3))``,
    the JAX package's formula (utils/rng.py ``cbrt01``), which the
    isotropic lobe of every engine shares so their directions agree bit for
    bit; csrc/radiance.cuh computes the same with ``logf`` and ``expf``."""
    return torch.exp(torch.log(torch.clamp(u, min=1e-38)) * (1.0 / 3.0))


def unit_sphere_volume(u1, u2, u3) -> torch.Tensor:
    """(..., 3) uniform points in the unit ball (lib/utils/sample.rs:40-57):
    a direction times the cube root of a third uniform."""
    return unit_sphere_surface(u1, u2) * cbrt01(u3)[..., None]
