"""Procedural heightmaps and their bilinear surface (counterpart of
``d3d12renderer_tpu/terrain/heightmap.py``: `_hash2`, `_value_noise`,
`fbm`, `generate_heightmap` and `sample_height_bilinear`).

The lattice hash is the JAX package's uint32 arithmetic, computed in int64
with the low 32 bits kept after every multiply and add, so that it equals
JAX's bit for bit.  The noise's float32 operations follow the JAX module's
order.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _hash2(ix, iy, seed: int):
    """Integer lattice hash (int tensors, a Python int seed) -> float32 in
    [0, 1), as the JAX package's uint32 hash."""
    x = ix.to(torch.int64) & _MASK
    y = iy.to(torch.int64) & _MASK
    h = (((x * 374761393) & _MASK) + ((y * 668265263) & _MASK)
         + ((seed & _MASK) * 2654435761 & _MASK)) & _MASK
    h = ((h ^ (h >> 13)) * 1274126177) & _MASK
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def _value_noise(x, y, seed: int):
    """Smooth value noise on a unit lattice."""
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    fx = x - ix.to(x.dtype)
    fy = y - iy.to(y.dtype)
    # Quintic smoothstep (Perlin's fade).
    ux = fx * fx * fx * (fx * (fx * 6 - 15) + 10)
    uy = fy * fy * fy * (fy * (fy * 6 - 15) + 10)
    v00 = _hash2(ix, iy, seed)
    v10 = _hash2(ix + 1, iy, seed)
    v01 = _hash2(ix, iy + 1, seed)
    v11 = _hash2(ix + 1, iy + 1, seed)
    return (v00 * (1 - ux) * (1 - uy) + v10 * ux * (1 - uy)
            + v01 * (1 - ux) * uy + v11 * ux * uy)


def fbm(x, y, octaves: int = 6, lacunarity: float = 2.0, gain: float = 0.5,
        seed: int = 1):
    """Fractional Brownian motion: `octaves` octaves of value noise."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros_like(x)
    norm = 0.0
    for o in range(octaves):
        total = total + amp * _value_noise(x * freq, y * freq, seed + o)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def generate_heightmap(resolution: int = 128, world_size: float = 64.0,
                       amplitude: float = 8.0, noise_scale: float = 0.05,
                       warp_strength: float = 1.5, octaves: int = 6,
                       seed: int = 1):
    """(R, R) float32 heights, domain-warped fBm, on the CPU: scene data
    for the builder, which takes host arrays."""
    coords = (torch.arange(resolution, dtype=torch.float32)
              / (resolution - 1) * world_size)
    gx, gz = torch.meshgrid(coords, coords, indexing="ij")
    x = gx * noise_scale
    z = gz * noise_scale
    # Domain warp: offset the sample coordinates by low-frequency noise.
    wx = fbm(x + 13.7, z + 7.1, octaves=3, seed=seed + 100)
    wz = fbm(x - 5.3, z + 19.4, octaves=3, seed=seed + 200)
    h = fbm(x + warp_strength * wx, z + warp_strength * wz, octaves=octaves,
            seed=seed)
    return h * amplitude


def sample_height_bilinear(heights, origin, cell_size, x, z):
    """Bilinear height and unit surface normal at world (x, z).

    heights (R0, R1): axis 0 runs along x, axis 1 along z.  `origin` (3,)
    and `cell_size` are numbers or tensors that broadcast with x and z,
    which take any shape.  Points outside clamp to the border.  Returns
    (height (...), normal (..., 3))."""
    u = (x - origin[0]) / cell_size
    v = (z - origin[2]) / cell_size
    r0, r1 = heights.shape[-2], heights.shape[-1]
    u = torch.clamp(u, 0.0, r0 - 1.001)
    v = torch.clamp(v, 0.0, r1 - 1.001)
    iu = torch.floor(u).to(torch.int64)
    iv = torch.floor(v).to(torch.int64)
    fu = u - iu.to(u.dtype)
    fv = v - iv.to(v.dtype)
    h00 = heights[iu, iv]
    h10 = heights[iu + 1, iv]
    h01 = heights[iu, iv + 1]
    h11 = heights[iu + 1, iv + 1]
    h = (h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv)
         + h01 * (1 - fu) * fv + h11 * fu * fv)
    # The analytic bilinear gradient.
    dhdu = (h10 - h00) * (1 - fv) + (h11 - h01) * fv
    dhdv = (h01 - h00) * (1 - fu) + (h11 - h10) * fu
    n = torch.stack([-dhdu / cell_size, torch.ones_like(h),
                     -dhdv / cell_size], -1)
    n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True))
    return origin[1] + h, n
