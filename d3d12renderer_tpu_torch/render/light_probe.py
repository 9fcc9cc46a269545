"""Dynamic diffuse GI from a grid of light probes, DDGI-style (counterpart
of ``d3d12renderer_tpu/render/light_probe.py``).

Each update casts a spherical-Fibonacci ray set, rotated by a random
angle, from every probe in one closest-hit query (the BVH ray kernel on
the card), shades the hits with the sun (one any-hit query for its
visibility) and the sky, and blends the rays into each probe's 8x8
octahedral irradiance and 16x16 depth (mean, mean^2) texels with
hysteresis 0.97.  Shading samples the 8 surrounding probes trilinearly,
weighted by facing and a Chebyshev visibility test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import maths as m
from ..cuda_build import resolve_device
from . import bvh as bvh_mod
from .pathtracer import Scene, sky_radiance

IRRADIANCE_RES = 8   # octahedral texels per probe side
DEPTH_RES = 16
HYSTERESIS = 0.97


@dataclass
class LightProbeGrid:
    origin: torch.Tensor             # (3,)
    spacing: torch.Tensor            # (3,)
    dims: Tuple[int, int, int]
    irradiance: torch.Tensor = None  # (P, R, R, 3)
    depth: torch.Tensor = None       # (P, Rd, Rd, 2) mean, mean^2

    @property
    def num_probes(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def create_probe_grid(origin, extent, dims=(6, 3, 6),
                      device="cuda") -> LightProbeGrid:
    """dims probes spanning `extent` from `origin`, their atlases zero."""
    device = resolve_device(device)
    nx, ny, nz = dims
    spacing = (torch.as_tensor(np.asarray(extent, np.float32), device=device)
               / torch.tensor([max(nx - 1, 1), max(ny - 1, 1),
                               max(nz - 1, 1)], dtype=torch.float32,
                              device=device))
    p = nx * ny * nz
    return LightProbeGrid(
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        spacing=spacing, dims=tuple(dims),
        irradiance=torch.zeros((p, IRRADIANCE_RES, IRRADIANCE_RES, 3),
                               device=device),
        depth=torch.zeros((p, DEPTH_RES, DEPTH_RES, 2), device=device))


def probe_positions(grid: LightProbeGrid) -> torch.Tensor:
    """(P, 3), probe (ix, iy, iz) at row (ix ny + iy) nz + iz."""
    dev = grid.origin.device
    ii = torch.stack(torch.meshgrid(*(torch.arange(n, device=dev)
                                      for n in grid.dims), indexing="ij"),
                     -1).reshape(-1, 3)
    return grid.origin + ii.to(torch.float32) * grid.spacing


def oct_decode(uv):
    """uv in [-1, 1]^2 -> unit direction."""
    x, y = uv[..., 0], uv[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    sx = torch.where(x >= 0, 1.0, -1.0)
    sy = torch.where(y >= 0, 1.0, -1.0)
    xf = torch.where(z < 0, (1 - torch.abs(y)) * sx, x)
    yf = torch.where(z < 0, (1 - torch.abs(x)) * sy, y)
    d = torch.stack([xf, yf, z], -1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _texel_dirs(res: int, device) -> torch.Tensor:
    u = (torch.arange(res, device=device) + 0.5) / res * 2 - 1
    gu, gv = torch.meshgrid(u, u, indexing="ij")
    return oct_decode(torch.stack([gu, gv], -1))          # (R, R, 3)


def _pow8(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def update_probes(grid: LightProbeGrid, scene: Scene, rotation=None,
                  generator: Optional[torch.Generator] = None,
                  rays_per_probe: int = 64,
                  sun_visibility: bool = True) -> LightProbeGrid:
    """One probe update.  `rotation`: the ray set's random turn as a
    uniform draw in [0, 1) (a 0-d tensor; JAX's `jax.random.uniform(key)`),
    else drawn from `generator`."""
    pos = probe_positions(grid)                               # (P, 3)
    p = pos.shape[0]
    dev = pos.device
    if rotation is None:
        rotation = torch.rand((), generator=generator, device=dev)
    phi0 = torch.as_tensor(rotation, dtype=torch.float32, device=dev) \
        * 2 * math.pi
    i = torch.arange(rays_per_probe, dtype=torch.float32, device=dev) + 0.5
    phi = i * (math.pi * (3.0 - math.sqrt(5.0))) + phi0
    cos_t = 1.0 - 2.0 * i / rays_per_probe
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0))
    dirs = torch.stack([sin_t * torch.cos(phi), cos_t,
                        sin_t * torch.sin(phi)], -1)           # (R, 3)

    o = pos.repeat_interleave(rays_per_probe, 0)              # (P R, 3)
    d = dirs.repeat(p, 1)
    res = bvh_mod.closest_hit(scene.bvh, o, d)
    _, gn, _, mat = bvh_mod.hit_attributes(scene.bvh, res)
    hit = res["hit"]
    t = torch.where(hit, res["t"], 1e4)

    albedo = scene.materials.albedo[mat]
    gn = torch.where((torch.sum(gn * d, -1) > 0)[:, None], -gn, gn)
    sun_l = scene.sky.sun_direction
    ndl = torch.clamp(torch.sum(gn * sun_l, -1), min=0.0)
    if sun_visibility:
        hp = o + d * t[:, None] + gn * 1e-2
        blocked = bvh_mod.any_hit(scene.bvh, hp, sun_l.expand(hp.shape), 1e4)
        ndl = ndl * (~blocked)
    direct = albedo * (scene.sky.sun_radiance * 0.05) * ndl[:, None]
    ambient = albedo * (scene.sky.horizon * 0.3)
    radiance = torch.where(hit[:, None], direct + ambient,
                           sky_radiance(scene.sky, d))
    radiance = radiance.reshape(p, rays_per_probe, 3)
    dist = t.reshape(p, rays_per_probe)

    # Irradiance texels: the rays' radiance, cosine-weighted by texel
    # direction; depth texels: cosine^8-weighted mean and mean^2 distance.
    w = torch.clamp(_texel_dirs(IRRADIANCE_RES, dev).reshape(-1, 3)
                    @ dirs.T, min=0.0)                         # (T, R)
    num = torch.einsum("tr,prc->ptc", w, radiance)
    den = torch.clamp(w.sum(-1), min=1e-4)
    new_irr = (num / den[:, None]).reshape(p, IRRADIANCE_RES,
                                           IRRADIANCE_RES, 3)
    wd = _pow8(torch.clamp(_texel_dirs(DEPTH_RES, dev).reshape(-1, 3)
                           @ dirs.T, min=0.0))
    dend = torch.clamp(wd.sum(-1), min=1e-4)
    mean = (dist @ wd.T) / dend
    mean2 = ((dist * dist) @ wd.T) / dend
    new_depth = torch.stack([mean, mean2], -1).reshape(p, DEPTH_RES,
                                                        DEPTH_RES, 2)

    first = (grid.irradiance == 0).all()
    h = torch.where(first, 0.0, HYSTERESIS)
    return replace(grid, irradiance=grid.irradiance * h + new_irr * (1 - h),
                   depth=grid.depth * h + new_depth * (1 - h))


def _oct_encode(d):
    l1 = torch.sum(torch.abs(d), -1, keepdim=True)
    v = d / torch.clamp(l1, min=1e-9)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    sx = torch.where(x >= 0, 1.0, -1.0)
    sy = torch.where(y >= 0, 1.0, -1.0)
    xe = torch.where(z < 0, (1 - torch.abs(y)) * sx, x)
    ye = torch.where(z < 0, (1 - torch.abs(x)) * sy, y)
    return torch.stack([xe, ye], -1)


def _atlas_lookup(atlas, probe_idx, d, res: int):
    uv = (_oct_encode(d) * 0.5 + 0.5) * (res - 1)
    iu = torch.clamp(uv[..., 0].to(torch.int64), 0, res - 1)
    iv = torch.clamp(uv[..., 1].to(torch.int64), 0, res - 1)
    return atlas[probe_idx, iu, iv]


def sample_irradiance(grid: LightProbeGrid, position, normal):
    """Irradiance at positions (..., 3) with normals (..., 3): the 8
    surrounding probes, trilinear weights times sqrt(facing) times the
    Chebyshev visibility from each probe's depth texels."""
    nx, ny, nz = grid.dims
    dev = position.device
    rel = (position - grid.origin) / grid.spacing
    hi = m.constant((nx - 2, ny - 2, nz - 2), torch.int64, dev)
    base = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int64),
                                     min=0), hi)
    frac = torch.clamp(rel - base, 0.0, 1.0)
    total = torch.zeros(position.shape[:-1] + (3,), device=dev)
    wsum = torch.zeros(position.shape[:-1], device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx3 = base + m.constant((dx, dy, dz), torch.int64, dev)
                pidx = (idx3[..., 0] * ny + idx3[..., 1]) * nz + idx3[..., 2]
                ppos = grid.origin + idx3.to(torch.float32) * grid.spacing
                to_probe = ppos - position
                dist = torch.linalg.norm(to_probe + 1e-9, dim=-1)
                pdir = to_probe / dist[..., None]
                tw = ((frac[..., 0] if dx else 1 - frac[..., 0])
                      * (frac[..., 1] if dy else 1 - frac[..., 1])
                      * (frac[..., 2] if dz else 1 - frac[..., 2]))
                facing = torch.sqrt(torch.clamp(
                    torch.sum(pdir * normal, -1), min=0.0))
                md = _atlas_lookup(grid.depth, pidx, -pdir, DEPTH_RES)
                mean, mean2 = md[..., 0], md[..., 1]
                var = torch.clamp(mean2 - mean * mean, min=1e-4)
                gap = torch.clamp(dist - mean, min=0.0)
                cheb = var / (var + gap * gap)
                vis = torch.where(dist > mean, torch.clamp(cheb, 0.05, 1.0),
                                  1.0)
                w = tw * facing * vis + 1e-6
                irr = _atlas_lookup(grid.irradiance, pidx, normal,
                                    IRRADIANCE_RES)
                total = total + irr * w[..., None]
                wsum = wsum + w
    return total / torch.clamp(wsum[..., None], min=1e-6)
