"""Cascaded sun shadow maps (counterpart of the sun part of
``d3d12renderer_tpu/render/shadows.py``: `SunShadowMaps`, `fit_cascades`,
`render_sun_shadow_maps`, `sample_sun_shadow`).

A cascade is a depth image along the sun's direction from an orthographic
view centred on the camera; all cascades are cast as one closest-hit query
over the BVH (the BVH ray kernel on the card) and sampled with 3x3 PCF.
Spot and point-light shadows and the shadow cache are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from ..core import maths as m
from . import bvh as bvh_mod

DEFAULT_CASCADES = 3


@dataclass
class SunShadowMaps:
    depth: torch.Tensor       # (C, R, R) distance along the light direction
    origin: torch.Tensor      # (C, 3) corner plane centre of each volume
    right: torch.Tensor       # (C, 3)
    up: torch.Tensor          # (C, 3)
    direction: torch.Tensor   # (3,) the light's direction of travel
    extent: torch.Tensor      # (C,) half-size of the ortho volume
    z_range: torch.Tensor     # (C,) depth range


def fit_cascades(camera_pos, sun_direction, num_cascades=DEFAULT_CASCADES,
                 base_extent=8.0, z_range=60.0) -> SunShadowMaps:
    """Cascade volumes centred on the camera with doubling extents, snapped
    to their 512-texel grid for stability; `sun_direction` is the light's
    direction of travel."""
    dev = camera_pos.device
    d = m.noz(torch.as_tensor(sun_direction, dtype=torch.float32, device=dev))
    t1, t2 = m.orthonormal_basis(d)
    extents = base_extent * (2.0 ** torch.arange(num_cascades,
                                                 dtype=torch.float32,
                                                 device=dev))
    origins = []
    for c in range(num_cascades):
        texel = 2.0 * float(base_extent * 2 ** c) / 512.0
        proj_r = torch.dot(camera_pos, t1)
        proj_u = torch.dot(camera_pos, t2)
        snapped = (torch.floor(proj_r / texel) * texel * t1
                   + torch.floor(proj_u / texel) * texel * t2
                   + torch.dot(camera_pos, d) * d)
        origins.append(snapped - d * (z_range * 0.5))
    return SunShadowMaps(
        depth=torch.zeros((num_cascades, 1, 1), device=dev),
        origin=torch.stack(origins), right=t1.expand(num_cascades, 3),
        up=t2.expand(num_cascades, 3), direction=d, extent=extents,
        z_range=torch.full((num_cascades,), z_range, device=dev))


def render_sun_shadow_maps(scene_bvh, maps: SunShadowMaps,
                           resolution: int = 512) -> SunShadowMaps:
    """Depth from the light for every cascade: C R^2 rays in one
    closest-hit query (+inf where a ray escapes)."""
    c = maps.origin.shape[0]
    dev = maps.origin.device
    u = (torch.arange(resolution, device=dev) + 0.5) / resolution * 2 - 1
    gu, gv = torch.meshgrid(u, u, indexing="xy")
    span = gu[None, :, :, None] * maps.extent[:, None, None, None]
    spanv = gv[None, :, :, None] * maps.extent[:, None, None, None]
    o = (maps.origin[:, None, None, :] + maps.right[:, None, None, :] * span
         + maps.up[:, None, None, :] * spanv).reshape(-1, 3)
    d = maps.direction.expand(o.shape)
    res = bvh_mod.closest_hit(scene_bvh, o, d)
    z = torch.where(res["hit"], res["t"], torch.inf)
    return replace(maps, depth=z.reshape(c, resolution, resolution))


def sample_sun_shadow(maps: SunShadowMaps, world_pos, pcf: bool = True,
                      bias: float = 0.05):
    """Shadow factor at world positions (..., 3), 1 lit and 0 shadowed, from
    the finest cascade containing the point (3x3 PCF, edge-clamped taps),
    and that cascade's index (-1 outside every cascade)."""
    c, r, _ = maps.depth.shape
    shp = world_pos.shape[:-1]
    flat = world_pos.reshape(-1, 3)
    rel = flat[None, :, :] - maps.origin[:, None, :]                # (C, N, 3)
    u = torch.sum(rel * maps.right[:, None, :], -1) / maps.extent[:, None]
    v = torch.sum(rel * maps.up[:, None, :], -1) / maps.extent[:, None]
    z = torch.sum(rel * maps.direction[None, None, :], -1)
    inside = ((torch.abs(u) < 1) & (torch.abs(v) < 1) & (z > 0)
              & (z < maps.z_range[:, None]))
    first = inside & (torch.cumsum(inside.to(torch.int32), 0) == 1)  # (C, N)
    any_in = inside.any(0)
    sel = first.to(torch.float32)
    u_s = torch.sum(u * sel, 0)
    v_s = torch.sum(v * sel, 0)
    z_s = torch.sum(z * sel, 0)
    ci = torch.sum(torch.arange(c, device=flat.device)[:, None] * first, 0)
    ix = torch.clamp((u_s * 0.5 + 0.5) * (r - 1), 0, r - 1).to(torch.int64)
    iy = torch.clamp((v_s * 0.5 + 0.5) * (r - 1), 0, r - 1).to(torch.int64)
    if pcf:
        padded = F.pad(maps.depth[None], (1, 1, 1, 1), mode="replicate")[0]
        taps = torch.stack([padded[ci, iy + dy, ix + dx]
                            for dy in range(3) for dx in range(3)], -1)
        vis = torch.mean((z_s[:, None] <= taps + bias).to(torch.float32), -1)
    else:
        vis = (z_s <= maps.depth[ci, iy, ix] + bias).to(torch.float32)
    lit = torch.where(any_in, vis, 1.0).reshape(shp)
    chosen = torch.where(any_in, ci, -1).reshape(shp).to(torch.int32)
    return lit, chosen
