"""The sun's shadow cascades: orthographic depth maps from the light,
sampled with 3x3 PCF."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass
class SunShadowMaps:
    depth: torch.Tensor       # (C, R, R) distance along the light direction
    origin: torch.Tensor      # (C, 3) corner plane centre of each volume
    right: torch.Tensor       # (C, 3)
    up: torch.Tensor          # (C, 3)
    direction: torch.Tensor   # (3,) the light's direction of travel
    extent: torch.Tensor      # (C,) half-size of the ortho volume
    z_range: torch.Tensor     # (C,) depth range


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
