"""The water plane composited over the lit frame (counterpart of
``d3d12renderer_tpu/render/water_pass.py``): where a camera ray meets the
plane before the opaque surface, the pixel becomes a refracted (offset)
sample of the frame absorbed and tinted by the water's depth below the
surface, blended by Fresnel with the sky reflected off the wave normal."""

from __future__ import annotations

import torch

from ..core import maths as m
from ..terrain.water import water_color, water_normal
from .pathtracer import Sky, sky_radiance


def water_pass(color, gb, camera, sky: Sky, water_height: float = 0.0,
               time: float = 0.0, refraction_strength: float = 12.0):
    """`color` (H, W, 3) with the plane y = `water_height` composited;
    `gb` the frame's G-buffer."""
    h, w, _ = color.shape
    dev = color.device
    o = camera.position
    d = m.noz(gb.world_pos - o)
    denom = d[..., 1]
    t_w = (water_height - o[1]) / torch.where(torch.abs(denom) < 1e-6,
                                              -1e-6, denom)
    t_opaque = torch.where(gb.hit, torch.linalg.norm(gb.world_pos - o, dim=-1),
                           torch.inf)
    covered = (t_w > 0) & (t_w < t_opaque) & (o[1] > water_height)

    p = o + d * t_w[..., None]
    n = water_normal(p[..., 0], p[..., 2], time)
    # Refraction: the frame sampled at an offset of the normal's xz wobble.
    px = torch.clamp(torch.arange(w, device=dev)[None, :] + torch.round(
        n[..., 0] * refraction_strength).long(), 0, w - 1)
    py = torch.clamp(torch.arange(h, device=dev)[:, None] + torch.round(
        n[..., 2] * refraction_strength).long(), 0, h - 1)
    refracted = color[py, px]

    below = torch.where(torch.isfinite(t_opaque), t_opaque - t_w, 1e3)
    depth_below = below * torch.clamp(-d[..., 1], min=0.05)
    absorb = torch.exp(-depth_below[..., None] * 0.8)
    body = refracted * absorb + water_color(depth_below) * (1 - absorb)

    refl_dir = d - 2 * torch.sum(d * n, -1, keepdim=True) * n
    refl = sky_radiance(sky, refl_dir.reshape(-1, 3)).reshape(h, w, 3)
    x = 1.0 - torch.clamp(torch.sum(-d * n, -1), 0.0, 1.0)
    x2 = x * x
    fresnel = (0.02 + 0.98 * (x * (x2 * x2)))[..., None]
    surface = body * (1 - fresnel) + refl * fresnel
    return torch.where(covered[..., None], surface, color)
