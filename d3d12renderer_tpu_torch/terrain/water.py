"""The water surface's animated normal and depth colour (counterpart of
``d3d12renderer_tpu/terrain/water.py``): two scrolling directional waves
and a third across them perturb the plane's normal; the colour blends
from shallow to deep over TRANSITION_DEPTH."""

from __future__ import annotations

import torch

from ..core import maths as m

# The reference's water component defaults.
DEEP_COLOR = (0.09, 0.27, 0.32)
SHALLOW_COLOR = (0.3, 0.73, 0.63)
TRANSITION_DEPTH = 2.5


def water_normal(x, z, time, wave_scale: float = 0.35,
                 wave_strength: float = 0.06):
    """Unit normals (..., 3) at surface points (x, z) and `time`."""
    p1 = x * wave_scale + time * 0.6
    p2 = z * wave_scale * 1.31 - time * 0.43
    p3 = (x + z) * wave_scale * 0.7 + time * 0.9
    dx = wave_strength * (torch.cos(p1) + 0.5 * torch.cos(p3))
    dz = wave_strength * (torch.cos(p2) + 0.5 * torch.cos(p3))
    n = torch.stack([-dx, torch.ones_like(dx), -dz], -1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def water_color(depth_below):
    """(..., 3): shallow at depth 0 to deep at TRANSITION_DEPTH."""
    t = torch.clamp(depth_below / TRANSITION_DEPTH, 0.0, 1.0)[..., None]
    dev = depth_below.device
    return (m.constant(SHALLOW_COLOR, torch.float32, dev) * (1 - t)
            + m.constant(DEEP_COLOR, torch.float32, dev) * t)
