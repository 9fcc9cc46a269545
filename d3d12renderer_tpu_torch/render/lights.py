"""Point lights for the path tracer's next-event estimation (counterpart of
``d3d12renderer_tpu/render/lights.py`` `PointLights` and
`make_point_lights`; the raster pipeline's tiled culling and deferred
shading of that module are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cuda_build import resolve_device


@dataclass
class PointLights:
    position: torch.Tensor   # (L, 3)
    color: torch.Tensor      # (L, 3) radiance * intensity
    radius: torch.Tensor     # (L,) falloff radius
    valid: torch.Tensor      # (L,) bool


def make_point_lights(positions, colors, radii, device="cuda") -> PointLights:
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return PointLights(position=f32(positions), color=f32(colors),
                       radius=f32(radii),
                       valid=torch.ones(len(positions), dtype=torch.bool,
                                        device=device))
