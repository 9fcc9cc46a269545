"""Point lights for the path tracer's next-event estimation, and the raster
frame's per-pixel BRDF (counterpart of ``d3d12renderer_tpu/render/lights.py``
`PointLights`, `make_point_lights` and `eval_brdf_pixel`; the tiled light
culling and the point / spot light shading are not ported yet)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import maths as m
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


def eval_brdf_pixel(n, v, l, albedo, roughness, metallic):
    """Cook-Torrance GGX specular + Lambert diffuse times n.l, on
    image-shaped inputs (..., 3) / (...)."""
    from .pathtracer import _fresnel_schlick, _ggx_d, _smith_g

    alpha = torch.clamp(roughness * roughness, min=1e-3)
    h = m.noz(v + l)
    n_dot_v = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    n_dot_l = torch.clamp(torch.sum(n * l, -1), min=0.0)
    n_dot_h = torch.clamp(torch.sum(n * h, -1), 0.0, 1.0)
    v_dot_h = torch.clamp(torch.sum(v * h, -1), min=1e-4)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    fr = _fresnel_schlick(v_dot_h, f0)
    d = _ggx_d(n_dot_h, alpha)
    g = _smith_g(n_dot_v, n_dot_l, alpha)
    spec = fr * (d * g / torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-8))[..., None]
    diff = albedo * (1.0 - metallic[..., None]) * (1.0 - fr) / math.pi
    return (diff + spec) * n_dot_l[..., None]
