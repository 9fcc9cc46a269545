"""Decals: oriented boxes that project a material patch onto the G-buffer
before shading (counterpart of ``d3d12renderer_tpu/render/decals.py``).

Pixels whose world position lies inside a decal's box take its albedo,
roughness and metallic, blended by its strength and faded toward the ends
of its projection depth; one masked pass per decal.  `cull_decals_tiled`
gives per-tile decal lists through the light culling.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core import maths as m
from ..cuda_build import resolve_device

MAX_DECALS = 256  # the reference's decal buffers


@dataclass
class Decals:
    position: torch.Tensor      # (D, 3) box centre
    rotation: torch.Tensor      # (D, 4) box orientation (x, y, z, w)
    half_extents: torch.Tensor  # (D, 3) x, y across the face, z the projection depth
    albedo: torch.Tensor        # (D, 3)
    roughness: torch.Tensor     # (D,)
    metallic: torch.Tensor      # (D,)
    strength: torch.Tensor      # (D,) blend weight
    valid: torch.Tensor         # (D,) bool


def make_decals(positions, rotations, half_extents, albedos, roughness=None,
                metallic=None, strength=None, device="cuda") -> Decals:
    """Decals from host arrays; roughness 0.5, metallic 0 and strength 1
    where not given."""
    device = resolve_device(device)
    d = len(positions)

    def f32(x, default=None):
        x = [default] * d if x is None else x
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Decals(position=f32(positions), rotation=f32(rotations),
                  half_extents=f32(half_extents), albedo=f32(albedos),
                  roughness=f32(roughness, 0.5), metallic=f32(metallic, 0.0),
                  strength=f32(strength, 1.0),
                  valid=torch.ones(d, dtype=torch.bool, device=device))


def apply_decals(gb, decals: Decals):
    """The G-buffer with every decal blended into its albedo, roughness and
    metallic (a new GBuffer; the input is left as it was)."""
    albedo, rough, metal = gb.albedo, gb.roughness, gb.metallic
    for i in range(decals.position.shape[0]):
        local = m.quat_inv_rotate(decals.rotation[i],
                                  gb.world_pos - decals.position[i])
        he = decals.half_extents[i]
        inside = ((torch.abs(local[..., 0]) <= he[0])
                  & (torch.abs(local[..., 1]) <= he[1])
                  & (torch.abs(local[..., 2]) <= he[2])
                  & gb.hit & decals.valid[i])
        fade = torch.clamp(1.0 - torch.abs(local[..., 2]) / he[2], 0.0, 1.0)
        w = torch.where(inside, decals.strength[i] * fade, 0.0)
        albedo = albedo * (1 - w[..., None]) + decals.albedo[i] * w[..., None]
        rough = rough * (1 - w) + decals.roughness[i] * w
        metal = metal * (1 - w) + decals.metallic[i] * w
    return replace(gb, albedo=albedo, roughness=rough, metallic=metal)


def cull_decals_tiled(view_pos, decals: Decals, camera, width: int,
                      height: int):
    """Per-tile decal lists: each decal culled as a sphere of its box's
    half diagonal (`lights.cull_lights_tiled`)."""
    from .lights import PointLights, cull_lights_tiled

    as_lights = PointLights(position=decals.position, color=decals.albedo,
                            radius=torch.linalg.norm(decals.half_extents,
                                                     dim=-1),
                            valid=decals.valid)
    return cull_lights_tiled(view_pos, as_lights, camera, width, height)
