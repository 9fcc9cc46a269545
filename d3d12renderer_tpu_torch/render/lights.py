"""Punctual lights, tiled light culling and the raster frame's per-pixel
shading (counterpart of ``d3d12renderer_tpu/render/lights.py``).

Point and spot lights; `cull_lights_tiled`, the Forward+ pass: 16x16-pixel
tiles bound their view-space positions (sky pixels left out), a light
passes a tile where its sphere meets the tile's box, and each tile keeps
the first MAX_LIGHTS_PER_TILE passing lights in index order, -1 padded.
`shade_point_lights` gathers each pixel's tile list; the shadowed point
lights and the spot lights shade per light (few of them, each with an
optional shadow map).  Plain tensor ops, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import maths as m
from ..cuda_build import resolve_device

TILE_SIZE = 16                 # the reference's 16x16 culling tiles
MAX_LIGHTS_PER_TILE = 16


@dataclass
class PointLights:
    position: torch.Tensor   # (L, 3)
    color: torch.Tensor      # (L, 3) radiance * intensity
    radius: torch.Tensor     # (L,) falloff radius
    valid: torch.Tensor      # (L,) bool


@dataclass
class SpotLights:
    position: torch.Tensor   # (L, 3)
    direction: torch.Tensor  # (L, 3) unit, the light's direction of travel
    color: torch.Tensor      # (L, 3)
    distance: torch.Tensor   # (L,) falloff distance
    inner_cos: torch.Tensor  # (L,)
    outer_cos: torch.Tensor  # (L,)
    valid: torch.Tensor      # (L,) bool


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_point_lights(positions, colors, radii, device="cuda") -> PointLights:
    device = resolve_device(device)
    return PointLights(position=_f32(positions, device),
                       color=_f32(colors, device), radius=_f32(radii, device),
                       valid=torch.ones(len(positions), dtype=torch.bool,
                                        device=device))


def make_spot_lights(positions, directions, colors, distances, inner_cos,
                     outer_cos, device="cuda") -> SpotLights:
    """Spot lights from host arrays; the directions are normalised (in
    float64, as examples/showcase.py does it)."""
    device = resolve_device(device)
    d = np.asarray(directions, np.float64)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return SpotLights(position=_f32(positions, device),
                      direction=_f32(d, device), color=_f32(colors, device),
                      distance=_f32(distances, device),
                      inner_cos=_f32(inner_cos, device),
                      outer_cos=_f32(outer_cos, device),
                      valid=torch.ones(len(positions), dtype=torch.bool,
                                       device=device))


def cull_lights_tiled(view_pos, lights: PointLights, camera, width: int,
                      height: int):
    """Per-tile light lists (JAX `cull_lights_tiled`): ((tiles_y, tiles_x,
    k) int32 indices, -1 padded, k = min(MAX_LIGHTS_PER_TILE, L); and the
    (tiles_y, tiles_x) count of passing lights, which may exceed k)."""
    h, w, _ = view_pos.shape
    ty, tx = -(-h // TILE_SIZE), -(-w // TILE_SIZE)
    dev = view_pos.device
    rows = torch.clamp(torch.arange(ty * TILE_SIZE, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(tx * TILE_SIZE, device=dev), max=w - 1)
    vp = view_pos[rows][:, cols]                       # edge-padded
    tiles = vp.reshape(ty, TILE_SIZE, tx, TILE_SIZE, 3).permute(0, 2, 1, 3, 4)
    tiles = tiles.reshape(ty, tx, -1, 3)
    zvalid = tiles[..., 2] > -1e5                      # sky pixels out
    t_min = torch.where(zvalid[..., None], tiles, torch.inf).amin(2)
    t_max = torch.where(zvalid[..., None], tiles, -torch.inf).amax(2)
    any_valid = zvalid.any(2)

    lp = m.quat_inv_rotate(camera.rotation[None],
                           lights.position - camera.position)
    c = torch.minimum(torch.maximum(lp[None, None], t_min[:, :, None]),
                      t_max[:, :, None])
    dist = torch.linalg.norm(c - lp[None, None] + 1e-9, dim=-1)
    inside = ((dist < lights.radius[None, None]) & lights.valid[None, None]
              & any_valid[..., None])
    k = min(MAX_LIGHTS_PER_TILE, lights.position.shape[0])
    order = torch.argsort((~inside).to(torch.uint8), dim=-1, stable=True)
    order = order[..., :k].to(torch.int32)
    count = inside.sum(-1, dtype=torch.int32)
    slot_ok = torch.arange(k, device=dev) < count[..., None]
    return torch.where(slot_ok, order, -1), count


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


def _falloff(dist, radius):
    """clip(1 - (dist / radius)^4, 0, 1)^2 / (dist^2 + 0.01), the powers
    as products (JAX's integer powers)."""
    x = dist / radius
    x2 = x * x
    f = torch.clamp(1.0 - x2 * x2, 0.0, 1.0)
    return f * f / (dist * dist + 1e-2)


def _to_light(gb, position):
    to_l = position - gb.world_pos
    dist = torch.linalg.norm(to_l + 1e-9, dim=-1)
    return to_l / dist[..., None], dist


def shade_point_lights(gb, lights: PointLights, tile_lists, camera):
    """The culled point lights' sum at every pixel: one pass per list slot,
    each pixel reading its tile's light in that slot."""
    h, w = gb.depth.shape
    dev = gb.depth.device
    py = torch.arange(h, device=dev) // TILE_SIZE
    px = torch.arange(w, device=dev) // TILE_SIZE
    pixel_lists = tile_lists[py[:, None], px[None, :]]         # (H, W, K)
    v = m.noz(camera.position - gb.world_pos)
    total = torch.zeros((h, w, 3), device=dev)
    for k in range(tile_lists.shape[-1]):
        li = pixel_lists[..., k]
        ok = li >= 0
        li = torch.clamp(li, min=0).long()
        ldir, dist = _to_light(gb, lights.position[li])
        att = _falloff(dist, lights.radius[li])
        f = eval_brdf_pixel(gb.normal, v, ldir, gb.albedo, gb.roughness,
                            gb.metallic)
        total = total + torch.where((ok & gb.hit)[..., None],
                                    f * lights.color[li] * att[..., None], 0.0)
    return total


def _shade_each(gb, lights, camera, reach, shadow_maps, sample, cone=None):
    """Every light of `lights` at every pixel, one pass per light: the
    BRDF times the colour and the falloff over `reach` (L,), times
    `cone(i, ldir)` when given, times `sample(map, world_pos)` where
    `shadow_maps` holds a map for the light; lights not valid add 0."""
    h, w = gb.depth.shape
    v = m.noz(camera.position - gb.world_pos)
    total = torch.zeros((h, w, 3), device=gb.depth.device)
    for i in range(lights.position.shape[0]):
        ldir, dist = _to_light(gb, lights.position[i])
        att = _falloff(dist, reach[i])
        if cone is not None:
            att = att * cone(i, ldir)
        f = eval_brdf_pixel(gb.normal, v, ldir, gb.albedo, gb.roughness,
                            gb.metallic)
        contrib = f * lights.color[i] * att[..., None]
        if shadow_maps is not None and shadow_maps[i] is not None:
            contrib = contrib * sample(shadow_maps[i],
                                       gb.world_pos)[..., None]
        total = total + torch.where(gb.hit[..., None], contrib, 0.0) \
            * lights.valid[i]
    return total


def shade_spot_lights(gb, lights: SpotLights, camera, shadow_maps=None):
    """Every spot light at every pixel (no culling: a handful in the
    reference's scenes), each with its cone; `shadow_maps` a sequence with
    one `SpotShadowMap` or None per light."""
    from .shadows import sample_spot_shadow

    def cone(i, ldir):
        c = torch.sum(-ldir * lights.direction[i], -1)
        return torch.clamp(
            (c - lights.outer_cos[i])
            / torch.clamp(lights.inner_cos[i] - lights.outer_cos[i], min=1e-4),
            0.0, 1.0)

    return _shade_each(gb, lights, camera, lights.distance, shadow_maps,
                       sample_spot_shadow, cone)


def shade_point_lights_shadowed(gb, lights: PointLights, camera, shadow_maps):
    """Per-light point shading, each light's contribution times its
    dual-paraboloid shadow factor (`shadow_maps`: one `PointShadowMap` or
    None per light).  The tiled path stays shadow-free, as in JAX."""
    from .shadows import sample_point_shadow

    return _shade_each(gb, lights, camera, lights.radius, shadow_maps,
                       sample_point_shadow)
