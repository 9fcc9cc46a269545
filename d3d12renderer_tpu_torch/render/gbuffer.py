"""The G-buffer: depth, positions, normals, material values and motion of
the primary hits (counterpart of ``d3d12renderer_tpu/render/gbuffer.py``).

Primary visibility comes from the tile rasterizer (`primary="raster"`,
`ops/raster.py`: one sub-pixel offset per frame) or from primary rays
against the BVH (`primary="ray"`: per-pixel jitter from a `Sampler`, or
pixel centres); the rest is the same math on either's `{t, tri, uv, hit}`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core import maths as m
from ..ops import raster
from . import bvh as bvh_mod
from .camera import Camera, generate_rays


@dataclass
class GBuffer:
    depth: torch.Tensor        # (H, W) linear view depth (+inf on sky)
    world_pos: torch.Tensor    # (H, W, 3)
    view_pos: torch.Tensor     # (H, W, 3) view space (-z forward)
    normal: torch.Tensor       # (H, W, 3) world, facing the camera
    view_normal: torch.Tensor  # (H, W, 3)
    albedo: torch.Tensor       # (H, W, 3)
    roughness: torch.Tensor    # (H, W)
    metallic: torch.Tensor     # (H, W)
    emissive: torch.Tensor     # (H, W, 3)
    object_id: torch.Tensor    # (H, W) int32 material id, -1 on sky
    motion: torch.Tensor       # (H, W, 2) pixel offset to the previous frame
    hit: torch.Tensor          # (H, W) bool
    # The raster primary's pairs dropped (always 0) and pair count (binning
    # "tri"), 0-d tensors; None for the ray primary.
    overflow: Optional[torch.Tensor] = None
    pairs: Optional[torch.Tensor] = None
    # Not fields (the JAX package's G-buffer has neither): the raster
    # primary's group-path visits and each tile's least q (the next
    # frame's occlusion feedback), set by `render_gbuffer`.
    visits = None
    tile_qmin = None


def world_to_view(camera: Camera, p):
    return m.quat_inv_rotate(camera.rotation, p - camera.position)


def view_to_pixel(camera: Camera, v, width: int, height: int):
    tan_half = math.tan(camera.v_fov * 0.5)
    z = torch.clamp(-v[..., 2], min=1e-6)
    u = v[..., 0] / (z * tan_half * camera.aspect)
    w_ = -v[..., 1] / (z * tan_half)
    return torch.stack([(u * 0.5 + 0.5) * width, (w_ * 0.5 + 0.5) * height], -1)


def render_gbuffer(scene, camera: Camera, width: int, height: int,
                   prev_camera: Optional[Camera] = None, jitter=None,
                   sampler=None, primary: str = "ray", binning: str = "tri",
                   tile_qmin=None) -> GBuffer:
    """primary="raster": the tile rasterizer sampled at pixel + `jitter`
    ((2,), default the pixel centres), with `binning` and `tile_qmin` (last
    frame's, the group path's occlusion feedback) as
    `raster.closest_hit_raster` takes them.  primary="ray": rays through
    pixel + a per-pixel (H, W, 2) draw of `sampler` (pixel centres without
    one).  Motion vectors against `prev_camera` (zero without one)."""
    if primary == "raster":
        res = raster.closest_hit_raster(scene.bvh, camera, width, height,
                                        jitter=jitter, binning=binning,
                                        tile_qmin=tile_qmin)
        o, d = generate_rays(camera, width, height,
                             offset=(0.5, 0.5) if jitter is None else jitter)
    elif primary == "ray":
        o, d = generate_rays(camera, width, height, sampler)
        res = bvh_mod.closest_hit(scene.bvh, o, d)
    else:
        raise ValueError(f"unknown primary visibility {primary!r}")
    n, gn, uv, mat, albedo, rough, metal, emissive = \
        bvh_mod.hit_attributes_shaded(scene.bvh, scene.materials, res,
                                      table=scene.attr_table)

    hit = res["hit"]
    wp = o + d * torch.where(hit, res["t"], 1e6)[:, None]
    flip = torch.sum(gn * d, -1) > 0
    gn = torch.where(flip[:, None], -gn, gn)
    n = torch.where((torch.sum(n * gn, -1) < 0)[:, None], -n, n)

    vp = world_to_view(camera, wp)
    vn = m.quat_inv_rotate(camera.rotation[None], n)
    if prev_camera is not None:
        motion = (view_to_pixel(prev_camera, world_to_view(prev_camera, wp),
                                width, height)
                  - view_to_pixel(camera, vp, width, height))
    else:
        motion = torch.zeros((height * width, 2), device=wp.device)

    def img(x, ch=None):
        return x.reshape((height, width) if ch is None else (height, width, ch))

    gb = GBuffer(
        depth=img(torch.where(hit, -vp[:, 2], torch.inf)),
        world_pos=img(wp, 3),
        view_pos=img(vp, 3),
        normal=img(n, 3),
        view_normal=img(vn, 3),
        albedo=img(torch.where(hit[:, None], albedo, 0.0), 3),
        roughness=img(torch.where(hit, rough, 1.0)),
        metallic=img(torch.where(hit, metal, 0.0)),
        emissive=img(torch.where(hit[:, None], emissive, 0.0), 3),
        object_id=img(torch.where(hit, mat, -1)),
        motion=img(motion, 2),
        hit=img(hit),
        overflow=res.get("overflow"),
        pairs=res.get("pairs"))
    gb.visits, gb.tile_qmin = res.get("visits"), res.get("tile_qmin")
    return gb
