"""The G-buffer: depth, positions, normals, material values and motion of
the primary hits of the tile rasterizer at one sub-pixel offset per frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core import maths as m
from . import raster
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


def world_to_view(camera: Camera, p):
    return m.quat_inv_rotate(camera.rotation, p - camera.position)


def view_to_pixel(camera: Camera, v, width: int, height: int):
    tan_half = math.tan(camera.v_fov * 0.5)
    z = torch.clamp(-v[..., 2], min=1e-6)
    u = v[..., 0] / (z * tan_half * camera.aspect)
    w_ = -v[..., 1] / (z * tan_half)
    return torch.stack([(u * 0.5 + 0.5) * width, (w_ * 0.5 + 0.5) * height], -1)


def hit_attributes_shaded(scene, res):
    """Shading normal, geometric normal, uv, material id, albedo,
    roughness, metallic and emissive at the hits (`scene.tri` holds each
    triangle's edges, vertex normals and uvs, `scene.mat` its material)."""
    tri = torch.clamp(res["tri"], min=0).long()
    t = scene.tri
    u = res["uv"][:, 0:1]
    v = res["uv"][:, 1:2]
    w = 1.0 - u - v
    n = w * t["n0"][tri] + u * t["n1"][tri] + v * t["n2"][tri]
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    uv = w * t["uv0"][tri] + u * t["uv1"][tri] + v * t["uv2"][tri]
    gn = m.cross(t["e1"][tri], t["e2"][tri])
    gn = gn / torch.clamp(torch.linalg.norm(gn, dim=-1, keepdim=True),
                          min=1e-9)
    mat = scene.mat[tri]
    return (n, gn, uv, mat.to(torch.int32), scene.albedo[mat],
            scene.roughness[mat], scene.metallic[mat], scene.emissive[mat])


def render_gbuffer(scene, camera: Camera, width: int, height: int,
                   prev_camera: Optional[Camera] = None,
                   jitter=None) -> GBuffer:
    """The tile rasterizer sampled at pixel + `jitter` ((2,), default the
    pixel centres); motion vectors against `prev_camera` (zero without
    one)."""
    res = raster.closest_hit_raster(scene, camera, width, height,
                                    jitter=jitter)
    o, d = generate_rays(camera, width, height,
                         offset=(0.5, 0.5) if jitter is None else jitter)
    n, gn, uv, mat, albedo, rough, metal, emissive = \
        hit_attributes_shaded(scene, res)
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
        hit=img(hit))
    return gb
