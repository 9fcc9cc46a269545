"""Render camera and primary-ray generation (counterpart of
the JAX package's ``render/camera.py``: `Camera`, `look_at`, the Halton
jitter sequence, `generate_rays` with per-pixel jitter, one per-frame
offset, or thin-lens rays)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core import maths as m
from ..device import resolve_device


@dataclass
class Camera:
    position: torch.Tensor    # (3,)
    rotation: torch.Tensor    # (4,) quaternion (x, y, z, w); looks down -Z
    v_fov: float = math.radians(60.0)
    aspect: float = 16.0 / 9.0
    near: float = 0.1
    far: float = 1000.0


def look_at(eye, target, up=(0.0, 1.0, 0.0), device="cuda", **kw) -> Camera:
    """A camera at `eye` looking at `target`; the basis and quaternion in
    float64, then cast to float32 (as the JAX package does)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    mat = np.stack([r, u, -f], axis=1)       # x = right, y = up, z = -forward
    t = np.trace(mat)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        q = np.array([(mat[2, 1] - mat[1, 2]) / s, (mat[0, 2] - mat[2, 0]) / s,
                      (mat[1, 0] - mat[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diag(mat)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(mat[i, i] - mat[j, j] - mat[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (mat[j, i] + mat[i, j]) / s
        q[k] = (mat[k, i] + mat[i, k]) / s
        q[3] = (mat[k, j] - mat[j, k]) / s
    q /= np.linalg.norm(q)
    device = resolve_device(device)
    return Camera(position=torch.as_tensor(eye, dtype=torch.float32,
                                           device=device),
                  rotation=torch.as_tensor(q, dtype=torch.float32,
                                           device=device), **kw)


def generate_rays(camera: Camera, width: int, height: int, sampler=None,
                  f_number: float = 0.0, focal_length: float = 1.0,
                  offset=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays, origin and direction (H*W, 3), on the camera's device.

    With a `sampler` (render/pathtracer.py `Sampler`), sub-pixel positions
    are jittered per pixel by an (H, W, 2) uniform draw and, if
    f_number > 0, origins sample a thin-lens aperture (two (H*W,) uniform
    draws: radius, angle).  `offset` (2,) instead puts ONE sub-pixel offset
    on every pixel: the per-frame jitter of the rasterized primary path.
    With neither, rays go through pixel centres."""
    dev = camera.position.device
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    if offset is not None:
        off = torch.as_tensor(offset, dtype=torch.float32, device=dev)
        off = off.reshape(1, 1, 2).expand(height, width, 2)
    elif sampler is not None:
        off = sampler.uniform((height, width, 2))
    else:
        off = torch.full((height, width, 2), 0.5, device=dev)
    ndc_x = (gx + off[..., 0]) / width * 2.0 - 1.0
    ndc_y = 1.0 - (gy + off[..., 1]) / height * 2.0
    tan_half = math.tan(camera.v_fov * 0.5)
    dir_cam = torch.stack([ndc_x * tan_half * camera.aspect, ndc_y * tan_half,
                           -torch.ones_like(ndc_x)], dim=-1).reshape(-1, 3)
    d = m.quat_rotate(camera.rotation[None, :], dir_cam)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = camera.position.expand(d.shape)

    if sampler is not None and f_number > 0.0:
        # Thin lens: origins on the aperture disc, refocused through the
        # focal plane.
        aperture = focal_length / f_number * 0.5
        r = torch.sqrt(sampler.uniform((d.shape[0],))) * aperture
        theta = sampler.uniform((d.shape[0],)) * 2 * math.pi
        right = m.quat_rotate(camera.rotation[None, :],
                              torch.tensor([[1.0, 0.0, 0.0]], device=dev))
        up = m.quat_rotate(camera.rotation[None, :],
                           torch.tensor([[0.0, 1.0, 0.0]], device=dev))
        offset = (right * (r * torch.cos(theta))[:, None]
                  + up * (r * torch.sin(theta))[:, None])
        focus = o + d * focal_length
        o = o + offset
        d = focus - o
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return o, d
