"""The demo HDR environment map (a copy of
``d3d12renderer_tpu/assets/envmap.py``, numpy only): an equirect radiance
field with a sun disc at real-sun intensity, a gradient sky, horizon haze
and ground bounce, written as a Radiance RGBE `.hdr` file that then flows
through the image cache, `render.ibl.equirect_to_cubemap` and the sky.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_SUN = (-0.45, 0.62, -0.64)


def make_demo_envmap(height: int = 128, sun_direction=DEFAULT_SUN,
                     sun_radiance: float = 1800.0) -> np.ndarray:
    """(H, 2H, 3) float32 linear radiance equirect environment.

    The sun disc carries ~0.5 deg angular radius at `sun_radiance`, so the
    image has a genuine ~4 orders-of-magnitude dynamic range — an 8-bit
    pipeline clips it, which is exactly what this asset exists to test."""
    h, w = height, 2 * height
    v = (np.arange(h) + 0.5) / h            # 0 (zenith) .. 1 (nadir)
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = (u - 0.5) * 2 * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([
        np.broadcast_to(st * np.cos(phi)[None, :], (h, w)),
        np.broadcast_to(np.cos(theta)[:, None], (h, w)),
        np.broadcast_to(st * np.sin(phi)[None, :], (h, w)),
    ], -1)

    sun = np.asarray(sun_direction, np.float64)
    sun = sun / np.linalg.norm(sun)
    cos_sun = np.clip((d * sun).sum(-1), -1, 1)

    y = d[..., 1]
    t = np.clip(y, 0, 1) ** 0.55
    zenith = np.array([0.18, 0.38, 0.92])
    horizon = np.array([0.92, 0.82, 0.70])
    ground = np.array([0.22, 0.18, 0.15])
    sky = horizon[None, None] * (1 - t[..., None]) + zenith[None, None] * t[..., None]
    # Horizon haze brightening and ground below.
    haze = np.exp(-np.abs(y) * 9.0)[..., None] * np.array([0.9, 0.85, 0.8])
    col = np.where(y[..., None] >= 0, sky + haze,
                   ground[None, None] * (1 + 1.5 * np.exp(4.0 * y))[..., None])
    # Circumsolar glow + the sun disc itself (~0.5 deg angular radius).
    glow = np.exp((cos_sun - 1.0) * 80.0)[..., None] * np.array([8.0, 6.5, 4.5])
    disc = (cos_sun > np.cos(np.radians(0.53)))[..., None] * np.array(
        [1.0, 0.93, 0.82]) * sun_radiance
    return (col + glow + disc).astype(np.float32)


def ensure_demo_envmap(path: str, height: int = 128) -> str:
    """Write the demo envmap to `path` if missing; returns `path`."""
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        from .image_io import save_hdr
        save_hdr(path, make_demo_envmap(height))
    return path
