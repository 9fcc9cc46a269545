"""The raster frame's post-processing: HBAO, screen-space shadows, SSR,
TAA, bloom, tonemap, sharpen, and their helpers, plain PyTorch on
(H, W[, C]) tensors.  Settings defaults are the reference engine's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.maths import roll2
from . import image

# --------------------------------------------------------------------------
# Settings (reference: render_algorithms.h:23-118)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class HBAOSettings:
    radius: float = 0.5
    num_rays: int = 4
    max_steps_per_ray: int = 10
    strength: float = 1.0


@dataclass(frozen=True)
class SSSSettings:
    num_steps: int = 16
    ray_distance: float = 0.5
    thickness: float = 0.05
    max_distance_from_camera: float = 15.0
    distance_fadeout_range: float = 2.0
    border_fadeout: float = 0.1


@dataclass(frozen=True)
class SSRSettings:
    num_steps: int = 64
    max_distance: float = 100.0
    strength: float = 1.0
    # Surface thickness behind each depth sample for a hit.
    thickness: float = 1.0
    # Mip levels of the linear-depth min-pyramid the march may ascend to.
    max_mip: int = 6


@dataclass(frozen=True)
class TAASettings:
    camera_jitter_strength: float = 1.0
    blend: float = 0.9


@dataclass(frozen=True)
class BloomSettings:
    threshold: float = 100.0
    strength: float = 0.05
    levels: int = 5


@dataclass(frozen=True)
class SharpenSettings:
    strength: float = 0.5


@dataclass(frozen=True)
class TonemapSettings:
    """Uncharted-2 filmic operator (reference: render_algorithms.h:97-118)."""

    A: float = 0.22
    B: float = 0.3
    C: float = 0.1
    D: float = 0.2
    E: float = 0.01
    F: float = 0.3
    linear_white: float = 11.2
    exposure: float = 0.2


# --------------------------------------------------------------------------
# Blur and resampling
# --------------------------------------------------------------------------

gaussian_kernel = image.gaussian_kernel


def gaussian_blur(img, sigma: float = 2.0):
    """Separable edge-clamped gaussian of (H, W) or (H, W, C)."""
    return image.gaussian_blur(img, gaussian_kernel(sigma))


def downsample2(img):
    """2x box downsample (odd edges dropped)."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    x = img[:h, :w]
    return x.reshape((h // 2, 2, w // 2, 2) + x.shape[2:]).mean(dim=(1, 3))


def upsample2(img, target_hw):
    """Bilinear resize to `target_hw` with half-pixel centres and clamped
    edges (`jax.image.resize(..., "bilinear")` when enlarging)."""
    x = img if img.dim() == 3 else img[..., None]
    x = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(target_hw),
                      mode="bilinear", align_corners=False, antialias=False)
    x = x[0].permute(1, 2, 0)
    return x if img.dim() == 3 else x[..., 0]


def bilateral_upsample(low, depth_low, depth_full, sigma_z=0.5):
    """Depth-aware 2x upsample of a half-res effect buffer: each full-res
    pixel blends its 4 bilinear low-res taps re-weighted by depth
    similarity.  low (h2, w2[, C]); depth_low (h2, w2); depth_full (H, W)."""
    h, w = depth_full.shape
    h2, w2 = depth_low.shape
    dev = depth_full.device
    fy = (torch.arange(h, device=dev) + 0.5) / 2.0 - 0.5
    fx = (torch.arange(w, device=dev) + 0.5) / 2.0 - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, h2 - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, w2 - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[None, :]

    # Full-res row i reads low rows (i-1)//2 and (i+1)//2, clamped: edge-
    # clamped shifts of a 2x row repeat (so at the border the zero-weight
    # tap reads row 0), the same along columns.
    def tap(img, oy, ox):
        a = torch.repeat_interleave(img, 2, dim=0)[:h]
        a = (torch.cat([a[:1], a[:-1]], 0) if oy == 0
             else torch.cat([a[1:], a[-1:]], 0))
        a = torch.repeat_interleave(a, 2, dim=1)[:, :w]
        return (torch.cat([a[:, :1], a[:, :-1]], 1) if ox == 0
                else torch.cat([a[:, 1:], a[:, -1:]], 1))

    vec = low.dim() == 3
    num = torch.zeros((h, w) + ((low.shape[-1],) if vec else ()), device=dev)
    den = torch.zeros((h, w), device=dev)
    for oy, ox, wb in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        d = tap(depth_low, oy, ox)
        wz = torch.exp(-torch.abs(depth_full - d) / sigma_z)
        wt = wb * wz + 1e-6
        v = tap(low, oy, ox)
        num = num + (wt[..., None] * v if vec else wt * v)
        den = den + wt
    return num / (den[..., None] if vec else den)


def _pixel_offset(motion):
    """round(motion) as int32, converted as XLA and CUDA convert it:
    saturating, NaN to 0.  (PyTorch's CPU conversion gives INT32_MIN for
    every value out of range.)  A sky pixel's motion is ~1e13 pixels: JAX
    saturates it and its int32 index sum wraps, and the port keeps that
    arithmetic, so the history pixel it takes is JAX's."""
    m = torch.nan_to_num(torch.round(motion), nan=0.0).double()
    return torch.clamp(m, -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _reproject(history, motion):
    """history sampled at each pixel + round(motion), clamped to the image
    (round half to even, as jnp.round; the sum in int32, as JAX's)."""
    h, w = history.shape[:2]
    dev = history.device
    i32 = torch.int32
    yy = torch.clamp(torch.arange(h, dtype=i32, device=dev)[:, None]
                     + _pixel_offset(motion[..., 1]), 0, h - 1)
    xx = torch.clamp(torch.arange(w, dtype=i32, device=dev)[None, :]
                     + _pixel_offset(motion[..., 0]), 0, w - 1)
    return history[yy.long(), xx.long()]


def _neighbourhood_clamp(hist, current):
    nmin, nmax = current, current
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            r = roll2(current, dy, dx)
            nmin = torch.minimum(nmin, r)
            nmax = torch.maximum(nmax, r)
    return torch.clamp(hist, nmin, nmax)


def temporal_accumulate(current, history, motion, blend=0.85, first=None):
    """Exponential history accumulation with motion reprojection and a 3x3
    neighbourhood clamp (the half-res AO / SSR chains).  `first` (a 0-d
    bool tensor) keeps the current frame."""
    hist = _neighbourhood_clamp(_reproject(history, motion), current)
    out = current * (1 - blend) + hist * blend
    if first is not None:
        out = torch.where(first, current, out)
    return out


# --------------------------------------------------------------------------
# HBAO (reference: hbao_cs.hlsl)
# --------------------------------------------------------------------------

def hbao(view_pos, normal, settings: HBAOSettings = HBAOSettings()):
    """view_pos, normal (H, W, 3) in view space -> (H, W) ambient occlusion
    (1 = unoccluded), de-banded by a sigma-1.5 blur."""
    h, w, _ = view_pos.shape
    dev = view_pos.device
    occlusion = torch.zeros((h, w), device=dev)
    for r in range(settings.num_rays):
        ang = 0.35 + 2 * math.pi * r / settings.num_rays
        dxy = (math.cos(ang), math.sin(ang))
        max_horizon = torch.full((h, w), -1.0, device=dev)
        for s in range(1, settings.max_steps_per_ray + 1):
            dy = int(round(dxy[1] * s * 2))
            dx = int(round(dxy[0] * s * 2))
            delta = roll2(view_pos, -dy, -dx) - view_pos
            dist = torch.linalg.norm(delta + 1e-9, dim=-1)
            sin_h = torch.sum(delta * normal, -1) / torch.clamp(dist, min=1e-6)
            max_horizon = torch.maximum(
                max_horizon, torch.where(dist < settings.radius, sin_h, -1.0))
        occlusion = occlusion + torch.clamp(max_horizon, 0.0, 1.0)
    ao = 1.0 - settings.strength * occlusion / settings.num_rays
    return torch.clamp(gaussian_blur(ao[..., None].contiguous(), 1.5)[..., 0],
                       0.0, 1.0)


# --------------------------------------------------------------------------
# SSR (reference: ssr_raycast_cs.hlsl, hierarchical-Z march)
# --------------------------------------------------------------------------

def build_min_depth_pyramid(depth, max_mip: int = 6):
    """Linear-depth MIN pyramid, all levels in one flat vector.  Odd sizes
    are edge-replicated to even before each 2x2 min.  Returns (flat,
    offsets, widths, heights) with up to `max_mip + 1` levels."""
    levels = [depth]
    for _ in range(max_mip):
        d = levels[-1]
        h, w = d.shape
        if h < 2 or w < 2:
            break
        if h % 2:
            d = torch.cat([d, d[-1:]], 0)
            h += 1
        if w % 2:
            d = torch.cat([d, d[:, -1:]], 1)
            w += 1
        levels.append(d.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3)))
    dev = depth.device
    heights = [l.shape[0] for l in levels]
    widths = [l.shape[1] for l in levels]
    offsets = [0]
    for hh, ww in zip(heights[:-1], widths[:-1]):
        offsets.append(offsets[-1] + hh * ww)

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    flat = torch.cat([l.reshape(-1) for l in levels])
    return flat, ints(offsets), ints(widths), ints(heights)


def ssr(color, view_pos, normal, roughness,
        settings: SSRSettings = SSRSettings(), tan_half: float = 1.0,
        aspect: float = 1.0):
    """Screen-space reflections: a hierarchical-Z march of the linear-depth
    min-pyramid, projected with the camera's frustum (tan_half =
    tan(v_fov / 2)).  Returns (H, W, 3) reflected colour and (H, W) hit
    confidence."""
    h, w, _ = view_pos.shape
    dev = view_pos.device
    view_dir = view_pos / torch.clamp(
        torch.linalg.norm(view_pos, dim=-1, keepdim=True), min=1e-6)
    refl = view_dir - 2 * torch.sum(view_dir * normal, -1,
                                    keepdim=True) * normal

    depth = torch.clamp(-view_pos[..., 2], min=1e-4)
    flat, offs, ws, hs = build_min_depth_pyramid(depth, settings.max_mip)
    n_mips = int(offs.shape[0])

    def project(p):
        z = torch.clamp(-p[..., 2], min=1e-4)
        u = (p[..., 0] / (z * tan_half * aspect)) * 0.5 + 0.5
        v = 0.5 - (p[..., 1] / (z * tan_half)) * 0.5
        return u * w, v * h, z

    # Ray end: clipped to stay in front of the near plane.
    z0 = depth
    rz = -refl[..., 2]
    t_near = torch.where(rz < -1e-6, (0.05 - z0) / rz, settings.max_distance)
    ray_len = torch.clamp(t_near, 1e-3, settings.max_distance)
    p_end = view_pos + refl * ray_len[..., None]

    x0, y0, _ = project(view_pos)
    x1, y1, z1 = project(p_end)
    k0, k1 = 1.0 / z0, 1.0 / z1
    dx, dy, dk = x1 - x0, y1 - y0, k1 - k0

    def axis_exit(p0, dp, lim):
        return torch.where(dp > 1e-6, (lim - 1e-3 - p0) / dp,
                           torch.where(dp < -1e-6, (1e-3 - p0) / dp, torch.inf))

    t_max = torch.clamp(torch.minimum(
        torch.minimum(axis_exit(x0, dx, float(w)), axis_exit(y0, dy, float(h))),
        torch.ones((), device=dev)), min=0.0)
    sx = torch.where(dx >= 0, 1.0, -1.0)
    sy = torch.where(dy >= 0, 1.0, -1.0)

    def cell_exit_t(t, mip):
        size = (1 << mip).to(torch.float32)
        x = x0 + t * dx
        y = y0 + t * dy
        bx = (torch.floor(x / size) + (sx > 0)) * size + sx * 0.01
        by = (torch.floor(y / size) + (sy > 0)) * size + sy * 0.01
        tx = torch.where(torch.abs(dx) > 1e-6, (bx - x0) / dx, torch.inf)
        ty = torch.where(torch.abs(dy) > 1e-6, (by - y0) / dy, torch.inf)
        return torch.minimum(tx, ty)

    def z_at(t):
        return 1.0 / torch.clamp(k0 + t * dk, min=1e-8)

    # Step out of the originating pixel first, so a surface never reflects
    # itself.
    mip = torch.zeros((h, w), dtype=torch.int32, device=dev)
    t = torch.minimum(cell_exit_t(torch.zeros((h, w), device=dev), mip), t_max)
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    t_hit = torch.zeros((h, w), device=dev)
    for _ in range(settings.num_steps):
        t_exit = torch.minimum(cell_exit_t(t, mip), t_max)
        x = x0 + t * dx
        y = y0 + t * dy
        size_i = 1 << mip
        mi = mip.long()
        mw, mh = ws[mi], hs[mi]
        cx = torch.clamp(torch.div(x.to(torch.int32), size_i,
                                   rounding_mode="floor"), min=0)
        cx = torch.minimum(cx, mw - 1)
        cy = torch.clamp(torch.div(y.to(torch.int32), size_i,
                                   rounding_mode="floor"), min=0)
        cy = torch.minimum(cy, mh - 1)
        zmin = flat[(offs[mi] + cy * mw + cx).long()]
        z_a, z_b = z_at(t), z_at(t_exit)
        z_far = torch.maximum(z_a, z_b)
        in_front = z_far < zmin + 0.01
        # A mip-0 crossing is a hit when the ray depth lands within
        # [zmin, zmin + thickness]; crossings in the last cell count too.
        hit_now = ((mip == 0) & ~in_front & (z_far >= zmin)
                   & (torch.minimum(z_a, z_b) <= zmin + settings.thickness)
                   & ~found)
        advance = in_front | ((mip == 0) & ~hit_now)
        stop = found | hit_now
        t_new = torch.where(stop, t, torch.where(advance, t_exit, t))
        mip = torch.where(stop, mip, torch.where(
            advance, torch.clamp(mip + 1, max=n_mips - 1),
            torch.clamp(mip - 1, min=0)))
        t_hit = torch.where(hit_now, t, t_hit)
        found = stop
        t = t_new

    xh = torch.clamp(x0 + t_hit * dx, 0, w - 1)
    yh = torch.clamp(y0 + t_hit * dy, 0, h - 1)
    px = xh.to(torch.int64)
    py = yh.to(torch.int64)
    hit_col = torch.where(found[..., None], color[py, px], 0.0)
    u, v = xh / w, yh / h
    edge = torch.minimum(torch.minimum(u, 1 - u), torch.minimum(v, 1 - v))
    conf = torch.where(found, torch.clamp(edge * 8, 0, 1) * (1.0 - roughness),
                       0.0)
    return hit_col, conf * settings.strength


# --------------------------------------------------------------------------
# TAA, bloom, tonemap, sharpen
# --------------------------------------------------------------------------

def taa(current, history, motion, settings: TAASettings = TAASettings()):
    """current / history (H, W, 3); motion (H, W, 2) pixel offsets to the
    previous frame.  History reprojected, clamped to the 3x3 neighbourhood,
    blended."""
    hist = _neighbourhood_clamp(_reproject(history, motion), current)
    return current * (1 - settings.blend) + hist * settings.blend


def bloom(color, settings: BloomSettings = BloomSettings()):
    """Threshold, a pyramid of `levels` blur + 2x downsamples, each level
    upsampled back and added with `strength`."""
    x = torch.clamp(color - settings.threshold, min=0.0)
    acc = torch.zeros_like(color)
    for _ in range(settings.levels):
        x = downsample2(gaussian_blur(x, 1.5))
        acc = acc + upsample2(x, color.shape[:2])
    return color + settings.strength * acc / max(settings.levels, 1)


def tonemap_uncharted2(x, s: TonemapSettings = TonemapSettings()):
    """Exposure and the Uncharted-2 curve, clamped to [0, 1]: the tonemap
    kernel on CUDA tensors (`ops/image.py`, sRGB off)."""
    return image.tonemap(x, s, srgb=False)


def sharpen(color, settings: SharpenSettings = SharpenSettings()):
    blur = gaussian_blur(color, 1.0)
    return torch.clamp(color + settings.strength * (color - blur), min=0.0)

