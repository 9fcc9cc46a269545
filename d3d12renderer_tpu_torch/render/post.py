"""The raster frame's post-processing: HBAO, screen-space shadows, SSR,
TAA, bloom, tonemap, sharpen, and their helpers (counterpart of
``d3d12renderer_tpu/render/post.py``).

Every pass is an image function on (H, W[, C]) tensors.  The blur and the
tonemap go through the hand-written kernels of `ops/image.py` on CUDA
tensors (their plain versions on CPU tensors); the rest is plain PyTorch,
`gaussian_blur_matmul` two banded matrix products (XLA matmuls in JAX).
Settings defaults are the JAX package's (the reference's structs).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import maths as m
from ..core.maths import roll2
from ..ops import image
from ..ops.ssr import ssr_march

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
    """Separable edge-clamped gaussian of (H, W) or (H, W, C): the blur
    kernel on CUDA tensors, its plain version (`image.blur_plain`, JAX's
    `_sep_conv`) on CPU tensors."""
    return image.gaussian_blur(img, gaussian_kernel(sigma))


# JAX's `_sep_conv`: the taps down the rows, then along the columns,
# edge-clamped (the blur kernel's plain version).
_sep_conv = image.blur_plain


@functools.lru_cache(maxsize=32)
def _banded_blur_matrix(n: int, sigma: float, radius, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    """(n, n) edge-clamped convolution matrix: row i holds the taps centred
    at i, taps that fall off an edge added onto the edge sample; built on
    the host in JAX's operation order (float64 taps accumulated into
    float32)."""
    radius = radius if radius is not None else max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    b = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t in range(2 * radius + 1):
        np.add.at(b, (rows, np.clip(rows + t - radius, 0, n - 1)), k[t])
    return torch.as_tensor(b).to(device=device, dtype=dtype)


def gaussian_blur_matmul(img, sigma: float = 2.0, radius=None,
                         dtype: torch.dtype = torch.bfloat16):
    """The separable gaussian as two banded matrix products, Bh @ img @
    Bw^T, of (H, W) or (H, W, C): operands rounded to `dtype` (bfloat16 by
    default, as JAX), products summed in float32 (a product of two
    bfloat16 values is exact in float32), the intermediate rounded to
    `dtype` again; the result in the input's dtype."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    bh = _banded_blur_matrix(h, float(sigma), radius, dtype, img.device)
    bw = _banded_blur_matrix(w, float(sigma), radius, dtype, img.device)
    f32 = torch.float32
    y = torch.einsum("ih,hwc->iwc", bh.to(f32), img.to(dtype).to(f32))
    out = torch.einsum("jw,iwc->ijc", bw.to(f32), y.to(dtype).to(f32))
    out = out.to(img.dtype)
    return out[..., 0] if squeeze else out


def _minmax_filter(img, size: int, op):
    pad = size // 2
    acc = img
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            acc = op(acc, roll2(img, dy, dx))
    return acc


def dilate(img, size: int = 3):
    """Max over the size x size neighbourhood (wrapping at the edges)."""
    return _minmax_filter(img, size, torch.maximum)


def erode(img, size: int = 3):
    """Min over the size x size neighbourhood (wrapping at the edges)."""
    return _minmax_filter(img, size, torch.minimum)


def sobel(img):
    """Edge magnitude of a single-channel image: central differences
    (wrapping), sqrt(gx^2 + gy^2)."""
    gx = torch.roll(img, -1, 1) - torch.roll(img, 1, 1)
    gy = torch.roll(img, -1, 0) - torch.roll(img, 1, 0)
    return torch.sqrt(gx * gx + gy * gy)


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

def screen_space_shadows(view_pos, sun_dir_view, depth=None,
                         settings: SSSSettings = SSSSettings()):
    """(H, W) shadow factor in [0, 1], 1 lit: each pixel marches
    `num_steps` steps toward the sun in view space, projects each step to
    a pixel offset and tests the depth found there; faded out with the
    distance from the camera.  `depth` is unused, as in JAX."""
    h, w, _ = view_pos.shape
    dev = view_pos.device
    step = settings.ray_distance / settings.num_steps
    cam_dist = -view_pos[..., 2]
    base_u = view_pos[..., 0] / torch.clamp(-view_pos[..., 2], min=1e-4)
    base_v = view_pos[..., 1] / torch.clamp(-view_pos[..., 2], min=1e-4)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    shadow = torch.ones((h, w), device=dev)
    for s in range(1, settings.num_steps + 1):
        # JAX: s.astype(float32) * step, a float32 product.
        p = view_pos + sun_dir_view * float(np.float32(s) * np.float32(step))
        u = p[..., 0] / torch.clamp(-p[..., 2], min=1e-4)
        v = p[..., 1] / torch.clamp(-p[..., 2], min=1e-4)
        px = torch.clamp(torch.round((u - base_u) * w * 0.5), -w, w).long()
        py = torch.clamp(torch.round(-(v - base_v) * h * 0.5), -h, h).long()
        yy = torch.clamp(rows + py, 0, h - 1)
        xx = torch.clamp(cols + px, 0, w - 1)
        gap = -p[..., 2] - (-view_pos[yy, xx, 2])
        blocked = (gap > 0.01) & (gap < settings.thickness * 40)
        shadow = torch.where(blocked, torch.clamp(shadow, max=0.0), shadow)
    fade = torch.clamp((settings.max_distance_from_camera - cam_dist)
                       / settings.distance_fadeout_range, 0.0, 1.0)
    return 1.0 - (1.0 - shadow) * fade


def pyramid_levels(h: int, w: int, max_mip: int = 6):
    """(offsets, widths, heights) of `build_min_depth_pyramid`'s levels of
    an (h, w) image, as host integers."""
    heights, widths = [h], [w]
    for _ in range(max_mip):
        hh, ww = heights[-1], widths[-1]
        if hh < 2 or ww < 2:
            break
        heights.append((hh + hh % 2) // 2)
        widths.append((ww + ww % 2) // 2)
    offsets = [0]
    for hh, ww in zip(heights[:-1], widths[:-1]):
        offsets.append(offsets[-1] + hh * ww)
    return offsets, widths, heights


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
        # Cached: a tensor built from host data waits for the card's queue.
        return m.constant(tuple(x), torch.int32, dev)

    flat = torch.cat([l.reshape(-1) for l in levels])
    return flat, ints(offsets), ints(widths), ints(heights)


def ssr_rays(view_pos, normal, settings: SSRSettings = SSRSettings(),
             tan_half: float = 1.0, aspect: float = 1.0) -> dict:
    """`ssr`'s march inputs: every pixel's reflected ray projected to the
    screen (start x0, y0 and extent dx, dy in pixels, inverse depths k0 and
    dk, the exit parameter t_max) and the linear-depth min-pyramid (flat,
    offs, ws, hs; `levels` its offsets, widths and heights on the host)."""
    h, w, _ = view_pos.shape
    dev = view_pos.device
    view_dir = view_pos / torch.clamp(
        torch.linalg.norm(view_pos, dim=-1, keepdim=True), min=1e-6)
    refl = view_dir - 2 * torch.sum(view_dir * normal, -1,
                                    keepdim=True) * normal

    depth = torch.clamp(-view_pos[..., 2], min=1e-4)
    flat, offs, ws, hs = build_min_depth_pyramid(depth, settings.max_mip)

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
    return dict(x0=x0, y0=y0, dx=dx, dy=dy, k0=k0, dk=dk, t_max=t_max,
                flat=flat, offs=offs, ws=ws, hs=hs,
                levels=pyramid_levels(h, w, settings.max_mip))


def ssr(color, view_pos, normal, roughness,
        settings: SSRSettings = SSRSettings(), tan_half: float = 1.0,
        aspect: float = 1.0):
    """Screen-space reflections: a hierarchical-Z march of the linear-depth
    min-pyramid, projected with the camera's frustum (tan_half =
    tan(v_fov / 2)): the rays of `ssr_rays`, the march of `ops/ssr.py`
    (one kernel launch on the card).  Returns (H, W, 3) reflected colour and
    (H, W) hit confidence."""
    h, w, _ = view_pos.shape
    r = ssr_rays(view_pos, normal, settings, tan_half, aspect)
    x0, y0, dx, dy = r["x0"], r["y0"], r["dx"], r["dy"]
    t_hit, found = ssr_march(x0, y0, dx, dy, r["k0"], r["dk"], r["t_max"],
                             r["flat"], r["offs"], r["ws"], r["hs"],
                             settings.num_steps, settings.thickness,
                             levels=r["levels"])

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


def to_srgb(img):
    return torch.where(img <= 0.0031308, img * 12.92,
                       1.055 * torch.clamp(img, 0, 1) ** (1 / 2.4) - 0.055)
