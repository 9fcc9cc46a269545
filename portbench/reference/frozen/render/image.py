"""The gaussian blur and the Uncharted-2 tonemap, plain PyTorch."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

@functools.lru_cache(maxsize=32)
def _taps(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_kernel(sigma: float, radius: Optional[int] = None) -> torch.Tensor:
    """The (2r+1,) normalised gaussian taps, r = max(1, int(3 sigma)) by
    default: float32, on the CPU (the card and the CPU paths use the same
    taps; the kernel takes them by value), cached."""
    radius = radius if radius is not None else max(1, int(3 * sigma))
    return _taps(float(sigma), int(radius))


def blur_plain(img, taps):
    """`_sep_conv`: the taps down the rows axis (axis 0), then along the
    columns axis (axis 1), edge-clamped; (H, W) or (H, W, C)."""
    r = taps.shape[0] // 2

    def conv_axis(x, axis):
        n = x.shape[axis]
        base = torch.arange(n, device=x.device)
        out = torch.zeros_like(x)
        for i in range(taps.shape[0]):
            idx = torch.clamp(base + (i - r), 0, n - 1)
            out = out + taps[i] * torch.index_select(x, axis, idx)
        return out

    return conv_axis(conv_axis(img, 0), 1)


def _f32(x) -> float:
    return float(np.float32(x))


def _curve(v, k):
    """The Uncharted-2 curve in the kernel's operation order."""
    return ((v * (k["a"] * v + k["cb"]) + k["de"])
            / (v * (k["a"] * v + k["b"]) + k["df"])) - k["ef"]


@functools.lru_cache(maxsize=16)
def tonemap_constants(settings) -> dict:
    """The kernel's float32 constants of a `post.TonemapSettings`: products
    and quotients of the settings in double precision, then rounded, as
    JAX's weakly typed Python scalars; `white` = the curve at the linear
    white, computed in float32."""
    s = settings
    k = {"scale": _f32(2.0 ** s.exposure), "a": _f32(s.A), "b": _f32(s.B),
         "cb": _f32(s.C * s.B), "de": _f32(s.D * s.E), "df": _f32(s.D * s.F),
         "ef": _f32(s.E / s.F)}
    k["white"] = float(_curve(torch.tensor(s.linear_white,
                                           dtype=torch.float32), k))
    return k


def tonemap_plain(x, k: dict, srgb: bool):
    exposed = torch.clamp(x * k["scale"], min=0.0)
    # A tensor divisor: on the card PyTorch turns a division by a Python
    # scalar into a product with its reciprocal, which rounds differently.
    white = torch.tensor(k["white"], device=x.device)
    y = torch.clamp(_curve(exposed, k) / white, 0.0, 1.0)
    if srgb:
        y = torch.where(y <= 0.0031308, y * 12.92,
                        1.055 * torch.exp(torch.log(torch.clamp(y, min=1e-7))
                                          * (1 / 2.4)) - 0.055)
    return y


def gaussian_blur(img, taps):
    return blur_plain(img, taps)


def tonemap(x, settings, srgb: bool = False):
    return tonemap_plain(x, tonemap_constants(settings), srgb)
