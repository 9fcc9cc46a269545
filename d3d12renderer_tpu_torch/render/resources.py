"""Shared render resources built once and reused (counterpart of
``d3d12renderer_tpu/render/resources.py``): default white, black and flat
normal textures, the split-sum BRDF LUT and a checker texture, cached per
(kind, size, device)."""

from __future__ import annotations

import torch

from ..cuda_build import resolve_device

_cache = {}


def _cached(key, make):
    if key not in _cache:
        _cache[key] = make()
    return _cache[key]


def default_white(size: int = 4, device="cuda"):
    device = resolve_device(device)
    return _cached(("white", size, device),
                   lambda: torch.ones((size, size, 3), device=device))


def default_black(size: int = 4, device="cuda"):
    device = resolve_device(device)
    return _cached(("black", size, device),
                   lambda: torch.zeros((size, size, 3), device=device))


def default_normal_map(size: int = 4, device="cuda"):
    """A flat tangent-space normal (0.5, 0.5, 1)."""
    device = resolve_device(device)
    return _cached(("normal", size, device), lambda: torch.tensor(
        [0.5, 0.5, 1.0], device=device).expand(size, size, 3))


def brdf_lookup(resolution: int = 64, device="cuda"):
    """The split-sum BRDF LUT (`ibl.brdf_lut`), built once."""
    from .ibl import brdf_lut

    device = resolve_device(device)
    return _cached(("brdf", resolution, device),
                   lambda: brdf_lut(resolution=resolution, device=device))


def checker_texture(size: int = 64, squares: int = 8, device="cuda"):
    device = resolve_device(device)

    def make():
        i = torch.arange(size, device=device) * squares // size
        pattern = (i[:, None] + i[None, :]) % 2
        return torch.where(pattern[..., None] > 0, 0.8, 0.3) * torch.ones(
            3, device=device)

    return _cached(("checker", size, squares, device), make)


def clear_cache():
    _cache.clear()
