"""Image-based lighting preprocessing (counterpart of
``d3d12renderer_tpu/render/ibl.py``): equirect -> cubemap, diffuse
irradiance as 9 SH bands, GGX-prefiltered radiance per roughness level and
the split-sum BRDF LUT.  Environment resolutions of the reference: sky
2048, irradiance 32, prefiltered 128.

`prefilter_ggx` draws its samples from a `torch.Generator`, or takes them
(`draws`) as the tests inject the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import maths as m

SKY_RESOLUTION = 2048
IRRADIANCE_RESOLUTION = 32
PREFILTERED_RESOLUTION = 128


def cube_directions(face_res: int, device="cpu"):
    """(6, R, R, 3) unit directions through the texel centres of the faces
    +X, -X, +Y, -Y, +Z, -Z."""
    u = (torch.arange(face_res, device=device, dtype=torch.float32) + 0.5
         ) / face_res * 2 - 1
    gu, gv = torch.meshgrid(u, u, indexing="xy")
    one = torch.ones_like(gu)
    dirs = torch.stack([
        torch.stack([one, -gv, -gu], -1),
        torch.stack([-one, -gv, gu], -1),
        torch.stack([gu, one, gv], -1),
        torch.stack([gu, -one, -gv], -1),
        torch.stack([gu, -gv, one], -1),
        torch.stack([-gu, -gv, -one], -1),
    ])
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def equirect_to_cubemap(equirect, face_res: int):
    """(He, We, 3) equirect -> (6, R, R, 3) cubemap, nearest texel."""
    return sample_equirect(equirect,
                           cube_directions(face_res, equirect.device))


def equirect_texel(shape, d):
    """The (row, column) equirect texel of directions d (..., 3): the
    polar angle and azimuth scaled to the image and truncated."""
    he, we = shape[0], shape[1]
    theta = torch.acos(torch.clamp(d[..., 1], -1, 1))
    phi = torch.atan2(d[..., 2], d[..., 0])
    u = (phi / (2 * math.pi) + 0.5) * (we - 1)
    v = theta / math.pi * (he - 1)
    return (torch.clamp(v.to(torch.int32), 0, he - 1).long(),
            torch.clamp(u.to(torch.int32), 0, we - 1).long())


def sample_equirect(equirect, d):
    """Nearest-texel radiance of an (He, We, 3) equirect in directions d."""
    iv, iu = equirect_texel(equirect.shape, d)
    return equirect[iv, iu]


def _fibonacci_sphere(n: int, device):
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    phi = i * (math.pi * (3.0 - math.sqrt(5.0)))
    cos_t = 1.0 - 2.0 * i / n
    sin_t = torch.sqrt(torch.clamp(1 - cos_t ** 2, min=0))
    return torch.stack([sin_t * torch.cos(phi), cos_t,
                        sin_t * torch.sin(phi)], -1)


def irradiance_sh9(env_fn, num_samples: int = 2048, device="cpu"):
    """(9, 3) SH coefficients of an environment (`env_fn`: directions
    (N, 3) -> radiance (N, 3)) over a Fibonacci sphere of `num_samples`."""
    d = _fibonacci_sphere(num_samples, device)
    radiance = env_fn(d)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = torch.stack([
        0.282095 * torch.ones_like(x),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3 * z * z - 1),
        1.092548 * x * z, 0.546274 * (x * x - y * y),
    ], -1)
    return torch.einsum("nb,nc->bc", basis, radiance) * (
        4 * math.pi / num_samples)


def eval_irradiance_sh9(sh, n):
    """Diffuse irradiance from SH9 coefficients at normals n (..., 3)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    c = (0.429043, 0.511664, 0.743125, 0.886227, 0.247708)
    return (
        c[3] * sh[0]
        + 2 * c[1] * (sh[1] * y[..., None] + sh[2] * z[..., None]
                      + sh[3] * x[..., None])
        + 2 * c[0] * (sh[4] * (x * y)[..., None] + sh[5] * (y * z)[..., None]
                      + sh[7] * (x * z)[..., None])
        + c[2] * sh[6] * (z * z)[..., None] - c[4] * sh[6]
        + c[0] * sh[8] * (x * x - y * y)[..., None]
    )


def prefilter_ggx(env_fn, roughness_levels=(0.0, 0.25, 0.5, 0.75, 1.0),
                  num_dirs: int = 256, num_samples: int = 128,
                  generator=None, draws=None, device="cpu"):
    """GGX-prefiltered radiance per roughness level on a Fibonacci set of
    `num_dirs` directions.  Each level takes two uniform draws of
    `num_samples`: `draws[level] = (u1, u2)`, else from `generator`.
    Returns (dirs (D, 3), radiance (levels, D, 3))."""
    dirs = _fibonacci_sphere(num_dirs, device)
    t1, t2 = m.orthonormal_basis(dirs)
    levels = []
    for i, rough in enumerate(roughness_levels):
        alpha = max(rough * rough, 1e-3)
        if draws is not None:
            u1, u2 = (torch.as_tensor(np.array(x, np.float32), device=device)
                      for x in draws[i])
        else:
            u1, u2 = torch.rand((2, num_samples), generator=generator,
                                device=device)
        ct = torch.sqrt((1 - u1) / (1 + (alpha * alpha - 1) * u1))
        st = torch.sqrt(torch.clamp(1 - ct * ct, min=0))
        ph = 2 * math.pi * u2
        h = (t1[:, None] * (st * torch.cos(ph))[None, :, None]
             + t2[:, None] * (st * torch.sin(ph))[None, :, None]
             + dirs[:, None] * ct[None, :, None])
        l = (2 * torch.sum(dirs[:, None] * h, -1, keepdim=True) * h
             - dirs[:, None])
        w = torch.clamp(torch.sum(dirs[:, None] * l, -1), min=0.0)
        rad = env_fn(l.reshape(-1, 3)).reshape(num_dirs, num_samples, 3)
        levels.append(torch.sum(rad * w[..., None], 1) / torch.clamp(
            torch.sum(w, 1)[..., None], min=1e-6))
    return dirs, torch.stack(levels)


def _radical_inverse(n: int, device):
    """Van der Corput radical inverse of 0..n-1 (32-bit reversal)."""
    bits = torch.arange(n, dtype=torch.int64, device=device)
    mask = 0xFFFFFFFF
    bits = ((bits << 16) | (bits >> 16)) & mask
    for shift, lo in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                      (8, 0x00FF00FF)):
        hi = lo ^ mask
        bits = (((bits & lo) << shift) | ((bits & hi) >> shift)) & mask
    return bits.to(torch.float32) * (1.0 / 4294967296.0)


def brdf_lut(resolution: int = 64, num_samples: int = 256, device="cpu"):
    """(R, R, 2) split-sum BRDF LUT (scale, bias), indexed [roughness,
    n_dot_v], from `num_samples` Hammersley samples."""
    nv = (torch.arange(resolution, device=device) + 0.5) / resolution
    rough = (torch.arange(resolution, device=device) + 0.5) / resolution
    nvg, rg = torch.meshgrid(nv, rough, indexing="xy")
    v = torch.stack([torch.sqrt(1 - nvg ** 2), torch.zeros_like(nvg), nvg], -1)
    i = torch.arange(num_samples, dtype=torch.float32, device=device)
    u1 = (i + 0.5) / num_samples
    u2 = _radical_inverse(num_samples, device)

    alpha = torch.clamp(rg * rg, min=1e-3)[..., None]
    ct = torch.sqrt((1 - u1) / (1 + (alpha ** 2 - 1) * u1))
    st = torch.sqrt(torch.clamp(1 - ct ** 2, min=0))
    ph = 2 * math.pi * u2
    h = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], -1)
    l = 2 * torch.sum(v[..., None, :] * h, -1, keepdim=True) * h \
        - v[..., None, :]
    n_dot_l = torch.clamp(l[..., 2], min=0.0)
    n_dot_h = torch.clamp(h[..., 2], min=0.0)
    v_dot_h = torch.clamp(torch.sum(v[..., None, :] * h, -1), min=1e-6)
    n_dot_v = torch.clamp(nvg, min=1e-4)[..., None]

    k = (rg[..., None] ** 2) / 2.0
    g = (n_dot_l / (n_dot_l * (1 - k) + k)) * (n_dot_v / (n_dot_v * (1 - k)
                                                          + k))
    g_vis = g * v_dot_h / torch.clamp(n_dot_h * n_dot_v, min=1e-6)
    fc = (1 - v_dot_h) ** 5
    valid = n_dot_l > 0
    a_sum = torch.sum(torch.where(valid, (1 - fc) * g_vis, 0.0), -1) \
        / num_samples
    b_sum = torch.sum(torch.where(valid, fc * g_vis, 0.0), -1) / num_samples
    return torch.stack([a_sum, b_sum], -1)
