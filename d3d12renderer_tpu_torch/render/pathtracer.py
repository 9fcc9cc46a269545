"""Progressive wavefront path tracer (counterpart of
``d3d12renderer_tpu/render/pathtracer.py``).

Each bounce is one closest-hit query over all R = W*H rays (through the ray
kernels of `ops/ray_trace.py` on the card), shading, next-event estimation
toward the sun and one random point light with MIS, and the next BRDF
sample, with a live mask instead of divergent exits; on the card the
shading is two kernels a bounce (`ops/pt_shade.py`, whose plain versions
live here).  Skies: gradient, Preetham daylight, cubemap.  BRDF:
Cook-Torrance GGX + Lambert.

Random numbers come from a `Sampler`, which draws in the JAX path tracer's
order and shapes, so that a test can replay JAX's draws into this code.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..core import maths as m
from ..core import profiling
from ..cuda_build import resolve_device
from ..ops import pt_shade, ray_trace
from . import bvh as bvh_mod
from .bvh import BVH
from .camera import Camera, generate_rays
from .lights import PointLights

SUN_COS_CONE = 0.9995
SUN_PDF = 1.0 / (2.0 * math.pi * (1.0 - SUN_COS_CONE))
T_FAR = 1e30


class Sampler:
    """The random numbers of a render, from one `torch.Generator` on the
    render's device.  Per sample: the camera jitter (H, W, 2) (and, with a
    thin lens, two (R,) uniforms); per bounce: the sun-cone u1, u2
    (scalars), the point-light pick (R,) and sphere normal (R, 3), the BRDF
    u1, u2 and lobe pick (R,) each, the roulette uniform (R,)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def uniform(self, shape):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def randint(self, shape, high):
        """Uniform ints in [0, high) for a 0-d integer tensor `high`
        (no host round trip)."""
        u = self.uniform(shape)
        return torch.minimum((u * high).to(torch.int64), high - 1)


@dataclass
class Materials:
    albedo: torch.Tensor      # (M, 3)
    emissive: torch.Tensor    # (M, 3)
    roughness: torch.Tensor   # (M,)
    metallic: torch.Tensor    # (M,)
    # Optional albedo textures: a square atlas stack and a per-material
    # index (-1 = untextured).
    texture_atlas: Optional[torch.Tensor] = None   # (K, R, R, 3)
    albedo_texture: Optional[torch.Tensor] = None  # (M,) int32


def sample_albedo(materials: Materials, mat, uv):
    """Per-hit albedo: the material's tint times its texture, sampled
    nearest with wrapping, where it has one."""
    base = materials.albedo[mat]
    if materials.texture_atlas is None:
        return base
    ti = materials.albedo_texture[mat]
    t = torch.clamp(ti, min=0).long()
    r = materials.texture_atlas.shape[1]
    u = torch.remainder(uv[..., 0], 1.0)
    v = torch.remainder(uv[..., 1], 1.0)
    px = torch.clamp((u * (r - 1)).to(torch.int64), 0, r - 1)
    py = torch.clamp((v * (r - 1)).to(torch.int64), 0, r - 1)
    tex = materials.texture_atlas[t, py, px]
    return torch.where((ti >= 0)[..., None], base * tex, base)


@dataclass
class Sky:
    """Procedural sun disc + gradient, Preetham daylight (`turbidity` set)
    or a textured cubemap (`cubemap` set); the sun disc adds on top."""

    sun_direction: torch.Tensor   # (3,) direction TOWARD the sun
    sun_radiance: torch.Tensor    # (3,)
    zenith: torch.Tensor          # (3,)
    horizon: torch.Tensor         # (3,)
    ground: torch.Tensor          # (3,)
    cubemap: Optional[torch.Tensor] = None        # (6, R, R, 3)
    turbidity: Optional[torch.Tensor] = None      # () float32
    preetham_scale: Optional[torch.Tensor] = None  # ()


@dataclass
class Scene:
    bvh: BVH
    materials: Materials
    sky: Sky
    point_lights: Optional[PointLights] = None
    # The (T, 28) per-triangle shading table (bvh.build_shading_table) and
    # the packed sky (`sky_table`, with Preetham's per-sky terms):
    # frame-invariant, built once by `with_shading_table`.
    attr_table: Optional[torch.Tensor] = None
    sky_table: Optional[torch.Tensor] = None

    def with_shading_table(self) -> "Scene":
        return replace(self, attr_table=bvh_mod.build_shading_table(
            self.bvh, self.materials), sky_table=sky_table(self.sky))


@dataclass(frozen=True)
class PathTracerSettings:
    recursion_depth: int = 3
    start_russian_roulette_after: int = 3
    use_thin_lens: bool = False
    f_number: float = 32.0
    focal_length: float = 1.0
    enable_direct_lighting: bool = True
    light_intensity_scale: float = 1.0
    multiple_importance_sampling: bool = True
    # Physical emitter radius for sphere-light solid-angle sampling.
    point_light_radius: float = 0.1


def default_sky(sun_direction=(-0.6, 0.8, -0.3), device="cuda") -> Sky:
    d = np.asarray(sun_direction, np.float64)
    d = d / np.linalg.norm(d)
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return Sky(sun_direction=f32(d.astype(np.float32)),
               sun_radiance=f32([50.0, 47.0, 42.0]),
               zenith=f32([0.25, 0.45, 0.85]), horizon=f32([0.65, 0.75, 0.9]),
               ground=f32([0.25, 0.22, 0.2]))


def preetham_sky(sun_direction=(-0.6, 0.8, -0.3), turbidity: float = 3.0,
                 scale: float = 0.03, device="cuda", **kw) -> Sky:
    base = default_sky(sun_direction, device)
    return replace(base, turbidity=torch.tensor(turbidity, dtype=torch.float32,
                                                device=device),
                   preetham_scale=torch.tensor(scale, dtype=torch.float32,
                                               device=device), **kw)


def sample_cubemap(cube, d):
    """Bilinear lookup of a (6, R, R, 3) cubemap (+X -X +Y -Y +Z -Z) in
    directions d (..., 3)."""
    r = cube.shape[1]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(dx > 0, 0, 1),
        torch.where(is_y, torch.where(dy > 0, 2, 3),
                    torch.where(dz > 0, 4, 5)))
    major = torch.where(is_x, dx, torch.where(is_y, dy, dz))
    sc = torch.where(is_x, -torch.sign(dx) * dz,
                     torch.where(is_y, dx, torch.sign(dz) * dx))
    tc = torch.where(is_y, torch.sign(dy) * dz, -dy)
    inv = 1.0 / torch.clamp(major.abs(), min=1e-9)
    u = torch.clamp((sc * inv * 0.5 + 0.5) * (r - 1), 0.0, r - 1.0)
    v = torch.clamp((tc * inv * 0.5 + 0.5) * (r - 1), 0.0, r - 1.0)
    u0 = torch.clamp(torch.floor(u).long(), 0, r - 2)
    v0 = torch.clamp(torch.floor(v).long(), 0, r - 2)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    c00 = cube[face, v0, u0]
    c01 = cube[face, v0, u0 + 1]
    c10 = cube[face, v0 + 1, u0]
    c11 = cube[face, v0 + 1, u0 + 1]
    return ((1 - fv) * ((1 - fu) * c00 + fu * c01)
            + fv * ((1 - fu) * c10 + fu * c11))


def _perez(theta_cos, gamma, gamma_cos, coeff):
    a, b, c, e, f = coeff
    return ((1.0 + a * torch.exp(b / torch.clamp(theta_cos, min=0.01)))
            * (1.0 + c * torch.exp(e * gamma) + f * gamma_cos ** 2))


def preetham_terms(sun_dir, turbidity):
    """The per-sky terms of Preetham's daylight: the Perez coefficients
    (a, b, c, e, f) of Y, x and y, their zenith values and each Perez
    function at the zenith, as 0-d tensors."""
    t = turbidity
    cy = (0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
          0.1206 * t - 2.5771, -0.0670 * t + 0.3703)
    cx = (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
          -0.0641 * t - 0.8989, -0.0033 * t + 0.0452)
    cyy = (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
           -0.0441 * t - 1.6537, -0.0109 * t + 0.0529)

    cos_ts = torch.clamp(sun_dir[1], -1.0, 1.0)
    theta_s = torch.acos(torch.clamp(cos_ts, 0.0, 1.0))
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * torch.tan(chi) - 0.2155 * t + 2.4192
    yz = torch.clamp(yz, min=1e-3)
    th = torch.stack([theta_s ** 3, theta_s ** 2, theta_s,
                      torch.ones_like(theta_s)])
    tv = torch.stack([t * t, t, torch.ones_like(t)])
    dev = sun_dir.device
    mx = torch.tensor([[0.00166, -0.02903, 0.11693],
                       [-0.00375, 0.06377, -0.21196],
                       [0.00209, -0.03202, 0.06052],
                       [0.0, 0.00394, 0.25886]], device=dev)
    my = torch.tensor([[0.00275, -0.04214, 0.15346],
                       [-0.00610, 0.08970, -0.26756],
                       [0.00317, -0.04153, 0.06670],
                       [0.0, 0.00516, 0.26688]], device=dev)
    xz = th @ mx @ tv
    yyz = th @ my @ tv
    coeffs = (cy, cx, cyy)
    ones = torch.ones_like(theta_s)
    at_zenith = tuple(_perez(ones, theta_s, cos_ts, c) for c in coeffs)
    return coeffs, (yz, xz, yyz), at_zenith


def _preetham_radiance(sun_dir, turbidity, scale, d):
    """Perez xyY daylight (Preetham, Shirley, Smits 1999) per direction, as
    linear sRGB radiance; below-horizon directions clamp to the band."""
    (cy, cx, cyy), (yz, xz, yyz), (py, px, pyy) = preetham_terms(
        sun_dir, turbidity)
    cos_t = torch.clamp(d[..., 1], 0.01, 1.0)
    cos_g = torch.clamp(torch.sum(d * sun_dir, -1), -1.0, 1.0)
    gamma = torch.acos(cos_g)

    def ratio(coeff, zen, at_zenith):
        return zen * (_perez(cos_t, gamma, cos_g, coeff) / at_zenith)

    lum = ratio(cy, yz, py) * scale
    x = ratio(cx, xz, px)
    y = ratio(cyy, yyz, pyy)
    ys = torch.clamp(y, min=1e-4)
    xyz = torch.stack([x * lum / ys, lum, (1.0 - x - ys) * lum / ys], -1)
    mat = torch.tensor([[3.2406, -1.5372, -0.4986],
                        [-0.9689, 1.8758, 0.0415],
                        [0.0557, -0.2040, 1.0570]], device=d.device)
    return torch.clamp(xyz @ mat.T, min=0.0)


def sky_radiance(sky: Sky, d):
    """Environment radiance for miss directions d (R, 3)."""
    cos_sun = torch.sum(d * sky.sun_direction, -1, keepdim=True)
    sun = torch.where(cos_sun > 0.9995, sky.sun_radiance, 0.0)
    if sky.cubemap is not None:
        return sample_cubemap(sky.cubemap, d) + sun
    y = d[..., 1:2]
    if sky.turbidity is not None:
        col = _preetham_radiance(sky.sun_direction, sky.turbidity,
                                 sky.preetham_scale, d)
        fade = torch.clamp(y / 0.02, 0.0, 1.0)
        return col * fade + sky.ground * (1.0 - fade) + sun
    t = torch.clamp(y, 0.0, 1.0) ** 0.6
    col = sky.horizon * (1 - t) + sky.zenith * t
    col = torch.where(y < 0, sky.ground, col)
    return col + sun


# --------------------------------------------------------------------------
# GGX BRDF
# --------------------------------------------------------------------------

def _fresnel_schlick(cos_t, f0):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - cos_t, 0.0, 1.0)[..., None] ** 5


def _ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=1e-8)


def _smith_g(n_dot_v, n_dot_l, alpha):
    k = alpha * alpha / 2.0
    gv = n_dot_v / torch.clamp(n_dot_v * (1 - k) + k, min=1e-8)
    gl = n_dot_l / torch.clamp(n_dot_l * (1 - k) + k, min=1e-8)
    return gv * gl


def eval_brdf(n, v, l, albedo, roughness, metallic):
    """Cook-Torrance specular + Lambert diffuse.  Returns (f, pdf_bsdf)."""
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    h = m.noz(v + l)
    n_dot_v = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    n_dot_l = torch.clamp(torch.sum(n * l, -1), min=0.0)
    n_dot_h = torch.clamp(torch.sum(n * h, -1), 0.0, 1.0)
    v_dot_h = torch.clamp(torch.sum(v * h, -1), min=1e-4)

    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    F = _fresnel_schlick(v_dot_h, f0)
    D = _ggx_d(n_dot_h, alpha)
    G = _smith_g(n_dot_v, n_dot_l, alpha)
    spec = F * (D * G / torch.clamp(4.0 * n_dot_v * n_dot_l, min=1e-8))[..., None]
    diff = albedo * (1.0 - metallic[..., None]) * (1.0 - F) / math.pi
    f = (diff + spec) * n_dot_l[..., None]
    # The mixed pdf of `brdf_sample` (half diffuse, half GGX).
    pdf_diff = n_dot_l / math.pi
    pdf_spec = D * n_dot_h / torch.clamp(4.0 * v_dot_h, min=1e-8)
    return f, 0.5 * pdf_diff + 0.5 * pdf_spec


def brdf_sample(u1, u2, u_pick, n, v, albedo, roughness, metallic):
    """Sample the mixed diffuse / GGX lobe from three (R,) uniforms (u1, u2,
    lobe pick).  Returns (l, f / pdf weight, pdf)."""
    pick_spec = u_pick < 0.5
    t1, t2 = m.orthonormal_basis(n)
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    # Cosine-weighted diffuse direction.
    rad = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    ld = (t1 * (rad * torch.cos(phi))[:, None]
          + t2 * (rad * torch.sin(phi))[:, None]
          + n * torch.sqrt(torch.clamp(1 - u1, min=0.0))[:, None])
    # GGX half-vector sample, view reflected about it.
    cos_t = torch.sqrt((1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    h = (t1 * (sin_t * torch.cos(phi))[:, None]
         + t2 * (sin_t * torch.sin(phi))[:, None]
         + n * cos_t[:, None])
    ls = 2.0 * torch.sum(v * h, -1, keepdim=True) * h - v
    l = m.noz(torch.where(pick_spec[:, None], ls, ld))
    f, pdf = eval_brdf(n, v, l, albedo, roughness, metallic)
    w = torch.where((pdf > 1e-8)[:, None],
                    f / torch.clamp(pdf, min=1e-8)[:, None], 0.0)
    valid = torch.sum(l * n, -1) > 0
    return l, torch.where(valid[:, None], w, 0.0), pdf


def sun_direction(sky: Sky, u1, u2):
    """Uniform direction in the sun cone from two scalar uniforms."""
    cos_t = 1.0 - u1 * (1.0 - SUN_COS_CONE)
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0.0))
    phi = 2 * math.pi * u2
    t1, t2 = m.orthonormal_basis(sky.sun_direction)
    return (t1 * sin_t * torch.cos(phi) + t2 * sin_t * torch.sin(phi)
            + sky.sun_direction * cos_t)


# --------------------------------------------------------------------------
# A bounce's shading: what it reads of the scene, its draws, and the plain
# versions of the two halves that ops/pt_shade.py launches on the card
# --------------------------------------------------------------------------

def sky_kind(sky: Sky) -> int:
    """The sky `sky_radiance` renders: the cubemap where set, else
    Preetham's where a turbidity is set, else the gradient."""
    if sky.cubemap is not None:
        return pt_shade.SKY_CUBEMAP
    return (pt_shade.SKY_PREETHAM if sky.turbidity is not None
            else pt_shade.SKY_GRADIENT)


def sky_table(sky: Sky) -> torch.Tensor:
    """(pt_shade.SKY_COLS,) float32: the sky's colours and, for Preetham's
    sky, its per-sky terms (`preetham_terms`), the same bits as the eager
    code computes them."""
    parts = [sky.sun_direction, sky.sun_radiance, sky.zenith, sky.horizon,
             sky.ground]
    if sky_kind(sky) == pt_shade.SKY_PREETHAM:
        coeffs, zen, den = preetham_terms(sky.sun_direction, sky.turbidity)
        parts += [sky.preetham_scale, *(c for cs in coeffs for c in cs),
                  *zen, *den]
    flat = torch.cat([x.to(torch.float32).reshape(-1) for x in parts])
    return torch.cat([flat, flat.new_zeros(pt_shade.SKY_COLS
                                           - flat.shape[0])])


@dataclass
class ShadeContext:
    """What one sample's shading reads of the scene and the settings."""

    scene: Scene
    settings: PathTracerSettings
    table: torch.Tensor            # (T, 28) bvh.build_shading_table
    sky: torch.Tensor              # (SKY_COLS,) sky_table
    sky_kind: int                  # pt_shade.SKY_*
    cubemap: Optional[torch.Tensor] = None         # the cubemap sky's
    atlas: Optional[torch.Tensor] = None           # the texture atlas
    lights: Optional[PointLights] = None           # direct lighting only
    light_count: Optional[torch.Tensor] = None     # () int64: valid, >= 1
    # The sun cone, which the kernels take as an argument.
    sun_cos_cone: float = SUN_COS_CONE


def shading_context(scene: Scene, settings: PathTracerSettings
                    ) -> ShadeContext:
    """The scene's shading table and packed sky (built here when the scene
    holds none: `Scene.with_shading_table`), and the point lights with
    their valid count where direct lighting is on."""
    table = scene.attr_table
    if table is None:
        table = bvh_mod.build_shading_table(scene.bvh, scene.materials)
    sky = scene.sky_table if scene.sky_table is not None else sky_table(
        scene.sky)
    kind = sky_kind(scene.sky)
    lights = scene.point_lights if settings.enable_direct_lighting else None
    count = None
    if lights is not None:
        count = torch.clamp(lights.valid.to(torch.int32).sum(), min=1)
    return ShadeContext(
        scene, settings, table, sky, kind,
        scene.sky.cubemap if kind == pt_shade.SKY_CUBEMAP else None,
        scene.materials.texture_atlas, lights, count)


def draw_bounce(sampler, ctx: ShadeContext, r: int,
                bounce: int) -> pt_shade.BounceDraws:
    """The bounce's draws in the eager shading's order and shapes: the sun
    cone's two scalars, the point light's pick (R,) and sphere normal
    (R, 3), the BRDF's u1, u2 and lobe pick (R,) each before the last
    bounce, the roulette's (R,) from `start_russian_roulette_after` on.
    No draw depends on data, so drawing them first changes nothing."""
    s = ctx.settings
    out = pt_shade.BounceDraws()
    if s.enable_direct_lighting:
        out.sun = (sampler.uniform(()), sampler.uniform(()))
        if ctx.lights is not None:
            out.light = (sampler.randint((r,), ctx.light_count),
                         sampler.normal((r, 3)))
    if bounce < s.recursion_depth:
        out.brdf = tuple(sampler.uniform((r,)) for _ in range(3))
        if bounce >= s.start_russian_roulette_after:
            out.roulette = sampler.uniform((r,))
    return out


def _where3(mask, a, b=0.0):
    return torch.where(mask[:, None], a, b)


def _light_sample_plain(ctx, draws, p):
    """The point-light pick and its sphere sample: (li, l_pt, dist, att,
    pdf_l)."""
    lights, s = ctx.lights, ctx.settings
    rank, normal = draws.light
    valid_i = lights.valid.to(torch.int32)
    li = torch.searchsorted(torch.cumsum(valid_i, 0), rank + 1)
    li = torch.clamp(li, 0, lights.position.shape[0] - 1)
    sp = m.noz(normal)
    lp = lights.position[li] + sp * s.point_light_radius
    to_l = lp - p
    dist = torch.clamp(torch.linalg.norm(to_l, dim=-1), min=1e-5)
    l_pt = to_l / dist[:, None]
    rel = torch.clamp(dist / torch.clamp(lights.radius[li], min=1e-5),
                      max=1.0)
    dd = dist / torch.clamp(1.0 - rel * rel, min=1e-6)
    att = 1.0 / (dd * dd + 1.0)
    # Solid angle of the emitter sphere, halved: a full-sphere surface
    # sample maps two points to each cap direction.
    sz = torch.clamp(s.point_light_radius / dist, max=1.0)
    omega = 2.0 * math.pi * (1.0 - torch.sqrt(torch.clamp(1 - sz * sz,
                                                         min=0.0)))
    pdf_l = 1.0 / torch.clamp(0.5 * omega * ctx.light_count, min=1e-8)
    return li, l_pt, dist, att, pdf_l


def _hit_rows(ctx, res):
    scene = ctx.scene
    return bvh_mod.hit_attributes_shaded(scene.bvh, scene.materials, res,
                                         table=ctx.table)


def shade_hit_plain(ctx: ShadeContext, res, o, d, alive, throughput,
                    radiance, draws: pt_shade.BounceDraws, counts,
                    first: bool) -> pt_shade.HitShading:
    """`pt_shade.shade_hit` as tensor code, for rays off the card.  At the
    first bounce `alive`, `throughput` and `radiance` are not read (every
    ray alive, throughput 1, radiance 0) and every ray counts as traced."""
    r = o.shape[0]
    if first:
        alive = torch.ones((r,), dtype=torch.bool, device=o.device)
        throughput = torch.ones((r, 3), device=o.device)
        radiance = torch.zeros((r, 3), device=o.device)
        counts[0] += r
    hit = res["hit"] & alive
    radiance = radiance + _where3(alive & ~res["hit"],
                                  throughput * sky_radiance(ctx.scene.sky, d))
    n, gn, _, _, _, _, _, emissive = _hit_rows(ctx, res)
    # Two-sided shading: the geometric normal faces the ray, the
    # interpolated normal follows it.
    gn = _where3(torch.sum(gn * d, -1) > 0, -gn, gn)
    n = _where3(torch.sum(n * gn, -1) < 0, -n, n)
    p = o + d * res["t"][:, None] + gn * 1e-3
    radiance = radiance + _where3(hit, throughput * emissive)
    out = pt_shade.HitShading(radiance, n, p)
    if draws.sun is not None:
        l_sun = sun_direction(ctx.scene.sky, *draws.sun).expand(r, 3)
        need_sun = hit & (torch.sum(n * l_sun, -1) > 0)
        out.sun_dir, out.sun_t_max = l_sun, torch.where(need_sun, T_FAR, 0.0)
        counts[0] += need_sun.sum()
    if draws.light is not None:
        li, l_pt, dist, _, _ = _light_sample_plain(ctx, draws, p)
        need_pt = hit & (torch.sum(n * l_pt, -1) > 0) & ctx.lights.valid[li]
        out.light_dir = l_pt
        out.light_t_max = torch.where(
            need_pt, torch.clamp(dist - 1e-3, min=1e-4), 0.0)
        counts[0] += need_pt.sum()
    return out


def shade_next_plain(ctx: ShadeContext, res, d, alive, throughput,
                     hs: pt_shade.HitShading, sun_shadowed, light_shadowed,
                     draws: pt_shade.BounceDraws, counts, first: bool,
                     live_slot: int):
    """`pt_shade.shade_next` as tensor code: (radiance, throughput, alive,
    next direction, next t_max), the last four None at the last bounce (no
    BRDF draws)."""
    r = d.shape[0]
    if first:
        alive = torch.ones((r,), dtype=torch.bool, device=d.device)
        throughput = torch.ones((r, 3), device=d.device)
    s = ctx.settings
    hit = res["hit"] & alive
    n, v, radiance = hs.normal, -d, hs.radiance
    _, _, _, _, albedo, rough, metal, _ = _hit_rows(ctx, res)
    if draws.sun is not None:                 # sun NEE + MIS
        l_sun = hs.sun_dir
        facing = torch.sum(n * l_sun, -1) > 0
        f, pdf_b = eval_brdf(n, v, l_sun, albedo, rough, metal)
        w_mis = (SUN_PDF / (SUN_PDF + pdf_b)
                 if s.multiple_importance_sampling else torch.ones_like(pdf_b))
        contrib = (throughput * f * ctx.scene.sky.sun_radiance
                   * (w_mis / SUN_PDF)[:, None] * s.light_intensity_scale)
        radiance = radiance + _where3(hit & facing & ~sun_shadowed, contrib)
    if draws.light is not None:               # one random point light
        lights = ctx.lights
        li, l_pt, _, att, pdf_l = _light_sample_plain(ctx, draws, hs.point)
        facing_pt = torch.sum(n * l_pt, -1) > 0
        f_pt, pdf_b_pt = eval_brdf(n, v, l_pt, albedo, rough, metal)
        w_mis_pt = (pdf_l / (pdf_l + pdf_b_pt)
                    if s.multiple_importance_sampling
                    else torch.ones_like(pdf_l))
        contrib_pt = (throughput * f_pt * lights.color[li]
                      * (att * w_mis_pt / pdf_l)[:, None]
                      * s.light_intensity_scale)
        ok_pt = hit & facing_pt & ~light_shadowed & lights.valid[li]
        radiance = radiance + _where3(ok_pt, contrib_pt)
    if draws.brdf is None:
        return radiance, None, None, None, None
    l, w, _ = brdf_sample(*draws.brdf, n, v, albedo, rough, metal)
    throughput = throughput * w
    alive = hit & (w.max(-1).values > 0)
    if draws.roulette is not None:
        q = torch.clamp(throughput.max(-1).values, 0.05, 1.0)
        survive = draws.roulette < q
        throughput = throughput / q[:, None]
        alive = alive & survive
    live = alive.sum()
    counts[0] += live
    counts[live_slot] += live
    return radiance, throughput, alive, l, torch.where(alive, T_FAR, 0.0)


def shaders(device: torch.device):
    """The two halves of a bounce's shading for rays on `device`: the
    kernels (`pt_shade.shade_hit` / `shade_next`) on the card, the plain
    versions elsewhere."""
    if device.type == "cuda":
        return pt_shade.shade_hit, pt_shade.shade_next
    return shade_hit_plain, shade_next_plain


def trace_sample(scene: Scene, settings: PathTracerSettings, origin,
                 direction, sampler, error=None):
    """One radiance sample per ray; origin/direction (R, 3).  Returns
    (radiance (R, 3), rays_traced): the useful rays the sample dispatched
    (alive closest-hit rays and unmasked shadow rays), an int64 count on the
    device.  Dead rows and masked shadow rows get t_max = 0, which the ray
    kernels skip.  Bounce rays (bounce > 0) are regrouped inside each ray
    query, as JAX's Pallas backend does it; an exact permutation.  The ray
    kernels OR their error bits into `error`, which the caller reads
    (`ray_trace.raise_on_error`); without one, a word of the sample's own
    is read once, at the end.

    Each bounce draws its random numbers first (`draw_bounce`, in the order
    and shapes the eager shading drew them), then shades in two halves
    around its shadow queries (`shaders`): shade_hit, the sun's and point
    light's shadow queries, shade_next.  On the card each half is one
    kernel (`ops/pt_shade.py`), which adds the rays it asks for into the
    sample's int64 counter; off the card `shade_hit_plain` /
    `shade_next_plain` run the same arithmetic as tensor ops.

    Spans (`core/profiling.py`): per bounce a `pt.bounce` (attribute
    `bounce`) around the closest-hit query's `ray.trace` and `pt.shade`,
    device-timed: the rest of the bounce, the shadow queries' `ray.trace`
    inside it.  Counters: `pt.rows` and `pt.live_rows`, the rows of the
    bounce queries after the first and the alive ones among them;
    `pt.bounces`, one per bounce shaded, beside `pt_shade.shade_next`'s
    `pt.shade_fused`, one per bounce its kernel shaded (equal on the card,
    never recorded off it)."""
    r = origin.shape[0]
    dev = origin.device
    on_card = dev.type == "cuda"
    read_error = error is None
    if read_error:
        error = ray_trace.new_error_word(dev)
    ctx = shading_context(scene, settings)
    shade_hit, shade_next = shaders(dev)
    depth = settings.recursion_depth
    # [0] the rays traced, [b] the live rows of bounce b's query (b >= 1).
    counts = torch.zeros((depth + 1,), dtype=torch.int64, device=dev)
    # Not read at bounce 0: every ray alive, throughput 1, radiance 0.
    radiance = torch.empty((r, 3), device=dev)
    throughput = torch.empty((r, 3), device=dev)
    alive = torch.empty((r,), dtype=torch.bool, device=dev)
    o, d, t_cap = origin, direction, 1e30

    for bounce in range(depth + 1):
        first = bounce == 0
        with profiling.profile_block("pt.bounce", attrs={"bounce": bounce}):
            res = bvh_mod.closest_hit(scene.bvh, o, d, t_max=t_cap,
                                      regroup=not first, error=error)
            with profiling.profile_block("pt.shade", device=on_card):
                profiling.profile_stat("pt.bounces", 1)
                if not first:
                    profiling.profile_stat("pt.rows", r)
                    profiling.profile_stat("pt.live_rows", counts[bounce])
                draws = draw_bounce(sampler, ctx, r, bounce)
                hs = shade_hit(ctx, res, o, d, alive, throughput, radiance,
                               draws, counts, first)
                sun_hit = light_hit = None
                if hs.sun_dir is not None:
                    sun_hit = bvh_mod.any_hit(
                        scene.bvh, hs.point, hs.sun_dir, t_max=hs.sun_t_max,
                        regroup=not first, error=error)
                if hs.light_dir is not None:
                    light_hit = bvh_mod.any_hit(
                        scene.bvh, hs.point, hs.light_dir,
                        t_max=hs.light_t_max, regroup=not first, error=error)
                radiance, throughput, alive, d, t_cap = shade_next(
                    ctx, res, d, alive, throughput, hs, sun_hit, light_hit,
                    draws, counts, first, bounce + 1)
                o = hs.point
    if read_error:
        ray_trace.raise_on_error(error)
    return radiance, counts[0]


def _tile_perm(width: int, height: int, tile: int = 32):
    """Pixel-major -> tile-major permutation (and its inverse): 32x32-pixel
    tiles keep neighbouring rays of the wavefront on nearby geometry.  A
    host lexsort over every pixel (~0.2 s at 1080p): `_tile_order` keeps it
    on the device once per size."""
    ys, xs = np.mgrid[0:height, 0:width]
    tiles_x = -(-width // tile)
    tile_id = (ys // tile) * tiles_x + (xs // tile)
    perm = np.lexsort((xs.ravel(), ys.ravel(), tile_id.ravel()))
    return perm, np.argsort(perm)


@functools.lru_cache(maxsize=8)
def _tile_order(width: int, height: int, device: torch.device):
    return tuple(torch.as_tensor(x, device=device)
                 for x in _tile_perm(width, height))


def render(scene: Scene, camera: Camera, width: int, height: int,
           settings: PathTracerSettings = PathTracerSettings(),
           spp: int = 1, sampler: Optional[Sampler] = None):
    """(H, W, 3) linear radiance averaged over `spp` samples per pixel, and
    the rays traced (int64, on the device).  Rays are traced in 32x32 tile
    order.  Progressive accumulation = averaging calls with other draws.
    The ray kernels' error word is read once, at the end (a host sync).

    Spans (`core/profiling.py`): `pt.frame`, one per call, holding per
    sample `pt.camera` (the rays and their tile order), `trace_sample`'s
    `pt.bounce`s and `pt.accumulate`, then `pt.sync`, the error word's
    read: the host waiting for the card."""
    dev = camera.position.device
    if sampler is None:
        sampler = Sampler(torch.Generator(device=dev).manual_seed(0))
    with profiling.profile_block("pt.frame"):
        perm, inv = _tile_order(width, height, dev)
        f_num = settings.f_number if settings.use_thin_lens else 0.0
        img = torch.zeros((height * width, 3), device=dev)
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        error = ray_trace.new_error_word(dev)
        for _ in range(spp):
            with profiling.profile_block("pt.camera"):
                o, d = generate_rays(camera, width, height, sampler,
                                     f_number=f_num,
                                     focal_length=settings.focal_length)
                o, d = o[perm], d[perm]
            rad, n = trace_sample(scene, settings, o, d, sampler, error)
            with profiling.profile_block("pt.accumulate"):
                img = img + rad[inv]
                rays = rays + n
        with profiling.profile_block("pt.sync"):
            ray_trace.raise_on_error(error)
    return (img / spp).reshape(height, width, 3), rays


def tonemap_filmic(x):
    """ACES-style filmic curve."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = torch.clamp(x, min=0.0)
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def to_srgb_u8(img):
    img = tonemap_filmic(img)
    img = torch.where(img <= 0.0031308, img * 12.92,
                      1.055 * img ** (1 / 2.4) - 0.055)
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
