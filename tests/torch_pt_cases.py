"""Small path-tracing scenes, one per feature the path tracer's shading has,
and its eager shading as it was before `ops/pt_shade.py` (the oracle the
factored plain version is held to, bit for bit).  Imports no JAX: the card
tests use it too.

Cases: the gradient sky; Preetham's sky; a cubemap sky; a texture atlas;
point lights (one of them invalid); MIS off; direct lighting off; depth 4,
where the roulette runs at the last bounce's predecessor.  The scene has
more than one 1024-row chunk, so bounce queries are regrouped.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from d3d12renderer_tpu_torch.core import maths as m
from d3d12renderer_tpu_torch.ops import ray_trace
from d3d12renderer_tpu_torch.render import bvh as bvh_mod
from d3d12renderer_tpu_torch.render import camera as cam_mod
from d3d12renderer_tpu_torch.render import mesh
from d3d12renderer_tpu_torch.render import pathtracer as pt
from d3d12renderer_tpu_torch.render.lights import PointLights

CASES = ("gradient", "preetham", "cubemap", "atlas", "point_lights",
         "mis_off", "direct_off", "roulette")
W, H = 24, 16


def _meshes():
    return [
        (mesh.quad(half=6.0), 0),
        (mesh.ico_sphere(1.0, 3).transformed(translate=(0.0, 1.0, 0.0)), 1),
        (mesh.box((0.6, 0.6, 0.6)).transformed(
            translate=(1.8, 0.6, -0.4),
            rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3))), 2),
        (mesh.torus(0.7, 0.25).transformed(translate=(-1.6, 0.25, 0.8)), 3),
    ]


def case_settings(case) -> pt.PathTracerSettings:
    if case == "mis_off":
        return pt.PathTracerSettings(multiple_importance_sampling=False)
    if case == "direct_off":
        return pt.PathTracerSettings(enable_direct_lighting=False)
    if case == "roulette":
        return pt.PathTracerSettings(recursion_depth=4)
    return pt.PathTracerSettings()


def case_scene(case, device, generator_seed: int = 3) -> pt.Scene:
    """The case's scene on `device`, its tables built
    (`with_shading_table`); textures and lights from a seeded generator."""
    g = torch.Generator().manual_seed(generator_seed)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    mats = pt.Materials(
        albedo=f32([[0.45, 0.45, 0.45], [0.75, 0.15, 0.12],
                    [0.95, 0.93, 0.88], [0.2, 0.7, 0.3]]),
        emissive=f32([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.6, 0.3, 0.1]]),
        roughness=f32([0.7, 0.35, 0.12, 0.5]),
        metallic=f32([0.0, 0.0, 1.0, 0.0]))
    if case == "atlas":
        mats = replace(mats, texture_atlas=(
            0.2 + 0.8 * torch.rand((2, 8, 8, 3), generator=g)).to(device),
            albedo_texture=torch.tensor([0, -1, 1, -1], dtype=torch.int32,
                                        device=device))
    sky = pt.default_sky(device=device)
    if case == "preetham":
        sky = pt.preetham_sky(device=device)
    if case == "cubemap":
        sky = replace(sky, cubemap=(
            2.0 * torch.rand((6, 8, 8, 3), generator=g)).to(device))
    lights = None
    if case in ("point_lights", "mis_off"):
        lights = PointLights(
            position=f32([[-1.0, 2.5, 2.0], [2.8, 2.0, 1.5], [0.0, 3.0, 0.0]]),
            color=f32([[900.0, 700.0, 400.0], [200.0, 400.0, 900.0],
                       [500.0, 500.0, 500.0]]),
            radius=f32([18.0, 6.0, 9.0]),
            valid=torch.tensor([True, False, True], device=device))
    return pt.Scene(bvh=bvh_mod.build_bvh(_meshes(), device=device),
                    materials=mats, sky=sky,
                    point_lights=lights).with_shading_table()


def case_rays(device, width: int = W, height: int = H):
    """The case camera's primary rays (no jitter), in tile order."""
    cam = cam_mod.look_at((5.0, 3.0, 6.0), (0.0, 0.8, 0.0), device=device,
                          v_fov=math.radians(50), aspect=width / height)
    o, d = cam_mod.generate_rays(cam, width, height)
    perm = torch.as_tensor(pt._tile_perm(width, height)[0], device=device)
    return o[perm].contiguous(), d[perm].contiguous()


class RecordingSampler:
    """Wraps a sampler and keeps each call's kind and shape, in order."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def uniform(self, shape):
        self.calls.append(("uniform", tuple(shape)))
        return self.inner.uniform(shape)

    def normal(self, shape):
        self.calls.append(("normal", tuple(shape)))
        return self.inner.normal(shape)

    def randint(self, shape, high):
        self.calls.append(("randint", tuple(shape)))
        return self.inner.randint(shape, high)


# --------------------------------------------------------------------------
# The eager shading before ops/pt_shade.py, as render/pathtracer.py had it
# --------------------------------------------------------------------------

def _perez(theta_cos, gamma, gamma_cos, coeff):
    a, b, c, e, f = coeff
    return ((1.0 + a * torch.exp(b / torch.clamp(theta_cos, min=0.01)))
            * (1.0 + c * torch.exp(e * gamma) + f * gamma_cos ** 2))


def _preetham_radiance(sun_dir, turbidity, scale, d):
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
    dev = d.device
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

    cos_t = torch.clamp(d[..., 1], 0.01, 1.0)
    cos_g = torch.clamp(torch.sum(d * sun_dir, -1), -1.0, 1.0)
    gamma = torch.acos(cos_g)

    def ratio(coeff, zen):
        return zen * (_perez(cos_t, gamma, cos_g, coeff)
                      / _perez(torch.ones_like(theta_s), theta_s, cos_ts,
                               coeff))

    lum = ratio(cy, yz) * scale
    x = ratio(cx, xz)
    y = ratio(cyy, yyz)
    ys = torch.clamp(y, min=1e-4)
    xyz = torch.stack([x * lum / ys, lum, (1.0 - x - ys) * lum / ys], -1)
    mat = torch.tensor([[3.2406, -1.5372, -0.4986],
                        [-0.9689, 1.8758, 0.0415],
                        [0.0557, -0.2040, 1.0570]], device=dev)
    return torch.clamp(xyz @ mat.T, min=0.0)


def sky_radiance(sky, d):
    cos_sun = torch.sum(d * sky.sun_direction, -1, keepdim=True)
    sun = torch.where(cos_sun > 0.9995, sky.sun_radiance, 0.0)
    if sky.cubemap is not None:
        return pt.sample_cubemap(sky.cubemap, d) + sun
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


def sample_brdf(sampler, n, v, albedo, roughness, metallic):
    r = n.shape[0]
    u1 = sampler.uniform((r,))
    u2 = sampler.uniform((r,))
    pick_spec = sampler.uniform((r,)) < 0.5
    t1, t2 = m.orthonormal_basis(n)
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    rad = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    ld = (t1 * (rad * torch.cos(phi))[:, None]
          + t2 * (rad * torch.sin(phi))[:, None]
          + n * torch.sqrt(torch.clamp(1 - u1, min=0.0))[:, None])
    cos_t = torch.sqrt((1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    h = (t1 * (sin_t * torch.cos(phi))[:, None]
         + t2 * (sin_t * torch.sin(phi))[:, None]
         + n * cos_t[:, None])
    ls = 2.0 * torch.sum(v * h, -1, keepdim=True) * h - v
    l = m.noz(torch.where(pick_spec[:, None], ls, ld))
    f, pdf = pt.eval_brdf(n, v, l, albedo, roughness, metallic)
    w = torch.where((pdf > 1e-8)[:, None],
                    f / torch.clamp(pdf, min=1e-8)[:, None], 0.0)
    valid = torch.sum(l * n, -1) > 0
    return l, torch.where(valid[:, None], w, 0.0), pdf


SUN_COS_CONE = 0.9995
SUN_PDF = 1.0 / (2.0 * math.pi * (1.0 - SUN_COS_CONE))


def _sample_sun(sampler, sky):
    u1 = sampler.uniform(())
    u2 = sampler.uniform(())
    cos_t = 1.0 - u1 * (1.0 - SUN_COS_CONE)
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0.0))
    phi = 2 * math.pi * u2
    t1, t2 = m.orthonormal_basis(sky.sun_direction)
    return (t1 * sin_t * torch.cos(phi) + t2 * sin_t * torch.sin(phi)
            + sky.sun_direction * cos_t)


def _where3(mask, a, b=0.0):
    return torch.where(mask[:, None], a, b)


def eager_trace_sample(scene, settings, origin, direction, sampler,
                       error=None):
    """`trace_sample` with its eager shading, as it was."""
    r = origin.shape[0]
    dev = origin.device
    radiance = torch.zeros((r, 3), device=dev)
    throughput = torch.ones((r, 3), device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    read_error = error is None
    if read_error:
        error = ray_trace.new_error_word(dev)
    o, d = origin, direction
    lights = scene.point_lights if settings.enable_direct_lighting else None

    for bounce in range(settings.recursion_depth + 1):
        regroup = bounce > 0
        t_cap = 1e30 if bounce == 0 else torch.where(alive, 1e30, 0.0)
        res = bvh_mod.closest_hit(scene.bvh, o, d, t_max=t_cap,
                                  regroup=regroup, error=error)
        hit = res["hit"] & alive
        if bounce == 0:
            rays_traced = rays_traced + r
        else:
            rays_traced = rays_traced + alive.sum()

        radiance = radiance + _where3(alive & ~res["hit"],
                                      throughput * sky_radiance(scene.sky, d))
        n, gn, uv, mat, albedo, rough, metal, emissive = \
            bvh_mod.hit_attributes_shaded(scene.bvh, scene.materials, res,
                                          table=scene.attr_table)
        gn = _where3(torch.sum(gn * d, -1) > 0, -gn, gn)
        n = _where3(torch.sum(n * gn, -1) < 0, -n, n)
        p = o + d * res["t"][:, None] + gn * 1e-3
        v = -d
        radiance = radiance + _where3(hit, throughput * emissive)

        if settings.enable_direct_lighting:
            l_sun = _sample_sun(sampler, scene.sky).expand(r, 3)
            facing = torch.sum(n * l_sun, -1) > 0
            need_sun = hit & facing
            shadowed = bvh_mod.any_hit(
                scene.bvh, p, l_sun, t_max=torch.where(need_sun, 1e30, 0.0),
                regroup=regroup, error=error)
            rays_traced = rays_traced + need_sun.sum()
            f, pdf_b = pt.eval_brdf(n, v, l_sun, albedo, rough, metal)
            w_mis = (SUN_PDF / (SUN_PDF + pdf_b)
                     if settings.multiple_importance_sampling
                     else torch.ones_like(pdf_b))
            contrib = (throughput * f * scene.sky.sun_radiance
                       * (w_mis / SUN_PDF)[:, None]
                       * settings.light_intensity_scale)
            radiance = radiance + _where3(hit & facing & ~shadowed, contrib)

        if lights is not None:
            nl = lights.position.shape[0]
            valid_i = lights.valid.to(torch.int32)
            n_valid = torch.clamp(valid_i.sum(), min=1)
            rank = sampler.randint((r,), n_valid)
            li = torch.searchsorted(torch.cumsum(valid_i, 0), rank + 1)
            li = torch.clamp(li, 0, nl - 1)
            sp = m.noz(sampler.normal((r, 3)))
            lp = lights.position[li] + sp * settings.point_light_radius
            to_l = lp - p
            dist = torch.clamp(torch.linalg.norm(to_l, dim=-1), min=1e-5)
            l_pt = to_l / dist[:, None]
            rel = torch.clamp(
                dist / torch.clamp(lights.radius[li], min=1e-5), max=1.0)
            dd = dist / torch.clamp(1.0 - rel * rel, min=1e-6)
            att = 1.0 / (dd * dd + 1.0)
            s = torch.clamp(settings.point_light_radius / dist, max=1.0)
            omega = 2.0 * math.pi * (1.0 - torch.sqrt(
                torch.clamp(1 - s * s, min=0.0)))
            pdf_l = 1.0 / torch.clamp(0.5 * omega * n_valid, min=1e-8)
            facing_pt = torch.sum(n * l_pt, -1) > 0
            need_pt = hit & facing_pt & lights.valid[li]
            shadowed_pt = bvh_mod.any_hit(
                scene.bvh, p, l_pt,
                t_max=torch.where(
                    need_pt, torch.clamp(dist - 1e-3, min=1e-4), 0.0),
                regroup=regroup, error=error)
            rays_traced = rays_traced + need_pt.sum()
            f_pt, pdf_b_pt = pt.eval_brdf(n, v, l_pt, albedo, rough, metal)
            w_mis_pt = (pdf_l / (pdf_l + pdf_b_pt)
                        if settings.multiple_importance_sampling
                        else torch.ones_like(pdf_l))
            contrib_pt = (throughput * f_pt * lights.color[li]
                          * (att * w_mis_pt / pdf_l)[:, None]
                          * settings.light_intensity_scale)
            ok_pt = hit & facing_pt & ~shadowed_pt & lights.valid[li]
            radiance = radiance + _where3(ok_pt, contrib_pt)

        if bounce == settings.recursion_depth:
            break

        l, w, _ = sample_brdf(sampler, n, v, albedo, rough, metal)
        throughput = throughput * w
        alive = hit & (w.max(-1).values > 0)
        o, d = p, l

        if bounce >= settings.start_russian_roulette_after:
            q = torch.clamp(throughput.max(-1).values, 0.05, 1.0)
            survive = sampler.uniform((r,)) < q
            throughput = throughput / q[:, None]
            alive = alive & survive
    if read_error:
        ray_trace.raise_on_error(error)
    return radiance, rays_traced
