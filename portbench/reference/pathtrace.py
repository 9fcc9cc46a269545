"""The path-traced frame's check: a sample of the frame's pixels traced
again by a plain reference, with the frame's own random numbers, against
the program's radiance.  The reference imports nothing of the program.

The scene is rebuilt from its description (the atrium's meshes, the six
materials and the gradient sky of the configuration file), the rays are
intersected with every triangle by the Moller-Trumbore test (no tree), and
the shading follows the path tracer's published rules: two-sided normals,
sky radiance on a miss, sun next-event estimation with a shadow ray and
MIS against the BRDF's pdf, Cook-Torrance GGX + Lambert, the mixed-lobe
BRDF sample.  The random numbers are replayed from the frame's generator
state in the order and shapes the frame draws them: the camera jitter
(H, W, 2), then per bounce the sun cone's two scalars and, before the last
bounce, the BRDF's (R,) u1, u2 and lobe pick, R rays in 32x32-tile order.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from .frozen.core import maths as m
from .frozen.render.camera import generate_rays, look_at
from .frozen.render.mesh import atrium_scene

SUN_COS_CONE = 0.9995
SUN_PDF = 1.0 / (2.0 * math.pi * (1.0 - SUN_COS_CONE))
T_MIN = 1e-4
# Rays intersected with every triangle at once.
RAY_BLOCK = 32


def tile_order(width: int, height: int, tile: int = 32):
    """Pixel-major -> 32x32-tile-major permutation and its inverse."""
    ys, xs = np.mgrid[0:height, 0:width]
    tiles_x = -(-width // tile)
    tile_id = (ys // tile) * tiles_x + (xs // tile)
    perm = np.lexsort((xs.ravel(), ys.ravel(), tile_id.ravel()))
    return perm, np.argsort(perm)


class Atrium:
    """The atrium's triangles, materials, sky and camera on `device`."""

    def __init__(self, config: dict, device):
        scene = config["scene"]
        meshes = atrium_scene(scene["detail"])
        parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0",
                                 "uv1", "uv2", "mat")}
        for mesh, mat in meshes:
            p = mesh.positions.astype(np.float64)
            idx = mesh.indices
            v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
            parts["v0"].append(v0)
            parts["e1"].append(v1 - v0)
            parts["e2"].append(v2 - v0)
            for k in range(3):
                parts[f"n{k}"].append(mesh.normals[idx[:, k]])
                parts[f"uv{k}"].append(mesh.uvs[idx[:, k]])
            parts["mat"].append(np.full(len(idx), mat, np.int64))

        def put(x, dtype=torch.float32):
            return torch.as_tensor(np.concatenate(x), device=device).to(dtype)

        self.tri = {k: put(v) for k, v in parts.items() if k != "mat"}
        self.mat = put(parts["mat"], torch.int64)
        self.num_tris = int(self.mat.shape[0])
        mats = scene["materials"]

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.albedo = f32(mats["albedo"])
        self.roughness = f32(mats["roughness"])
        self.metallic = f32(mats["metallic"])
        self.emissive = torch.zeros_like(self.albedo)
        sky = scene["sky"]
        sun = np.asarray(sky["sun_direction"], np.float64)
        self.sun_direction = f32((sun / np.linalg.norm(sun)).astype(np.float32))
        self.sun_radiance = f32(sky["sun_radiance"])
        self.zenith = f32(sky["zenith"])
        self.horizon = f32(sky["horizon"])
        self.ground = f32(sky["ground"])
        cam = scene["camera"]
        self.width, self.height = config["width"], config["height"]
        self.camera = look_at(tuple(cam["eye"]), tuple(cam["target"]),
                              device=device,
                              v_fov=math.radians(cam["v_fov_deg"]),
                              aspect=self.width / self.height)
        self.depth = config["path_tracer"]["depth"]
        perm, inv = tile_order(self.width, self.height)
        self.perm = torch.as_tensor(perm, device=device)
        self.inv = torch.as_tensor(inv, device=device)

    @property
    def tri_v0(self):
        return self.tri["v0"]

    @property
    def tri_e1(self):
        return self.tri["e1"]

    @property
    def tri_e2(self):
        return self.tri["e2"]

    @property
    def tri_valid(self):
        return torch.ones(self.num_tris, dtype=torch.bool,
                          device=self.mat.device)

    def lowered(self, dtype):
        """Every float table of the scene in `dtype` (the control)."""
        for name in ("albedo", "roughness", "metallic", "emissive",
                     "sun_direction", "sun_radiance", "zenith", "horizon",
                     "ground"):
            setattr(self, name, getattr(self, name).to(dtype))
        self.tri = {k: v.to(dtype) for k, v in self.tri.items()}
        return self


def _intersect(scene: Atrium, o, d, t_max):
    """Closest hit of each ray over every triangle: (t, tri (-1 = miss),
    u, v); accepted where u, v >= 0, u + v <= 1 and T_MIN <= t <= t_max."""
    v0, e1, e2 = scene.tri["v0"], scene.tri["e1"], scene.tri["e2"]
    ts, tris, us, vs = [], [], [], []
    for r0 in range(0, o.shape[0], RAY_BLOCK):
        ob, db = o[r0:r0 + RAY_BLOCK, None, :], d[r0:r0 + RAY_BLOCK, None, :]
        tm = t_max[r0:r0 + RAY_BLOCK, None]
        pvec = torch.linalg.cross(db.expand(-1, e2.shape[0], -1),
                                  e2[None].expand(ob.shape[0], -1, -1))
        det = torch.sum(e1[None] * pvec, -1)
        inv = 1.0 / det
        tvec = ob - v0[None]
        u = torch.sum(tvec * pvec, -1) * inv
        qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
        v = torch.sum(db * qvec, -1) * inv
        t = torch.sum(e2[None] * qvec, -1) * inv
        ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t >= T_MIN) & (t <= tm)
              & torch.isfinite(t))
        t = torch.where(ok, t, torch.inf)
        best = torch.argmin(t, dim=1)
        tb = t.gather(1, best[:, None])[:, 0]
        hit = torch.isfinite(tb)
        ts.append(torch.where(hit, tb, t_max[r0:r0 + RAY_BLOCK]))
        tris.append(torch.where(hit, best, -1))
        us.append(torch.where(hit, u.gather(1, best[:, None])[:, 0], 0.0))
        vs.append(torch.where(hit, v.gather(1, best[:, None])[:, 0], 0.0))
    return torch.cat(ts), torch.cat(tris), torch.cat(us), torch.cat(vs)


def _sky(scene: Atrium, d):
    cos_sun = torch.sum(d * scene.sun_direction, -1, keepdim=True)
    sun = torch.where(cos_sun > SUN_COS_CONE, scene.sun_radiance, 0.0)
    y = d[..., 1:2]
    t = torch.clamp(y, 0.0, 1.0) ** 0.6
    col = scene.horizon * (1 - t) + scene.zenith * t
    col = torch.where(y < 0, scene.ground, col)
    return col + sun


def _brdf(n, v, l, albedo, roughness, metallic):
    """Cook-Torrance GGX specular + Lambert diffuse: (f, mixed pdf)."""
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    h = m.noz(v + l)
    n_dot_v = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    n_dot_l = torch.clamp(torch.sum(n * l, -1), min=0.0)
    n_dot_h = torch.clamp(torch.sum(n * h, -1), 0.0, 1.0)
    v_dot_h = torch.clamp(torch.sum(v * h, -1), min=1e-4)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    fres = f0 + (1.0 - f0) * torch.clamp(1.0 - v_dot_h, 0.0, 1.0)[..., None] ** 5
    a2 = alpha * alpha
    dd = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    ggx = a2 / torch.clamp(math.pi * dd * dd, min=1e-8)
    k = alpha * alpha / 2.0
    g = (n_dot_v / torch.clamp(n_dot_v * (1 - k) + k, min=1e-8)) * (
        n_dot_l / torch.clamp(n_dot_l * (1 - k) + k, min=1e-8))
    spec = fres * (ggx * g / torch.clamp(4.0 * n_dot_v * n_dot_l,
                                        min=1e-8))[..., None]
    diff = albedo * (1.0 - metallic[..., None]) * (1.0 - fres) / math.pi
    f = (diff + spec) * n_dot_l[..., None]
    pdf = 0.5 * (n_dot_l / math.pi) + 0.5 * (
        ggx * n_dot_h / torch.clamp(4.0 * v_dot_h, min=1e-8))
    return f, pdf


def _sample_brdf(u1, u2, pick, n, v, albedo, roughness, metallic):
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
         + t2 * (sin_t * torch.sin(phi))[:, None] + n * cos_t[:, None])
    ls = 2.0 * torch.sum(v * h, -1, keepdim=True) * h - v
    l = m.noz(torch.where((pick < 0.5)[:, None], ls, ld))
    f, pdf = _brdf(n, v, l, albedo, roughness, metallic)
    w = torch.where((pdf > 1e-8)[:, None],
                    f / torch.clamp(pdf, min=1e-8)[:, None], 0.0)
    return l, torch.where((torch.sum(l * n, -1) > 0)[:, None], w, 0.0)


def _sun_dir(scene: Atrium, u1, u2):
    cos_t = 1.0 - u1 * (1.0 - SUN_COS_CONE)
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0.0))
    phi = 2 * math.pi * u2
    t1, t2 = m.orthonormal_basis(scene.sun_direction)
    return (t1 * sin_t * torch.cos(phi) + t2 * sin_t * torch.sin(phi)
            + scene.sun_direction * cos_t)


class _Replay:
    """The frame's uniform draws, from its generator state, full size."""

    def __init__(self, state, device):
        self.g = torch.Generator(device=device)
        self.g.set_state(state)
        self.device = device

    def uniform(self, shape):
        return torch.rand(shape, generator=self.g, device=self.device)


@contextmanager
def _default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def radiance(scene: Atrium, generator_state, pixels, dtype=torch.float32,
             counts=None):
    """(len(pixels), 3) radiance of the pixel-major `pixels` of one frame
    at one sample, from the frame's generator state, in `dtype`.  Where
    `counts` is given, its "rays" grows by the rays these pixels' paths
    trace: every live path's closest-hit ray and every shadow ray towards
    the sun from a lit side."""
    dev = pixels.device
    w, h = scene.width, scene.height
    r = w * h
    draws = _Replay(generator_state, dev)
    rows = scene.inv[pixels]
    with torch.no_grad(), _default_dtype(dtype):
        o_all, d_all = generate_rays(scene.camera, w, h, draws)
        o, d = o_all[pixels].to(dtype), d_all[pixels].to(dtype)
        n_px = pixels.shape[0]
        rad = torch.zeros((n_px, 3), dtype=dtype, device=dev)
        thr = torch.ones((n_px, 3), dtype=dtype, device=dev)
        alive = torch.ones(n_px, dtype=torch.bool, device=dev)
        for bounce in range(scene.depth + 1):
            t_cap = torch.where(alive, 1e30, 0.0).to(dtype)
            t, tri, u, v = _intersect(scene, o, d, t_cap)
            traced = alive.sum()
            hit = (tri >= 0) & alive
            rad = rad + torch.where((alive & ~hit)[:, None],
                                    thr * _sky(scene, d), 0.0)
            ti = torch.clamp(tri, min=0)
            wgt = (1.0 - u - v)[:, None]
            tr = scene.tri
            n = m.noz(wgt * tr["n0"][ti] + u[:, None] * tr["n1"][ti]
                      + v[:, None] * tr["n2"][ti])
            gn = m.noz(torch.linalg.cross(tr["e1"][ti], tr["e2"][ti]))
            gn = torch.where((torch.sum(gn * d, -1) > 0)[:, None], -gn, gn)
            n = torch.where((torch.sum(n * gn, -1) < 0)[:, None], -n, n)
            mat = scene.mat[ti]
            albedo, rough = scene.albedo[mat], scene.roughness[mat]
            metal = scene.metallic[mat]
            p = o + d * t[:, None] + gn * 1e-3
            view = -d
            rad = rad + torch.where(hit[:, None], thr * scene.emissive[mat],
                                    0.0)
            # Sun NEE with MIS: one direction in the cone for the frame.
            l_sun = _sun_dir(scene, draws.uniform(()).to(dtype),
                             draws.uniform(()).to(dtype)).expand(n_px, 3)
            facing = torch.sum(n * l_sun, -1) > 0
            need = hit & facing
            traced = traced + need.sum()
            if counts is not None:
                counts["rays"] = counts.get("rays", 0) + int(traced)
            t_s, tri_s, _, _ = _intersect(
                scene, p, l_sun, torch.where(need, 1e30, 0.0).to(dtype))
            shadowed = tri_s >= 0
            f, pdf_b = _brdf(n, view, l_sun, albedo, rough, metal)
            w_mis = SUN_PDF / (SUN_PDF + pdf_b)
            contrib = thr * f * scene.sun_radiance * (w_mis / SUN_PDF)[:, None]
            rad = rad + torch.where((need & ~shadowed)[:, None], contrib, 0.0)
            if bounce == scene.depth:
                break
            u1, u2, pick = (draws.uniform((r,))[rows].to(dtype)
                            for _ in range(3))
            l, wb = _sample_brdf(u1, u2, pick, n, view, albedo, rough, metal)
            thr = thr * wb
            alive = hit & (wb.max(-1).values > 0)
            o, d = p, l
    return rad.float()


PIXEL_TOL = 1e-3


def gaps(answer, ref) -> dict:
    """`pixels_off`: the share of the sampled pixels, in percent, whose
    radiance differs from the reference's by more than PIXEL_TOL of it (and
    of 1e-3 absolute): a flipped hit changes a whole path, so pixels are
    judged one by one.  `mean_gap`: the mean absolute difference over the
    pixels and channels, over the reference's mean radiance."""
    diff = (answer - ref).abs()
    diff = torch.where(torch.isfinite(diff), diff, torch.full_like(diff, 1e30))
    off = (diff > PIXEL_TOL * torch.clamp(ref.abs(), min=1.0)).any(-1)
    return {"pixels_off": 100.0 * float(off.float().mean()),
            "mean_gap": float(diff.mean() / torch.clamp(ref.abs().mean(),
                                                       min=1e-6))}
