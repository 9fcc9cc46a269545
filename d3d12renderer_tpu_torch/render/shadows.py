"""Shadow maps (counterpart of ``d3d12renderer_tpu/render/shadows.py``):
the sun's cascades, spot lights' perspective maps, point lights'
dual-paraboloid maps, the movement-hash cache and the atlas that packs
them.

A map is a depth image from the light, ray-cast through the BVH (one
closest-hit query per map: the BVH ray kernel on the card), and sampled
with 3x3 PCF.  A sun cascade is an orthographic view centred on the
camera.  `ShadowAtlas` keeps every light's map in one depth image, in
shelf-packed viewports, and re-renders a viewport only when its light's
movement hash changes (`ShadowCache`): host-side bookkeeping around the
device renders, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..core import maths as m
from ..cuda_build import resolve_device
from . import bvh as bvh_mod

SHADOW_ATLAS_SIZE = 6144  # the reference's atlas
DEFAULT_CASCADES = 3


@dataclass
class SunShadowMaps:
    depth: torch.Tensor       # (C, R, R) distance along the light direction
    origin: torch.Tensor      # (C, 3) corner plane centre of each volume
    right: torch.Tensor       # (C, 3)
    up: torch.Tensor          # (C, 3)
    direction: torch.Tensor   # (3,) the light's direction of travel
    extent: torch.Tensor      # (C,) half-size of the ortho volume
    z_range: torch.Tensor     # (C,) depth range


def fit_cascades(camera_pos, sun_direction, num_cascades=DEFAULT_CASCADES,
                 base_extent=8.0, z_range=60.0) -> SunShadowMaps:
    """Cascade volumes centred on the camera with doubling extents, snapped
    to their 512-texel grid for stability; `sun_direction` is the light's
    direction of travel."""
    dev = camera_pos.device
    d = m.noz(torch.as_tensor(sun_direction, dtype=torch.float32, device=dev))
    t1, t2 = m.orthonormal_basis(d)
    extents = base_extent * (2.0 ** torch.arange(num_cascades,
                                                 dtype=torch.float32,
                                                 device=dev))
    origins = []
    for c in range(num_cascades):
        texel = 2.0 * float(base_extent * 2 ** c) / 512.0
        proj_r = torch.dot(camera_pos, t1)
        proj_u = torch.dot(camera_pos, t2)
        snapped = (torch.floor(proj_r / texel) * texel * t1
                   + torch.floor(proj_u / texel) * texel * t2
                   + torch.dot(camera_pos, d) * d)
        origins.append(snapped - d * (z_range * 0.5))
    return SunShadowMaps(
        depth=torch.zeros((num_cascades, 1, 1), device=dev),
        origin=torch.stack(origins), right=t1.expand(num_cascades, 3),
        up=t2.expand(num_cascades, 3), direction=d, extent=extents,
        z_range=torch.full((num_cascades,), z_range, device=dev))


def render_sun_shadow_maps(scene_bvh, maps: SunShadowMaps,
                           resolution: int = 512, error=None,
                           stats=None) -> SunShadowMaps:
    """Depth from the light for every cascade: C R^2 rays in one
    closest-hit query (+inf where a ray escapes).  `error` and `stats` go
    to the query (`bvh.closest_hit`): with an error word the caller reads
    later, the query does not wait for the card."""
    c = maps.origin.shape[0]
    dev = maps.origin.device
    u = (torch.arange(resolution, device=dev) + 0.5) / resolution * 2 - 1
    gu, gv = torch.meshgrid(u, u, indexing="xy")
    span = gu[None, :, :, None] * maps.extent[:, None, None, None]
    spanv = gv[None, :, :, None] * maps.extent[:, None, None, None]
    o = (maps.origin[:, None, None, :] + maps.right[:, None, None, :] * span
         + maps.up[:, None, None, :] * spanv).reshape(-1, 3)
    d = maps.direction.expand(o.shape)
    res = bvh_mod.closest_hit(scene_bvh, o, d, error=error, stats=stats,
                              uv=False)
    z = torch.where(res["hit"], res["t"], torch.inf)
    return replace(maps, depth=z.reshape(c, resolution, resolution))


def sample_sun_shadow(maps: SunShadowMaps, world_pos, pcf: bool = True,
                      bias: float = 0.05):
    """Shadow factor at world positions (..., 3), 1 lit and 0 shadowed, from
    the finest cascade containing the point (3x3 PCF, edge-clamped taps),
    and that cascade's index (-1 outside every cascade)."""
    c, r, _ = maps.depth.shape
    shp = world_pos.shape[:-1]
    flat = world_pos.reshape(-1, 3)
    rel = flat[None, :, :] - maps.origin[:, None, :]                # (C, N, 3)
    u = torch.sum(rel * maps.right[:, None, :], -1) / maps.extent[:, None]
    v = torch.sum(rel * maps.up[:, None, :], -1) / maps.extent[:, None]
    z = torch.sum(rel * maps.direction[None, None, :], -1)
    inside = ((torch.abs(u) < 1) & (torch.abs(v) < 1) & (z > 0)
              & (z < maps.z_range[:, None]))
    first = inside & (torch.cumsum(inside.to(torch.int32), 0) == 1)  # (C, N)
    any_in = inside.any(0)
    sel = first.to(torch.float32)
    u_s = torch.sum(u * sel, 0)
    v_s = torch.sum(v * sel, 0)
    z_s = torch.sum(z * sel, 0)
    ci = torch.sum(torch.arange(c, device=flat.device)[:, None] * first, 0)
    ix = torch.clamp((u_s * 0.5 + 0.5) * (r - 1), 0, r - 1).to(torch.int64)
    iy = torch.clamp((v_s * 0.5 + 0.5) * (r - 1), 0, r - 1).to(torch.int64)
    if pcf:
        padded = F.pad(maps.depth[None], (1, 1, 1, 1), mode="replicate")[0]
        taps = torch.stack([padded[ci, iy + dy, ix + dx]
                            for dy in range(3) for dx in range(3)], -1)
        vis = torch.mean((z_s[:, None] <= taps + bias).to(torch.float32), -1)
    else:
        vis = (z_s <= maps.depth[ci, iy, ix] + bias).to(torch.float32)
    lit = torch.where(any_in, vis, 1.0).reshape(shp)
    chosen = torch.where(any_in, ci, -1).reshape(shp).to(torch.int32)
    return lit, chosen


# ---------------------------------------------------------------------------
# Spot shadows: a perspective depth map covering the outer cone
# ---------------------------------------------------------------------------

@dataclass
class SpotShadowMap:
    depth: torch.Tensor         # (R, R) distance from the light along each texel ray
    position: torch.Tensor      # (3,)
    direction: torch.Tensor     # (3,) unit
    right: torch.Tensor         # (3,)
    up: torch.Tensor            # (3,)
    tan_half_fov: torch.Tensor  # ()
    max_range: torch.Tensor     # ()


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _unit_grid(resolution: int, device):
    """Texel centres in [-1, 1], (R, R) each, x along columns."""
    u = (torch.arange(resolution, device=device) + 0.5) / resolution * 2 - 1
    return torch.meshgrid(u, u, indexing="xy")


def spot_tan_half(outer_cos, device) -> torch.Tensor:
    """tan of the map's half field of view: the outer cone's, padded 5% for
    the PCF rim (1 - cos^2 in double where `outer_cos` is a Python number,
    as JAX computes it)."""
    one_minus = (1.0 - outer_cos * outer_cos
                 if isinstance(outer_cos, (int, float))
                 else 1.0 - _f32(outer_cos, device) ** 2)
    return (torch.sqrt(torch.clamp(_f32(one_minus, device), min=1e-6))
            / torch.clamp(_f32(outer_cos, device), min=1e-3) * 1.05)


def _spot_frame(position, direction, device):
    pos = _f32(position, device)
    d = m.noz(_f32(direction, device))
    t1, t2 = m.orthonormal_basis(d)
    return pos, d, t1, t2


def render_spot_shadow_map(scene_bvh, position, direction, outer_cos,
                           max_range, resolution: int = 256) -> SpotShadowMap:
    """Distance to the first hit along each texel's ray from the light
    (+inf where it escapes)."""
    dev = scene_bvh.tri_v0.device
    pos, d, t1, t2 = _spot_frame(position, direction, dev)
    tan_half = spot_tan_half(outer_cos, dev)
    gu, gv = _unit_grid(resolution, dev)
    dirs = m.noz(d + (gu * tan_half)[..., None] * t1
                 + (gv * tan_half)[..., None] * t2).reshape(-1, 3)
    res = bvh_mod.closest_hit(scene_bvh, pos.expand(dirs.shape), dirs)
    z = torch.where(res["hit"], res["t"], torch.inf)
    return SpotShadowMap(depth=z.reshape(resolution, resolution),
                         position=pos, direction=d, right=t1, up=t2,
                         tan_half_fov=tan_half,
                         max_range=_f32(max_range, dev))


def _pcf(depth_at, dist, ix, iy, r):
    """Mean over the 3x3 taps around (ix, iy), edge-clamped, of
    dist <= depth + bias (`depth_at(sy, sx)` gives depth + bias)."""
    vis = torch.zeros(dist.shape, device=dist.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sx = torch.clamp(ix + dx, 0, r - 1)
            sy = torch.clamp(iy + dy, 0, r - 1)
            vis = vis + (dist <= depth_at(sy, sx)).to(torch.float32)
    return vis / 9.0


def _texel(u, r):
    return torch.clamp((u * 0.5 + 0.5) * (r - 1), 0, r - 1).to(torch.int64)


def sample_spot_shadow(smap: SpotShadowMap, world_pos, pcf: bool = True,
                       bias: float = 0.05):
    """Shadow factor at world positions (..., 3): 1 lit, 0 shadowed; 1
    outside the map's frustum."""
    r = smap.depth.shape[0]
    rel = world_pos - smap.position
    z = torch.sum(rel * smap.direction, -1)
    zs = torch.clamp(z, min=1e-4)
    u = torch.sum(rel * smap.right, -1) / (zs * smap.tan_half_fov)
    v = torch.sum(rel * smap.up, -1) / (zs * smap.tan_half_fov)
    inside = ((torch.abs(u) < 1) & (torch.abs(v) < 1) & (z > 0)
              & (z < smap.max_range))
    dist = torch.linalg.norm(rel + 1e-9, dim=-1)
    ix, iy = _texel(u, r), _texel(v, r)
    if pcf:
        vis = _pcf(lambda sy, sx: smap.depth[sy, sx] + bias, dist, ix, iy, r)
    else:
        vis = (dist <= smap.depth[iy, ix] + bias).to(torch.float32)
    return torch.where(inside, vis, 1.0)


# ---------------------------------------------------------------------------
# Point shadows: two paraboloid hemispheres, +z and -z
# ---------------------------------------------------------------------------

@dataclass
class PointShadowMap:
    depth: torch.Tensor      # (2, R, R) distance maps, +z / -z hemispheres
    position: torch.Tensor   # (3,)
    max_range: torch.Tensor  # ()


def render_point_shadow_map(scene_bvh, position, max_range,
                            resolution: int = 256) -> PointShadowMap:
    """Both hemispheres' maps in one closest-hit query of 2 R^2 rays
    (+inf where a ray escapes or its texel lies outside the paraboloid's
    disc)."""
    dev = scene_bvh.tri_v0.device
    pos = _f32(position, dev)
    gu, gv = _unit_grid(resolution, dev)
    r2 = gu * gu + gv * gv
    denom = 1.0 + r2
    dirs = torch.cat([torch.stack(
        [2 * gu / denom, 2 * gv / denom, sign * (1 - r2) / denom],
        -1).reshape(-1, 3) for sign in (1.0, -1.0)])
    res = bvh_mod.closest_hit(scene_bvh, pos.expand(dirs.shape), dirs)
    z = torch.where(res["hit"], res["t"], torch.inf)
    z = torch.where((r2.reshape(-1) <= 1.0).repeat(2), z, torch.inf)
    return PointShadowMap(depth=z.reshape(2, resolution, resolution),
                          position=pos, max_range=_f32(max_range, dev))


def sample_point_shadow(pmap: PointShadowMap, world_pos, pcf: bool = True,
                        bias: float = 0.08):
    """Shadow factor at world positions (..., 3), from the hemisphere the
    point lies in; 1 beyond `max_range`."""
    r = pmap.depth.shape[-1]
    rel = world_pos - pmap.position
    dist = torch.linalg.norm(rel + 1e-9, dim=-1)
    d = rel / dist[..., None]
    hemi = (d[..., 2] < 0).to(torch.int64)        # 0: +z map, 1: -z map
    denom = 1.0 + torch.abs(d[..., 2])
    ix, iy = _texel(d[..., 0] / denom, r), _texel(d[..., 1] / denom, r)
    if pcf:
        vis = _pcf(lambda sy, sx: pmap.depth[hemi, sy, sx] + bias, dist, ix,
                   iy, r)
    else:
        vis = (dist <= pmap.depth[hemi, iy, ix] + bias).to(torch.float32)
    return torch.where(dist < pmap.max_range, vis, 1.0)


# ---------------------------------------------------------------------------
# The re-render policy and the atlas
# ---------------------------------------------------------------------------

def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class ShadowCache:
    """Which lights' maps need a render: a light renders when the hash of
    its state (position, direction, cone, scene version...) differs from
    the one it last rendered with.  Counts `hits` and `misses`."""

    def __init__(self):
        self._hashes = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _hash(*arrays) -> int:
        h = 0
        for a in arrays:
            h ^= hash(_host_f32(a).tobytes())
        return h

    def needs_render(self, light_id, *state_arrays) -> bool:
        h = self._hash(*state_arrays)
        if self._hashes.get(light_id) == h:
            self.hits += 1
            return False
        self._hashes[light_id] = h
        self.misses += 1
        return True

    def invalidate(self, light_id=None):
        if light_id is None:
            self._hashes.clear()
        else:
            self._hashes.pop(light_id, None)


class ShadowAtlas:
    """One (size, size) depth image on `device` holding every light's map
    in its own viewport, packed on shelves left to right, top to bottom;
    a viewport keeps its place and is re-rendered only when its light
    moved (`cache`).  The maps handed out hold copies of their viewports."""

    def __init__(self, size: int = SHADOW_ATLAS_SIZE, device="cuda"):
        self.size = size
        self.device = resolve_device(device)
        self._shelf_x = 0
        self._shelf_y = 0
        self._shelf_h = 0
        self.viewports = {}   # light id -> (y, x, h, w)
        self.cache = ShadowCache()
        self.atlas = torch.full((size, size), torch.inf, device=self.device)

    def allocate(self, light_id, h: int, w: int):
        if light_id in self.viewports:
            vp = self.viewports[light_id]
            if vp[2:] != (h, w):
                raise ValueError(f"viewport size changed for {light_id}")
            return vp
        if self._shelf_x + w > self.size:            # a new shelf
            self._shelf_y += self._shelf_h
            self._shelf_x = 0
            self._shelf_h = 0
        if self._shelf_y + h > self.size:
            raise RuntimeError("shadow atlas full")
        vp = (self._shelf_y, self._shelf_x, h, w)
        self._shelf_x += w
        self._shelf_h = max(self._shelf_h, h)
        self.viewports[light_id] = vp
        return vp

    def _update(self, light_id, h, w, state, render_tile):
        """Allocate the viewport, render into it if the light moved, and
        return a copy of it."""
        y, x, _, _ = self.allocate(light_id, h, w)
        if self.cache.needs_render(light_id, *state):
            self.atlas[y:y + h, x:x + w] = render_tile()
        return self.atlas[y:y + h, x:x + w].clone()

    def update_sun(self, scene_bvh, camera_pos, sun_direction,
                   resolution: int = 512, scene_version: int = 0,
                   num_cascades: int = DEFAULT_CASCADES) -> SunShadowMaps:
        """The sun's cascades (`fit_cascades`), one viewport each;
        `sun_direction` is the light's direction of travel."""
        maps = fit_cascades(_f32(camera_pos, self.device), sun_direction,
                            num_cascades=num_cascades)
        depths = []
        for ci in range(num_cascades):
            one = replace(maps, origin=maps.origin[ci:ci + 1],
                          right=maps.right[ci:ci + 1], up=maps.up[ci:ci + 1],
                          extent=maps.extent[ci:ci + 1],
                          z_range=maps.z_range[ci:ci + 1])
            state = (maps.origin[ci], maps.direction, maps.extent[ci],
                     np.int64(scene_version))
            depths.append(self._update(
                ("sun", ci), resolution, resolution, state,
                lambda one=one: render_sun_shadow_maps(
                    scene_bvh, one, resolution=resolution).depth[0]))
        return replace(maps, depth=torch.stack(depths))

    def update_spot(self, scene_bvh, light_id, position, direction, outer_cos,
                    max_range, resolution: int = 256,
                    scene_version: int = 0) -> SpotShadowMap:
        state = (np.asarray(position, np.float32),
                 np.asarray(direction, np.float32), np.float32(outer_cos),
                 np.float32(max_range), np.int64(scene_version))
        depth = self._update(
            ("spot", light_id), resolution, resolution, state,
            lambda: render_spot_shadow_map(
                scene_bvh, position, direction, outer_cos, max_range,
                resolution=resolution).depth)
        pos, d, t1, t2 = _spot_frame(position, direction, self.device)
        return SpotShadowMap(depth=depth, position=pos, direction=d, right=t1,
                             up=t2,
                             tan_half_fov=spot_tan_half(outer_cos,
                                                        self.device),
                             max_range=_f32(max_range, self.device))

    def update_point(self, scene_bvh, light_id, position, max_range,
                     resolution: int = 256,
                     scene_version: int = 0) -> PointShadowMap:
        """Both hemispheres side by side in one (R, 2R) viewport."""
        state = (np.asarray(position, np.float32), np.float32(max_range),
                 np.int64(scene_version))
        tile = self._update(
            ("point", light_id), resolution, 2 * resolution, state,
            lambda: torch.cat(list(render_point_shadow_map(
                scene_bvh, position, max_range,
                resolution=resolution).depth), dim=1))
        return PointShadowMap(
            depth=torch.stack([tile[:, :resolution], tile[:, resolution:]]),
            position=_f32(position, self.device),
            max_range=_f32(max_range, self.device))
