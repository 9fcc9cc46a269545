"""Grass (counterpart of ``d3d12renderer_tpu/terrain/grass.py``): blade
instances on terrain, a static chunk grid culled against the camera's
frustum, two LOD classes by distance and a wind bend, built as fixed-shape
triangle soup: blades that are culled or of the other LOD class collapse to
zero-area triangles at their root.

Draws come from a `torch.Generator` or from `draws`: `{"points":
<placement points' draws>, "height": (N,)}` uniforms in [0, 1)
(`placement.draw_points`, then the heights).
"""

from __future__ import annotations

import numpy as np
import torch

from .placement import draw_points, generate_placement_points

LOD0_SEGMENTS = 4
LOD1_SEGMENTS = 2


def generate_grass_blades(heights, origin, cell_size, world_size,
                          generator=None, blades_per_side: int = 128,
                          density: float = 0.9, draws=None):
    """Blade instances: dict of position (N, 3), facing (N,), height (N,)
    in [0.35, 0.65), valid (N,) and count ()."""
    n = blades_per_side * blades_per_side
    dev = heights.device
    if draws is None:
        draws = {"points": draw_points(n, generator, dev),
                 "height": torch.rand(n, generator=generator, device=dev)}
    pts = generate_placement_points(
        heights, origin, cell_size, world_size,
        points_per_side=blades_per_side, max_slope_y=0.8, density=density,
        draws=draws["points"])
    u = torch.as_tensor(np.asarray(draws["height"], np.float32), device=dev)
    return {"position": pts["position"], "facing": pts["rotation"],
            "height": 0.35 + 0.3 * u, "valid": pts["valid"],
            "count": pts["count"]}


def blade_lod(blade_positions, camera_position, lod_distance=20.0):
    """0 near (high detail), 1 beyond `lod_distance`."""
    d = torch.linalg.norm(blade_positions - camera_position, dim=-1)
    return (d > lod_distance).to(torch.int32)


def wind_offset(positions, time, strength=0.3, frequency=1.3):
    """Wind sway at blade tips, its phase from the world position."""
    phase = positions[..., 0] * 0.5 + positions[..., 2] * 0.7
    sway = torch.sin(time * frequency + phase) + 0.35 * torch.sin(
        time * 2.7 * frequency + phase * 1.7)
    return torch.stack([sway * strength, torch.zeros_like(sway),
                        0.4 * sway * strength], -1)


def chunk_grass(blades, origin, world_size, chunk_size=8.0):
    """Blades on a static square chunk grid: (chunk id (N,), bounding
    sphere centres (G*G, 3) and radii (G*G,), nonempty (G*G,)); a sphere
    covers its chunk's valid blades plus the tallest blade and 0.5."""
    pos = blades["position"]
    valid = blades["valid"]
    g = max(1, int(np.ceil(float(world_size) / chunk_size)))
    cx = torch.clamp(((pos[:, 0] - origin[0]) / chunk_size).to(torch.int32),
                     0, g - 1)
    cz = torch.clamp(((pos[:, 2] - origin[2]) / chunk_size).to(torch.int32),
                     0, g - 1)
    cid = (cx * g + cz).long()
    big = torch.where(valid[:, None], pos, torch.inf)
    small = torch.where(valid[:, None], pos, -torch.inf)
    index = cid[:, None].expand(-1, 3)
    lo = pos.new_full((g * g, 3), torch.inf).scatter_reduce(
        0, index, big, "amin")
    hi = pos.new_full((g * g, 3), -torch.inf).scatter_reduce(
        0, index, small, "amax")
    nonempty = torch.isfinite(lo[:, 0])
    lo_s = torch.where(nonempty[:, None], lo, 0.0)
    hi_s = torch.where(nonempty[:, None], hi, 0.0)
    centers = 0.5 * (lo_s + hi_s)
    h_max = torch.max(torch.where(valid, blades["height"], 0.0))
    radii = 0.5 * torch.linalg.norm(hi_s - lo_s, dim=-1) + h_max + 0.5
    return cid, centers, radii, nonempty


def grass_lod_triangles(blades, camera, origin, world_size, time=0.0,
                        lod_distance=20.0, chunk_size=8.0, width=0.03):
    """Frame-ready grass: chunks culled against `camera`'s frustum, then
    both LOD strips (LOD0_SEGMENTS and LOD1_SEGMENTS quads) at fixed shape,
    non-members collapsed onto their root.  Returns (verts (V, 3), tris
    (T, 3), stats: visible_blades, visible_chunks, lod0_blades,
    lod1_blades)."""
    from ..scene.scene_rendering import cull_spheres, frustum_planes

    cid, centers, radii, nonempty = chunk_grass(blades, origin, world_size,
                                                chunk_size)
    planes = frustum_planes(camera).to(centers.device)
    vis_chunk = cull_spheres(planes, centers, radii) & nonempty
    bvis = blades["valid"] & vis_chunk[cid]
    lod = blade_lod(blades["position"],
                    camera.position.to(centers.device), lod_distance)
    n_blades = blades["position"].shape[0]
    verts, tris, voffset = [], [], 0
    for lod_class, segments in ((0, LOD0_SEGMENTS), (1, LOD1_SEGMENTS)):
        keep = bvis & (lod == lod_class)
        masked = {**blades,
                  "height": torch.where(keep, blades["height"], 0.0)}
        v, t = blade_triangles(masked, time=time, segments=segments,
                               width=width)
        per = v.shape[0] // n_blades
        v = torch.where(keep.repeat_interleave(per)[:, None], v,
                        blades["position"].repeat_interleave(per, 0))
        verts.append(v)
        tris.append(t + voffset)
        voffset += v.shape[0]
    stats = {"visible_blades": bvis.sum(), "visible_chunks": vis_chunk.sum(),
             "lod0_blades": (bvis & (lod == 0)).sum(),
             "lod1_blades": (bvis & (lod == 1)).sum()}
    return torch.cat(verts), torch.cat(tris), stats


def blade_triangles(blades, time=0.0, segments=LOD0_SEGMENTS, width=0.03):
    """Blades as triangle soup (V, 3) / (T, 3): a strip of `segments` quads
    tapering to the tip, its centre line bent by the wind."""
    pos = blades["position"]
    facing = blades["facing"]
    height = blades["height"]
    n = pos.shape[0]
    dev = pos.device
    t = torch.linspace(0.0, 1.0, segments + 1, device=dev)
    wind = wind_offset(pos, time)
    zero = torch.zeros_like(t)
    centers = (pos[:, None, :]
               + torch.stack([zero, t, zero], -1)[None] * height[:, None, None]
               + wind[:, None, :] * (t ** 2)[None, :, None])
    side = torch.stack([torch.cos(facing), torch.zeros_like(facing),
                        torch.sin(facing)], -1)
    half_w = width * (1.0 - t)[None, :, None]
    left = centers - side[:, None, :] * half_w
    right = centers + side[:, None, :] * half_w
    verts = torch.stack([left, right], 2).reshape(n, -1, 3)
    idx = []
    for s in range(segments):
        a = 2 * s
        idx += [[a, a + 2, a + 1], [a + 1, a + 2, a + 3]]
    idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    per = verts.shape[1]
    tri = idx[None] + (torch.arange(n, dtype=torch.int32, device=dev)
                       * per)[:, None, None]
    return verts.reshape(-1, 3), tri.reshape(-1, 3)
