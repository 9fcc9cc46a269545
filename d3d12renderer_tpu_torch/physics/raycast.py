"""Exact ray-vs-primitive tests and the scene ray cast (counterpart of
``d3d12renderer_tpu/physics/raycast.py``).

Every primitive test is branch-free and broadcasts a ray (..., 3) against
colliders on any leading axes.  The hull test sphere-traces the ray against
the point-to-hull distance of the port's GJK (conservative advancement).
`ray_cast` runs one ray per scene (origin / direction (B, 3)) against the
scene's colliders, planes and terrains, each collider type on its own
static index set, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import maths as m
from .gjk import ShapeRef, gjk
from .types import (SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CYLINDER, SHAPE_HULL,
                    SHAPE_SPHERE, BodyState, SceneArchetype)

_INF = 1e30
_HULL_TRACE_STEPS = 48


class RayHit(NamedTuple):
    """Nearest hit of each scene's ray.  `kind` 0 = collider, 1 = plane,
    2 = terrain; `index` indexes that table; `body` is the owning body (-1
    for static geometry).  On a miss `hit` is False and t = 1e30."""

    hit: torch.Tensor      # (B,) bool
    t: torch.Tensor        # (B,)
    point: torch.Tensor    # (B, 3)
    normal: torch.Tensor   # (B, 3)
    kind: torch.Tensor     # (B,) int64
    index: torch.Tensor    # (B,) int64
    body: torch.Tensor     # (B,) int64


def _miss_like(t):
    return torch.where(torch.isfinite(t) & (t >= 0.0), t, _INF)


def _away_from_zero(x, eps=1e-12):
    """x with |x| < eps replaced by +-eps (the sign of x, + at 0)."""
    return torch.where(x.abs() < eps, torch.where(x >= 0, eps, -eps), x)


def ray_vs_sphere(o, d, center, radius):
    """(t, normal) of the first hit with the sphere's surface; t = 1e30 on
    a miss.  A ray that starts inside reports the exit point."""
    oc = o - center
    b = torch.sum(oc * d, -1)
    c = torch.sum(oc * oc, -1) - radius * radius
    disc = b * b - c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - s, -b + s
    t = torch.where(t0 > 1e-6, t0, t1)
    t = torch.where(disc >= 0.0, _miss_like(t), _INF)
    n = m.noz(o + d * t[..., None] - center)
    return t, n


def ray_vs_capsule(o, d, p0, p1, radius):
    """Capsule of hemisphere centres p0 / p1: the infinite cylinder's side
    hit clipped to the segment, and the two cap spheres."""
    axis = m.noz(p1 - p0)
    oc = o - p0
    d_perp = d - axis * torch.sum(d * axis, -1, keepdim=True)
    oc_perp = oc - axis * torch.sum(oc * axis, -1, keepdim=True)
    a = torch.sum(d_perp * d_perp, -1)
    b = torch.sum(oc_perp * d_perp, -1)
    c = torch.sum(oc_perp * oc_perp, -1) - radius * radius
    disc = b * b - a * c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    safe_a = torch.clamp(a, min=1e-12)
    t0 = (-b - s) / safe_a
    t1 = (-b + s) / safe_a
    t_side = torch.where(t0 > 1e-6, t0, t1)
    h = torch.sum((o + d * t_side[..., None] - p0) * axis, -1)
    seg_len = m.length(p1 - p0)
    on_side = (disc >= 0.0) & (a > 1e-12) & (h >= 0.0) & (h <= seg_len)
    t_side = torch.where(on_side, _miss_like(t_side), _INF)

    t_a, n_a = ray_vs_sphere(o, d, p0, radius)
    t_b, n_b = ray_vs_sphere(o, d, p1, radius)
    t_cap = torch.minimum(t_a, t_b)
    n_cap = torch.where((t_a <= t_b)[..., None], n_a, n_b)

    t = torch.minimum(t_side, t_cap)
    foot = p0 + axis * h[..., None]
    n_side = m.noz(o + d * t_side[..., None] - foot)
    n = torch.where((t_side <= t_cap)[..., None], n_side, n_cap)
    return t, n


def ray_vs_box(o, d, pos, rot, half):
    """Oriented box: the slab test in the box's frame."""
    ol = m.quat_inv_rotate(rot, o - pos)
    dl = m.quat_inv_rotate(rot, d)
    inv = 1.0 / _away_from_zero(dl)
    t_lo = (-half - ol) * inv
    t_hi = (half - ol) * inv
    t_near = torch.amax(torch.minimum(t_lo, t_hi), -1)
    t_far = torch.amin(torch.maximum(t_lo, t_hi), -1)
    inside = t_near <= 1e-6
    t = torch.where(inside, t_far, t_near)
    ok = (t_near <= t_far) & (t_far > 1e-6)
    t = torch.where(ok, _miss_like(t), _INF)
    # The normal: the axis of the active slab at the hit point.
    p_local = ol + dl * t[..., None]
    ax = torch.argmax(torch.abs(p_local / torch.clamp(half, min=1e-9)), -1)
    n_local = (torch.eye(3, dtype=o.dtype, device=o.device)[ax]
               * torch.sign(torch.gather(p_local, -1, ax[..., None])))
    n = m.quat_rotate(rot, torch.where(inside[..., None], -n_local, n_local))
    return t, n


def ray_vs_cylinder(o, d, pos, rot, radius, half_len):
    """Finite y-axis cylinder: the side clipped to |y| <= half_len and the
    two cap disks."""
    ol = m.quat_inv_rotate(rot, o - pos)
    dl = m.quat_inv_rotate(rot, d)
    a = dl[..., 0] ** 2 + dl[..., 2] ** 2
    b = ol[..., 0] * dl[..., 0] + ol[..., 2] * dl[..., 2]
    c = ol[..., 0] ** 2 + ol[..., 2] ** 2 - radius * radius
    disc = b * b - a * c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    safe_a = torch.clamp(a, min=1e-12)
    t0 = (-b - s) / safe_a
    t1 = (-b + s) / safe_a
    t_side = torch.where(t0 > 1e-6, t0, t1)
    y = ol[..., 1] + dl[..., 1] * t_side
    on_side = (disc >= 0.0) & (a > 1e-12) & (torch.abs(y) <= half_len)
    t_side = torch.where(on_side, _miss_like(t_side), _INF)
    p_side = ol + dl * t_side[..., None]
    xz = m.constant((1.0, 0.0, 1.0), o.dtype, o.device)
    n_side = m.noz(p_side * xz)

    safe_dy = _away_from_zero(dl[..., 1])
    t_caps, n_caps = [], []
    for sign in (1.0, -1.0):
        t_c = (sign * half_len - ol[..., 1]) / safe_dy
        p_c = ol + dl * t_c[..., None]
        in_disk = p_c[..., 0] ** 2 + p_c[..., 2] ** 2 <= radius * radius
        t_caps.append(torch.where(in_disk & (t_c > 1e-6), t_c, _INF))
        n_caps.append(m.constant((0.0, sign, 0.0), o.dtype,
                                 o.device).expand(p_c.shape))
    t_cap = torch.minimum(t_caps[0], t_caps[1])
    n_cap = torch.where((t_caps[0] <= t_caps[1])[..., None], n_caps[0],
                        n_caps[1])

    t = torch.minimum(t_side, t_cap)
    n_local = torch.where((t_side <= t_cap)[..., None], n_side, n_cap)
    return t, m.quat_rotate(rot, n_local)


def ray_vs_hull(o, d, pos, rot, hull_verts, hull_mask, max_t=100.0):
    """Convex hull (padded vertex cloud) by conservative advancement: the
    point o + t d steps the GJK distance to the hull, _HULL_TRACE_STEPS
    times.  The normal is the closing direction of the last separated
    step."""
    o, d = o.expand(pos.shape), d.expand(pos.shape)
    rows = pos.shape[:-1]
    zeros3 = pos.new_zeros(rows + (3,))
    hull = ShapeRef(shape_type=SHAPE_HULL, size=zeros3, pos=pos, rot=rot,
                    hull_verts=hull_verts, hull_mask=hull_mask,
                    margin=pos.new_zeros(rows))
    ident = m.constant((0.0, 0.0, 0.0, 1.0), pos.dtype,
                       pos.device).expand(rows + (4,))
    no_verts = pos.new_zeros(rows + (1, 3))
    no_mask = torch.zeros(rows + (1,), dtype=torch.bool, device=pos.device)

    def probe(t):
        point = ShapeRef(shape_type=SHAPE_SPHERE, size=zeros3,
                         pos=o + d * t[..., None], rot=ident,
                         hull_verts=no_verts, hull_mask=no_mask,
                         margin=pos.new_zeros(rows))
        r = gjk(point, hull)
        return r["distance"], r["closest"]

    t = pos.new_zeros(rows)
    n = -d
    done = torch.zeros(rows, dtype=torch.bool, device=pos.device)
    for _ in range(_HULL_TRACE_STEPS):
        dist, closest = probe(t)
        arrived = dist < 1e-4
        # While separated, `closest` points from the hull's witness to the
        # probe point: the outward normal.
        n = torch.where((arrived | done)[..., None], n, m.noz(closest))
        # The hull is convex and static: the ray may advance the whole
        # free distance.
        t = torch.where(done | arrived, t, t + dist)
        done = done | arrived | (t > max_t)
    dist, _ = probe(t)
    hit = (dist < 1e-3) & (t <= max_t) & (t > 1e-6)
    return torch.where(hit, t, _INF), n


def ray_vs_plane(o, d, normal, offset):
    """Half-space boundary dot(n, x) = offset, front faces only."""
    denom = torch.sum(normal * d, -1)
    t = (offset - torch.sum(normal * o, -1)) / torch.where(
        denom.abs() < 1e-12, -1e-12, denom)
    ok = (denom < -1e-9) & (t > 1e-6)
    return torch.where(ok, t, _INF), normal.expand(t.shape + (3,))


def ray_vs_heightfield(o, d, heights, origin, cell, max_t=200.0, steps=96):
    """Rays (..., 3) against the bilinear surface: a fixed-step march, then
    16 bisections of the first step that crosses below it."""
    from ..terrain.heightmap import sample_height_bilinear

    # JAX's linspace from 0: i times the float32 step.
    delta = float(np.float32(max_t) / np.float32(steps - 1))
    ts = torch.arange(steps, dtype=o.dtype, device=o.device) * delta
    p = o[..., None, :] + d[..., None, :] * ts[:, None]
    h, _ = sample_height_bilinear(heights, origin, cell, p[..., 0], p[..., 2])
    above = p[..., 1] > h
    crossing = above[..., :-1] & ~above[..., 1:]
    first = torch.argmax(crossing.to(torch.uint8), -1)
    found = crossing.any(-1)
    lo = ts[first]
    hi = ts[torch.clamp(first + 1, max=steps - 1)]
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        q = o + d * mid[..., None]
        hm, _ = sample_height_bilinear(heights, origin, cell, q[..., 0],
                                       q[..., 2])
        below = q[..., 1] <= hm
        lo, hi = torch.where(below, lo, mid), torch.where(below, mid, hi)
    t = 0.5 * (lo + hi)
    q = o + d * t[..., None]
    _, n = sample_height_bilinear(heights, origin, cell, q[..., 0], q[..., 2])
    return torch.where(found, t, _INF), n


def ray_cast(arch: SceneArchetype, state: BodyState, origin, direction,
             max_t: float = 1e6) -> RayHit:
    """Each scene's nearest exact hit among its colliders, static planes
    and terrains.  origin / direction (3,) or (B, 3)."""
    from .collide import collider_world_poses, colliders_of_type

    dev = state.pos.device
    batch = state.pos.shape[0]
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev).expand(
        batch, 3)
    d = m.noz(torch.as_tensor(direction, dtype=torch.float32,
                              device=dev)).expand(batch, 3)
    ncol = arch.num_colliders
    wpos, wrot = collider_world_poses(arch, state)
    o1, d1 = o[:, None], d[:, None]

    t_all = o.new_full((batch, ncol), _INF)
    n_all = o.new_zeros((batch, ncol, 3))
    for stype in (SHAPE_SPHERE, SHAPE_CAPSULE, SHAPE_BOX, SHAPE_CYLINDER,
                  SHAPE_HULL):
        idx = colliders_of_type(arch, stype)
        if idx.numel() == 0:
            continue
        cp, cr = wpos[:, idx], wrot[:, idx]
        size = arch.col_size[idx]
        if stype == SHAPE_SPHERE:
            t, n = ray_vs_sphere(o1, d1, cp, size[:, 0])
        elif stype == SHAPE_CAPSULE:
            up = m.constant((0.0, 1.0, 0.0), cp.dtype, dev)
            axis = m.quat_rotate(cr, up.expand(cp.shape))
            p0 = cp - axis * size[:, 1:2]
            p1 = cp + axis * size[:, 1:2]
            t, n = ray_vs_capsule(o1, d1, p0, p1, size[:, 0])
        elif stype == SHAPE_BOX:
            t, n = ray_vs_box(o1, d1, cp, cr, size)
        elif stype == SHAPE_CYLINDER:
            t, n = ray_vs_cylinder(o1, d1, cp, cr, size[:, 0], size[:, 1])
        else:
            t, n = ray_vs_hull(
                o1, d1, cp, cr,
                arch.col_hull_verts[idx].expand(cp.shape[:-1] + (-1, 3)),
                arch.col_hull_mask[idx].expand(cp.shape[:-1] + (-1,)),
                max_t=min(max_t, 1e3))
        t_all[:, idx] = t
        n_all[:, idx] = n

    def table(kind, count, body=None):
        return (torch.full((batch, count), kind, dtype=torch.int64, device=dev),
                torch.arange(count, device=dev).expand(batch, count),
                (torch.full((batch, count), -1, dtype=torch.int64, device=dev)
                 if body is None else body.expand(batch, count)))

    cand_t, cand_n, cand_meta = [t_all], [n_all], [table(0, ncol,
                                                         arch.col_body)]
    if arch.num_planes:
        tp, np_ = ray_vs_plane(o1, d1, arch.plane_normal, arch.plane_offset)
        cand_t.append(tp)
        cand_n.append(np_)
        cand_meta.append(table(1, arch.num_planes))
    for ti in range(arch.num_terrains):
        tt, tn = ray_vs_heightfield(
            o, d, arch.terrain_height[ti], arch.terrain_origin[ti],
            arch.terrain_cell[ti], max_t=min(max_t, 500.0))
        kinds, _, bodies = table(2, 1)
        cand_t.append(tt[:, None])
        cand_n.append(tn[:, None])
        cand_meta.append((kinds, torch.full_like(kinds, ti), bodies))

    ts = torch.cat(cand_t, -1)
    ts = torch.where(ts <= max_t, ts, _INF)
    ns = torch.cat(cand_n, -2)
    kinds, indices, bodies = (torch.cat(x, -1) for x in zip(*cand_meta))

    best = torch.argmin(ts, -1, keepdim=True)
    t = torch.gather(ts, -1, best)[:, 0]
    hit = t < _INF
    pick = lambda x: torch.gather(x, -1, best)[:, 0]  # noqa: E731
    return RayHit(
        hit=hit,
        t=t,
        point=o + d * t[:, None],
        normal=m.noz(torch.gather(ns, -2, best[..., None].expand(-1, 1, 3))
                     [:, 0]),
        kind=pick(kinds),
        index=pick(indices),
        body=torch.where(hit, pick(bodies), -1))
