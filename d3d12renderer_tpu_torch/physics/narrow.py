"""Narrowphase: static planes against every collider type, and the sphere /
capsule / box pairs (counterpart of ``d3d12renderer_tpu/physics/narrow.py``;
pairs with a cylinder or a hull go through physics/gjk.py).

Manifold conventions are the JAX package's: the normal points from A (the
plane, or the pair's first collider) toward B, depth >= 0 when touching, and
each point sits midway between the two surfaces.  Every function runs over
leading (batch, row) axes; the pair functions take every argument at the
full leading shape (they gather along the last axis).  The JAX package left
these functions to XLA outside its kernels; here they are plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import maths as m
from .types import MAX_CONTACT_POINTS


@dataclass
class ContactTable:
    """Solver-ready contact manifolds, one row per candidate pair."""

    body_a: torch.Tensor      # (P,) int64
    body_b: torch.Tensor      # (P,) int64
    normal: torch.Tensor      # (B, P, 3) from A toward B
    point: torch.Tensor       # (B, P, 4, 3)
    depth: torch.Tensor       # (B, P, 4)
    pmask: torch.Tensor       # (B, P, 4) bool
    friction: torch.Tensor    # (B, P)
    restitution: torch.Tensor # (B, P)
    active: torch.Tensor      # (B, P) bool


def combine_materials(fa, fb, ra, rb):
    friction = torch.clamp(torch.sqrt(fa * fb), 0.0, 1.0)
    restitution = torch.clamp(torch.maximum(ra, rb), 0.0, 1.0)
    return friction, restitution


def top_k(x, k):
    """Top-k along the last axis by iterated first-index argmax, as the JAX
    package's `jax_top_k`.  Tied values keep their lowest indices first; the
    selected order is the order in which the manifold points are solved."""
    lane = torch.arange(x.shape[-1], device=x.device)
    s = x
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(s, dim=-1)
        vals.append(torch.gather(s, -1, i[..., None])[..., 0])
        idxs.append(i)
        s = torch.where(lane == i[..., None], -torch.inf, s)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _pad_points(points, depths, masks):
    """Stack K > 4 per-point candidates into (..., 4, *) arrays, keeping the
    4 deepest active ones (fewer candidates are padded in collide.py)."""
    pts = torch.stack(points, dim=-2)
    dep = torch.stack(depths, dim=-1)
    msk = torch.stack(masks, dim=-1)
    score = torch.where(msk, dep, -torch.inf)
    _, idx = top_k(score, MAX_CONTACT_POINTS)
    pts = torch.gather(pts, -2, idx[..., None].expand(idx.shape + (3,)))
    return pts, torch.gather(dep, -1, idx), torch.gather(msk, -1, idx)


def sphere_vs_plane(center, radius, n, offset):
    """One point: center (..., 3), radius (...), plane n (..., 3), offset."""
    dist = m.dot(n, center) - offset
    depth = radius - dist
    hit = depth >= 0.0
    point = center - n * (dist + 0.5 * depth)[..., None]
    return point[..., None, :], depth[..., None], hit[..., None]


def points_vs_plane(pts, n, offset):
    """Point cloud (..., K, 3) against a plane: K candidates."""
    dist = torch.sum(pts * n[..., None, :], dim=-1) - offset[..., None]
    depth = -dist
    hit = depth >= 0.0
    point = pts + n[..., None, :] * (0.5 * depth)[..., :, None]
    return point, depth, hit


def capsule_vs_plane(p0, p1, radius, n, offset):
    """Two endpoint spheres: up to 2 points."""
    pt0, d0, h0 = sphere_vs_plane(p0, radius, n, offset)
    pt1, d1, h1 = sphere_vs_plane(p1, radius, n, offset)
    return (torch.cat([pt0, pt1], dim=-2), torch.cat([d0, d1], dim=-1),
            torch.cat([h0, h1], dim=-1))


_BOX_CORNERS = (
    (-1, -1, -1), (1, -1, -1), (-1, 1, -1), (1, 1, -1),
    (-1, -1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, 1),
)


def box_corners(center, rot, half):
    """(..., 3), (..., 4), (..., 3) -> (..., 8, 3) world corners."""
    corners = m.constant(_BOX_CORNERS, center.dtype, center.device)
    local = corners * half[..., None, :]
    return center[..., None, :] + m.quat_rotate(rot[..., None, :], local)


def box_vs_plane(center, rot, half, n, offset):
    point, depth, hit = points_vs_plane(box_corners(center, rot, half), n,
                                        offset)
    return _pad_points(
        [point[..., k, :] for k in range(8)],
        [depth[..., k] for k in range(8)],
        [hit[..., k] for k in range(8)],
    )


def hull_vs_plane(world_verts, vert_mask, n, offset):
    """Convex hull (..., V, 3) world vertices with mask (..., V) against a
    plane: the 4 deepest vertices form the manifold."""
    d = torch.sum(world_verts * n[..., None, :], dim=-1) - offset[..., None]
    d = torch.where(vert_mask, d, torch.inf)
    top, idx = top_k(-d, 4)
    pts = torch.gather(world_verts, -2, idx[..., None].expand(idx.shape + (3,)))
    pts = pts + n[..., None, :] * (0.5 * torch.clamp(top, min=0.0))[..., None]
    return pts, top, top >= 0.0


def cylinder_vs_plane(center, rot, radius, half_len, n, offset):
    """The rim points of both caps deepest and shallowest along the plane
    normal: 4 candidates."""
    up = m.constant((0.0, 1.0, 0.0), center.dtype, center.device)
    axis = m.quat_rotate(rot, up.expand(center.shape))
    cap0 = center - axis * half_len[..., None]
    cap1 = center + axis * half_len[..., None]
    d = m.noz(-(n - axis * m.dot(n, axis)[..., None]))
    r = d * radius[..., None]
    return points_vs_plane(torch.stack([cap0 + r, cap1 + r, cap0 - r, cap1 - r],
                                       dim=-2), n, offset)


# ---------------------------------------------------------------------------
# Collider pairs.  A and B are the pair's colliders in canonical type order
# (sphere < capsule < box); the normal points from A toward B.
# ---------------------------------------------------------------------------

def _take(x, idx):
    """x[..., idx] for an index per leading position: (..., K), (...) ->
    (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _take_row(x, idx):
    """x[..., idx, :] for an index per leading position: (..., K, 3), (...)
    -> (..., 3)."""
    index = idx[..., None, None].expand(idx.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, index)[..., 0, :]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _const(x, ref):
    return m.constant(x, ref.dtype, ref.device)


def sphere_vs_sphere(ca, ra, cb, rb):
    n = cb - ca
    rsum = ra + rb
    sq = m.squared_length(n)
    hit = sq <= rsum * rsum
    dist = torch.sqrt(torch.clamp(sq, min=1e-16))
    normal = torch.where((sq < 1e-12)[..., None],
                         _const((0.0, 1.0, 0.0), n).expand(n.shape),
                         n / dist[..., None])
    depth = rsum - dist
    point = 0.5 * (ca + normal * ra[..., None] + cb - normal * rb[..., None])
    return normal, point[..., None, :], depth[..., None], hit[..., None]


def closest_point_segment(p, a, b):
    ab = b - a
    t = torch.clamp(m.dot(p - a, ab)
                    / torch.clamp(m.squared_length(ab), min=1e-12), 0.0, 1.0)
    return a + ab * t[..., None]


def closest_points_segment_segment(p1, q1, p2, q2):
    """Closest points of segments [p1, q1] and [p2, q2].  Parallel segments
    (denominator <= 1e-12) take s = 0, as in the JAX package."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = m.squared_length(d1)
    e = m.squared_length(d2)
    f = m.dot(d2, r)
    c = m.dot(d1, r)
    b = m.dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e)
                                / torch.clamp(denom, min=1e-12), 0.0, 1.0),
                    torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp(e, min=1e-12)
    t_cl = torch.clamp(t, 0.0, 1.0)
    # s again for a clamped t.
    s = torch.where(t != t_cl,
                    torch.clamp((t_cl * b - c) / torch.clamp(a, min=1e-12),
                                0.0, 1.0), s)
    return p1 + d1 * s[..., None], p2 + d2 * t_cl[..., None]


def sphere_vs_capsule(c, r, p0, p1, rc):
    return sphere_vs_sphere(c, r, closest_point_segment(c, p0, p1), rc)


def capsule_vs_capsule(a0, a1, ra, b0, b1, rb):
    ca, cb = closest_points_segment_segment(a0, a1, b0, b1)
    return sphere_vs_sphere(ca, ra, cb, rb)


def _closest_point_on_box(local_p, half):
    """Closest point of a box to a box-local point: (closest, normal from
    the box surface toward the point, signed distance, > 0 outside).  A
    point inside leaves by the face of least penetration (the first axis of
    a tie)."""
    clamped = _clip(local_p, -half, half)
    delta = local_p - clamped
    outside_sq = m.squared_length(delta)
    outside = outside_sq > 1e-12

    dist_to_face = half - torch.abs(local_p)
    axis = torch.argmin(dist_to_face, dim=-1)
    sign = torch.sign(_take(local_p, axis))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    inside_normal = (torch.eye(3, dtype=local_p.dtype, device=local_p.device)
                     [axis] * sign[..., None])
    face_dist = _take(dist_to_face, axis)
    inside_closest = local_p + inside_normal * face_dist[..., None]
    out_dist = torch.sqrt(torch.clamp(outside_sq, min=1e-16))
    outside_normal = delta / out_dist[..., None]

    closest = torch.where(outside[..., None], clamped, inside_closest)
    normal = torch.where(outside[..., None], outside_normal, inside_normal)
    sdist = torch.where(outside, out_dist, -face_dist)
    return closest, normal, sdist


def sphere_vs_box(c, r, box_center, box_rot, half):
    """Sphere A against box B."""
    local_c = m.quat_inv_rotate(box_rot, c - box_center)
    closest_l, normal_l, sdist = _closest_point_on_box(local_c, half)
    depth = r - sdist
    hit = depth >= 0.0
    closest_w = box_center + m.quat_rotate(box_rot, closest_l)
    n_box_to_sphere = m.quat_rotate(box_rot, normal_l)
    sphere_surf = c - n_box_to_sphere * r[..., None]
    point = 0.5 * (closest_w + sphere_surf)
    return -n_box_to_sphere, point[..., None, :], depth[..., None], \
        hit[..., None]


def _closest_t_segment_box(a0, a1, half, iters=24):
    """Parameter t of the segment point closest to the origin-centred box
    (a0, a1 box-local).  The distance is convex in t, so the sign of its
    derivative g(t) = (p(t) - clamp(p(t))) . d is bisected in a fixed
    `iters` steps (JAX's count and order), then the endpoints take over
    where g(0) >= 0 or g(1) <= 0."""
    d = a1 - a0

    def g(t):
        p = a0 + d * t[..., None]
        return m.dot(p - _clip(p, -half, half), d)

    lo = torch.zeros(a0.shape[:-1], dtype=a0.dtype, device=a0.device)
    hi = torch.ones_like(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = g(mid) < 0.0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    t = 0.5 * (lo + hi)
    t = torch.where(g(torch.zeros_like(t)) >= 0.0, torch.zeros_like(t), t)
    return torch.where(g(torch.ones_like(t)) <= 0.0, torch.ones_like(t), t)


def capsule_vs_box(p0, p1, r, box_center, box_rot, half):
    """Capsule A (segment p0-p1, radius r) against box B: sphere probes at
    both ends and at the closest segment point, plus, where the normal lies
    within ~20 degrees of a box face, the segment clipped to that face
    (Liang-Barsky) as a two-point line manifold."""
    a0 = m.quat_inv_rotate(box_rot, p0 - box_center)
    a1 = m.quat_inv_rotate(box_rot, p1 - box_center)
    t_star = _closest_t_segment_box(a0, a1, half)
    p_star = p0 + (p1 - p0) * t_star[..., None]

    normals, points, depths, hits = [], [], [], []
    for probe in (p0, p1, p_star):
        n, pt, d, h = sphere_vs_box(probe, r, box_center, box_rot, half)
        normals.append(n)
        points.append(pt[..., 0, :])
        depths.append(d[..., 0])
        hits.append(h[..., 0])
    dep3 = torch.stack(depths, dim=-1)
    msk3 = torch.stack(hits, dim=-1)
    normals3 = torch.stack(normals, dim=-2)
    best = torch.argmax(torch.where(msk3, dep3, -torch.inf), dim=-1)
    normal = _take_row(normals3, best)
    # Probes whose own normal disagrees with the manifold's are dropped.
    agree = torch.sum(normals3 * normal[..., None, :], dim=-1) > 0.94
    msk3 = msk3 & agree

    # Face clip: the box-local normal's dominant axis.
    n_local = m.quat_inv_rotate(box_rot, -normal)
    k = torch.argmax(torch.abs(n_local), dim=-1)
    axis_k = _take(n_local, k)
    s = torch.sign(axis_k)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    is_face = torch.abs(axis_k) > 0.94
    u_axis = (k + 1) % 3
    v_axis = (k + 2) % 3

    h_k, h_u, h_v = _take(half, k), _take(half, u_axis), _take(half, v_axis)
    u0, u1 = _take(a0, u_axis), _take(a1, u_axis)
    v0, v1 = _take(a0, v_axis), _take(a1, v_axis)
    z0, z1 = _take(a0, k) * s, _take(a1, k) * s

    t_lo = torch.zeros_like(u0)
    t_hi = torch.ones_like(u0)
    one, zero = torch.ones_like(u0), torch.zeros_like(u0)
    for c0, c1, lim in ((u0, u1, h_u), (v0, v1, h_v)):
        dcomp = c1 - c0
        par_in = torch.abs(dcomp) < 1e-12
        dsafe = torch.where(par_in, torch.full_like(dcomp, 1e-12), dcomp)
        ta = (-lim - c0) / dsafe
        tb = (lim - c0) / dsafe
        enter = torch.minimum(ta, tb)
        exit_ = torch.maximum(ta, tb)
        inside0 = torch.abs(c0) <= lim
        t_lo = torch.where(par_in, torch.where(inside0, t_lo, one),
                           torch.maximum(t_lo, enter))
        t_hi = torch.where(par_in, torch.where(inside0, t_hi, zero),
                           torch.minimum(t_hi, exit_))
    clip_ok = t_hi >= t_lo
    face = torch.where(is_face, one, zero)

    def face_point(t):
        z = z0 + (z1 - z0) * t
        depth = r - (z - h_k)
        seg_w = p0 + (p1 - p0) * t[..., None]
        pt = seg_w + normal * (0.5 * (z - h_k + r))[..., None] \
            * face[..., None]
        return pt, depth

    fp0, fd0 = face_point(t_lo)
    fp1, fd1 = face_point(t_hi)
    fmask0 = is_face & clip_ok & (fd0 >= 0.0)
    fmask1 = is_face & clip_ok & (fd1 >= 0.0) & (t_hi > t_lo + 1e-6)

    any_hit = torch.any(msk3, dim=-1)
    pts, dep, msk = _pad_points(
        points + [fp0, fp1], depths + [fd0, fd1],
        [msk3[..., i] & any_hit for i in range(3)]
        + [fmask0 & any_hit, fmask1 & any_hit])
    return normal, pts, dep, msk


_NEXT = (1, 2, 3, 0)


def _clip_quad_rect(quad, lim_u, lim_v):
    """All 24 candidate vertices of a cyclic quad (..., 4, 2) clipped to the
    rectangle |u| <= lim_u, |v| <= lim_v, with masks: the quad's vertices
    inside the rectangle, the rectangle's corners inside the quad, and the
    16 quad-edge x rectangle-edge intersections."""
    in_rect = (torch.abs(quad[..., 0]) <= lim_u[..., None] + 1e-6) & (
        torch.abs(quad[..., 1]) <= lim_v[..., None] + 1e-6)

    signs = _const(((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)), quad)
    corners = torch.stack([signs[:, 0] * lim_u[..., None],
                           signs[:, 1] * lim_v[..., None]], dim=-1)
    quad_next = quad.index_select(-2, m.constant(_NEXT, torch.int64,
                                                   quad.device))
    e = quad_next - quad
    d = corners[..., :, None, :] - quad[..., None, :, :]
    cross = e[..., None, :, 0] * d[..., 1] - e[..., None, :, 1] * d[..., 0]
    in_quad = torch.all(cross >= -1e-9, dim=-1) | torch.all(cross <= 1e-9,
                                                           dim=-1)

    inters, imasks = [], []
    for axis, lim, other_lim in ((0, lim_u, lim_v), (1, lim_v, lim_u)):
        for sign in (1.0, -1.0):
            u0 = quad[..., axis]
            u1 = quad_next[..., axis]
            denom = u1 - u0
            flat = torch.abs(denom) < 1e-12
            t = (sign * lim[..., None] - u0) / torch.where(
                flat, torch.full_like(denom, 1e-12), denom)
            pt = quad + e * t[..., None]
            valid = ((t >= 0.0) & (t <= 1.0) & ~flat
                     & (torch.abs(pt[..., 1 - axis])
                        <= other_lim[..., None] + 1e-6))
            inters.append(pt)
            imasks.append(valid)
    return (torch.cat([quad, corners] + inters, dim=-2),
            torch.cat([in_rect, in_quad] + imasks, dim=-1))


def _scatter_axis(arr, axis_idx, values):
    """Add values (..., K) into component axis_idx (...) of each 3-vector
    of arr (..., K, 3)."""
    onehot = torch.eye(3, dtype=arr.dtype, device=arr.device)[axis_idx]
    return arr + onehot[..., None, :] * values[..., None]


def _sum_rows(mat, v):
    """mat^T v over (..., 3, 3) and (..., 3): sum_i mat[i, j] v[i]."""
    return torch.sum(mat * v[..., :, None], dim=-2)


def box_vs_box(ca, ra, ha, cb, rb, hb):
    """Box A against box B by the 15 separating axes (6 faces, 9 edge
    pairs).  The least-penetration face gives a manifold (the incident face
    clipped to the reference face, the 4 deepest points by `top_k`); an
    edge pair wins only below 95% of the best face's penetration minus
    1e-4, and gives one point.  Ties among axes take the first one."""
    Ra = m.quat_to_mat3(ra)
    Rb = m.quat_to_mat3(rb)
    t = cb - ca
    axes_a = [Ra[..., :, i] for i in range(3)]
    axes_b = [Rb[..., :, i] for i in range(3)]

    def face_pen(L):
        proj_a = (ha[..., 0] * torch.abs(m.dot(axes_a[0], L))
                  + ha[..., 1] * torch.abs(m.dot(axes_a[1], L))
                  + ha[..., 2] * torch.abs(m.dot(axes_a[2], L)))
        proj_b = (hb[..., 0] * torch.abs(m.dot(axes_b[0], L))
                  + hb[..., 1] * torch.abs(m.dot(axes_b[1], L))
                  + hb[..., 2] * torch.abs(m.dot(axes_b[2], L)))
        return proj_a + proj_b - torch.abs(m.dot(t, L))

    axes_list = axes_a + axes_b
    pens = [face_pen(ax) for ax in axes_list]
    edge_pens, edge_axes = [], []
    for i in range(3):
        for j in range(3):
            L = m.cross(axes_a[i], axes_b[j])
            ll = m.length(L)
            Ln = L / torch.clamp(ll, min=1e-6)[..., None]
            edge_pens.append(torch.where(ll > 1e-6, face_pen(Ln), torch.inf))
            edge_axes.append(Ln)

    face_pen_all = torch.stack(pens, dim=-1)
    edge_pen_all = torch.stack(edge_pens, dim=-1)
    overlap = torch.all(face_pen_all >= 0.0, dim=-1) & torch.all(
        torch.where(torch.isinf(edge_pen_all), 0.0, edge_pen_all) >= 0.0,
        dim=-1)

    best_face = torch.argmin(face_pen_all, dim=-1)
    best_face_pen = torch.amin(face_pen_all, dim=-1)
    best_edge = torch.argmin(edge_pen_all, dim=-1)
    best_edge_pen = torch.amin(edge_pen_all, dim=-1)
    use_edge = best_edge_pen < 0.95 * best_face_pen - 1e-4

    def orient(n):
        s = torch.where(m.dot(n, t) >= 0.0, 1.0, -1.0)
        return n * s[..., None]

    n_face = orient(_take_row(torch.stack(axes_list, dim=-2), best_face))
    n_edge = orient(_take_row(torch.stack(edge_axes, dim=-2), best_edge))
    ref_is_a = best_face < 3

    # Face manifold, in the reference box's frame.
    ra3, ra33 = ref_is_a[..., None], ref_is_a[..., None, None]
    ref_c = torch.where(ra3, ca, cb)
    ref_R = torch.where(ra33, Ra, Rb)
    ref_h = torch.where(ra3, ha, hb)
    inc_c = torch.where(ra3, cb, ca)
    inc_R = torch.where(ra33, Rb, Ra)
    inc_h = torch.where(ra3, hb, ha)
    n_ref_out = torch.where(ra3, n_face, -n_face)

    n_local = _sum_rows(ref_R, n_ref_out)
    ref_axis = torch.argmax(torch.abs(n_local), dim=-1)
    ref_sign = torch.sign(_take(n_local, ref_axis))
    ref_sign = torch.where(ref_sign == 0.0, 1.0, ref_sign)
    u_axis = (ref_axis + 1) % 3
    v_axis = (ref_axis + 2) % 3

    inc_c_l = _sum_rows(ref_R, inc_c - ref_c)
    inc_R_l = torch.sum(ref_R[..., :, :, None] * inc_R[..., :, None, :],
                        dim=-3)

    # Incident face: the incident box's face most opposed to the normal.
    dots = _sum_rows(inc_R_l, n_local)
    inc_axis = torch.argmax(torch.abs(dots), dim=-1)
    inc_sign = -torch.sign(_take(dots, inc_axis))
    inc_sign = torch.where(inc_sign == 0.0, 1.0, inc_sign)

    def col(Rl, idx):
        return torch.gather(Rl, -1, idx[..., None, None].expand(
            idx.shape + (3, 1)))[..., 0]

    inc_n_l = col(inc_R_l, inc_axis) * inc_sign[..., None]
    inc_u_axis = (inc_axis + 1) % 3
    inc_v_axis = (inc_axis + 2) % 3
    inc_u = col(inc_R_l, inc_u_axis)
    inc_v = col(inc_R_l, inc_v_axis)
    h_n = _take(inc_h, inc_axis)
    h_u = _take(inc_h, inc_u_axis)
    h_v = _take(inc_h, inc_v_axis)

    face_center = inc_c_l + inc_n_l * h_n[..., None]
    signs2 = _const(((1, 1), (1, -1), (-1, -1), (-1, 1)), ca)
    inc_verts = (face_center[..., None, :]
                 + signs2[..., 0, None] * inc_u[..., None, :]
                 * h_u[..., None, None]
                 + signs2[..., 1, None] * inc_v[..., None, :]
                 * h_v[..., None, None])

    def comp4(x, idx):
        return torch.gather(x, -1, idx[..., None, None].expand(
            idx.shape + (x.shape[-2], 1)))[..., 0]

    quad = torch.stack([comp4(inc_verts, u_axis), comp4(inc_verts, v_axis)],
                       dim=-1)
    verts2, vmask = _clip_quad_rect(quad, _take(ref_h, u_axis),
                                    _take(ref_h, v_axis))

    # Heights of the clipped points on the incident face's plane.
    iu_u, iu_v = _take(inc_u, u_axis), _take(inc_u, v_axis)
    iv_u, iv_v = _take(inc_v, u_axis), _take(inc_v, v_axis)
    fc_u, fc_v = _take(face_center, u_axis), _take(face_center, v_axis)
    det = iu_u * iv_v - iu_v * iv_u
    det = torch.where(torch.abs(det) < 1e-9,
                      torch.where(det < 0, -1e-9, 1e-9), det)
    du = verts2[..., 0] - fc_u[..., None]
    dv = verts2[..., 1] - fc_v[..., None]
    a = (du * iv_v[..., None] - dv * iv_u[..., None]) / det[..., None]
    bcoef = (-du * iu_v[..., None] + dv * iu_u[..., None]) / det[..., None]
    iu_n, iv_n = _take(inc_u, ref_axis), _take(inc_v, ref_axis)
    fc_n = _take(face_center, ref_axis)
    height = fc_n[..., None] + a * iu_n[..., None] + bcoef * iv_n[..., None]

    lim_n = _take(ref_h, ref_axis)
    depth_face = lim_n[..., None] - height * ref_sign[..., None]
    pmask_face = vmask & (depth_face >= 0.0)

    score = torch.where(pmask_face, depth_face, -torch.inf)
    _, top_idx = top_k(score, MAX_CONTACT_POINTS)
    depth4 = torch.gather(depth_face, -1, top_idx)
    mask4 = torch.gather(pmask_face, -1, top_idx)
    u4 = torch.gather(verts2[..., 0], -1, top_idx)
    v4 = torch.gather(verts2[..., 1], -1, top_idx)
    h4 = torch.gather(height, -1, top_idx)
    h4_mid = h4 + 0.5 * depth4 * ref_sign[..., None]

    pts_local = torch.zeros(u4.shape + (3,), dtype=ca.dtype, device=ca.device)
    pts_local = _scatter_axis(pts_local, u_axis, u4)
    pts_local = _scatter_axis(pts_local, v_axis, v4)
    pts_local = _scatter_axis(pts_local, ref_axis, h4_mid)
    pts_face = ref_c[..., None, :] + torch.sum(
        ref_R[..., None, :, :] * pts_local[..., :, None, :], dim=-1)

    # Edge-edge contact: the supporting edges' closest points.
    def support_edge(axes, hvec, center, n_dir, edge_axis_idx):
        e_dir = _take_row(torch.stack(axes, dim=-2), edge_axis_idx)
        corner = center
        for i in range(3):
            s = torch.where(m.dot(axes[i], n_dir) >= 0.0, 1.0, -1.0)
            contrib = axes[i] * (s * hvec[..., i])[..., None]
            corner = corner + torch.where((edge_axis_idx == i)[..., None],
                                          0.0, contrib)
        he = _take(hvec, edge_axis_idx)[..., None]
        return corner - e_dir * he, corner + e_dir * he

    a0, a1 = support_edge(axes_a, ha, ca, n_edge, best_edge // 3)
    b0, b1 = support_edge(axes_b, hb, cb, -n_edge, best_edge % 3)
    pa_e, pb_e = closest_points_segment_segment(a0, a1, b0, b1)
    pt_edge = 0.5 * (pa_e + pb_e)

    ue = use_edge[..., None]
    normal = torch.where(ue, n_edge, n_face)
    pen = torch.where(use_edge, best_edge_pen, best_face_pen)
    pts = torch.where(ue[..., None], pt_edge[..., None, :], pts_face)
    dep = torch.where(ue, torch.cat([pen[..., None],
                                     pen.new_zeros(pen.shape + (3,))], -1),
                      depth4)
    first_only = torch.zeros(pen.shape + (4,), dtype=torch.bool,
                             device=pen.device)
    first_only[..., 0] = True
    msk = torch.where(ue, first_only, mask4)
    msk = msk & overlap[..., None] & (dep >= 0.0)
    return normal, pts, dep, msk
