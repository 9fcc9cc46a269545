"""The collider-pair narrowphase of sphere and box colliders (counterpart
of the JAX package's ``physics/narrow.py`` pair functions, frozen): the
flythrough pile's sphere-sphere, sphere-box and box-box manifolds.

Manifold conventions are the JAX package's: the normal points from the
pair's first collider toward the second, depth >= 0 when touching, and each
point sits midway between the two surfaces.  Every function takes its
arguments at the full leading (batch, row) shape.  Plain PyTorch.
"""

from __future__ import annotations

import torch

from ..core import maths as m
from .types import MAX_CONTACT_POINTS

_NEXT = (1, 2, 3, 0)


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
