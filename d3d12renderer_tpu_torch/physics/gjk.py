"""GJK + EPA narrowphase for any convex pair (counterpart of
``d3d12renderer_tpu/physics/gjk.py``).

Both algorithms run a fixed iteration budget with masked convergence, as in
the JAX package, so every pair of a batch takes the same steps.  Every
tensor carries any leading axes (scene, row): sizes, poses and hull tables
are (..., k).  A shape's type is one Python int for all its rows (the pair
dispatch's static combos), so only that type's support is computed, where
the JAX package selects per row over every type.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import maths as m
from .types import (SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CYLINDER, SHAPE_HULL,
                    SHAPE_SPHERE)

GJK_ITERATIONS = 32
EPA_ITERATIONS = 24
EPA_MAX_FACES = 4 + 2 * EPA_ITERATIONS

def _axis_y(x):
    """(..., ) -> (..., 3) vectors (0, x, 0)."""
    z = torch.zeros_like(x)
    return torch.stack([z, x, z], dim=-1)


def support_local(shape_type: int, size, hull_verts, hull_mask, d):
    """Support point in the shape's local frame for local direction d
    (..., 3), not necessarily unit; size (..., 3), hull_verts (..., V, 3),
    hull_mask (..., V)."""
    size, d = torch.broadcast_tensors(size, d)
    if shape_type == SHAPE_SPHERE:
        return m.noz(d) * size[..., 0:1]
    if shape_type == SHAPE_CAPSULE:
        return (_axis_y(torch.sign(d[..., 1]) * size[..., 1])
                + m.noz(d) * size[..., 0:1])
    if shape_type == SHAPE_BOX:
        return torch.where(d >= 0, 1.0, -1.0).to(d.dtype) * size
    if shape_type == SHAPE_CYLINDER:
        dxz = torch.stack([d[..., 0], torch.zeros_like(d[..., 0]),
                           d[..., 2]], dim=-1)
        return (m.noz(dxz) * size[..., 0:1]
                + _axis_y(torch.sign(d[..., 1]) * size[..., 1]))
    if shape_type != SHAPE_HULL:
        raise ValueError(f"no support function for shape type {shape_type}")
    dots = torch.sum(hull_verts * d[..., None, :], dim=-1)
    dots = torch.where(hull_mask, dots, -torch.inf)
    best = torch.argmax(dots, dim=-1)
    verts = hull_verts.expand(dots.shape + (3,))
    return torch.gather(verts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]


class ShapeRef(NamedTuple):
    """World-space convex shapes.  `size` / `hull_verts` describe the CORE
    (margin-shrunk) shape and `margin` the uniform inflation that restores
    the true surface: shallow contacts resolve from the core distance, only
    deep core overlap needs the penetration search."""

    shape_type: int           # one type for every row
    size: torch.Tensor        # (..., 3)
    pos: torch.Tensor         # (..., 3)
    rot: torch.Tensor         # (..., 4)
    hull_verts: torch.Tensor  # (..., V, 3) local
    hull_mask: torch.Tensor   # (..., V)
    margin: torch.Tensor      # (...,)


def make_shape_ref(shape_type: int, size, pos, rot, hull_verts=None,
                   hull_mask=None, max_margin=0.01) -> ShapeRef:
    """ShapeRef from the TRUE shape parameters: spheres and capsules keep a
    point / segment core with their radius as margin; boxes and cylinders
    shrink by delta = min(max_margin, 0.2 * smallest positive size), hulls
    pull each vertex delta toward the centroid; delta is their margin."""
    if hull_verts is None:
        hull_verts = size.new_zeros(size.shape[:-1] + (1, 3))
        hull_mask = torch.zeros(size.shape[:-1] + (1,), dtype=torch.bool,
                                device=size.device)
    r, h = size[..., 0], size[..., 1]
    min_half = torch.min(torch.where(size > 0, size, torch.inf), dim=-1).values
    delta = torch.clamp(0.2 * min_half, max=max_margin)
    core, margin = size, delta
    if shape_type == SHAPE_SPHERE:
        core, margin = torch.zeros_like(size), r
    elif shape_type == SHAPE_CAPSULE:
        core, margin = _axis_y(h), r
    elif shape_type == SHAPE_BOX:
        core = torch.clamp(size - delta[..., None], min=1e-4)
    elif shape_type == SHAPE_CYLINDER:
        core = torch.stack([torch.clamp(r - delta, min=1e-4),
                            torch.clamp(h - delta, min=1e-4),
                            torch.zeros_like(r)], -1)
    elif shape_type == SHAPE_HULL:
        cnt = torch.clamp(torch.sum(hull_mask, -1, keepdim=True), min=1)
        centroid = torch.sum(torch.where(hull_mask[..., None], hull_verts, 0.0),
                             -2) / cnt
        to_c = centroid[..., None, :] - hull_verts
        dist = torch.clamp(torch.sqrt(torch.sum(to_c * to_c, -1, keepdim=True)),
                           min=1e-9)
        hull_verts = hull_verts + to_c / dist * torch.minimum(
            delta[..., None, None], dist * 0.5)
    return ShapeRef(shape_type=shape_type, size=core, pos=pos, rot=rot,
                    hull_verts=hull_verts, hull_mask=hull_mask, margin=margin)


def support_world(s: ShapeRef, d):
    dl = m.quat_inv_rotate(s.rot, d)
    p = support_local(s.shape_type, s.size, s.hull_verts, s.hull_mask, dl)
    return s.pos + m.quat_rotate(s.rot, p)


def minkowski_support(a: ShapeRef, b: ShapeRef, d):
    """Support of A - B in direction d, and the two witness points."""
    pa = support_world(a, d)
    pb = support_world(b, -d)
    return pa - pb, pa, pb


def _seg_bary(p, q):
    """Closest point to the origin on segment pq: (closest, t), weights
    (1 - t, t)."""
    pq = q - p
    t = torch.clamp(-torch.sum(p * pq, -1)
                    / torch.clamp(torch.sum(pq * pq, -1), min=1e-14), 0.0, 1.0)
    return p + pq * t[..., None], t


def _tri_bary(p, q, r):
    """Closest point to the origin on triangle pqr: (closest, weights
    (..., 3) of p, q, r)."""
    n = m.cross(q - p, r - p)
    nn = torch.clamp(torch.sum(n * n, -1), min=1e-16)
    proj = n * (torch.sum(p * n, -1) / nn)[..., None]
    v0, v1, v2 = q - p, r - p, proj - p
    d00 = torch.sum(v0 * v0, -1)
    d01 = torch.sum(v0 * v1, -1)
    d11 = torch.sum(v1 * v1, -1)
    d20 = torch.sum(v2 * v0, -1)
    d21 = torch.sum(v2 * v1, -1)
    den = torch.clamp(d00 * d11 - d01 * d01, min=1e-16)
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    u = 1.0 - v - w
    inside = (u >= 0) & (v >= 0) & (w >= 0)

    # The three edges pq, qr, pr in one batched call.
    c_e, t_e = _seg_bary(torch.stack([p, q, p], -2), torch.stack([q, r, r], -2))
    t_pq, t_qr, t_pr = t_e[..., 0], t_e[..., 1], t_e[..., 2]
    z = torch.zeros_like(t_pq)
    cands = torch.cat([proj[..., None, :], c_e], -2)               # (..., 4, 3)
    weights = torch.stack([
        torch.stack([u, v, w], -1),
        torch.stack([1 - t_pq, t_pq, z], -1),
        torch.stack([z, 1 - t_qr, t_qr], -1),
        torch.stack([1 - t_pr, z, t_pr], -1),
    ], -2)                                                         # (..., 4, 3)
    dist = torch.sum(cands * cands, -1)
    dist = torch.cat([torch.where(inside, dist[..., 0], torch.inf)[..., None],
                      dist[..., 1:]], -1)
    k = torch.argmin(dist, -1)
    return _take(cands, k), _take(weights, k)


def _take(x, k):
    """x (..., K, D) at slot k (...) -> (..., D)."""
    return torch.gather(x, -2, k[..., None, None].expand(
        k.shape + (1, x.shape[-1])))[..., 0, :]


def _set_slot(x, k, v):
    """x (..., K, D) with slot k (...) replaced by v (..., D)."""
    lane = torch.arange(x.shape[-2], device=x.device)
    return torch.where((lane == k[..., None])[..., None], v[..., None, :], x)


# Faces abc, abd, acd, bcd of the tetrahedron abcd, and each face's slots.
_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
# The vertex opposite each face.
_OPPOSITE = (3, 2, 1, 0)


def _simplex_closest(simplex, count):
    """Closest point to the origin on the active k-simplex (..., 4, 3) of
    `count` (...) vertices, its weights (..., 4) per slot, and whether a
    full tetrahedron encloses the origin."""
    a, b = simplex[..., 0, :], simplex[..., 1, :]
    zero = torch.zeros_like(a[..., 0])
    one = torch.ones_like(zero)

    w1 = torch.stack([one, zero, zero, zero], -1)
    c2, t = _seg_bary(a, b)
    w2 = torch.stack([1 - t, t, zero, zero], -1)

    # The four faces in one batched call; face abc is also the k = 3 case.
    fp, fq, fr = (simplex.index_select(-2, m.constant(
        tuple(f[i] for f in _FACES), torch.int64, simplex.device))
        for i in range(3))
    fc, fw3 = _tri_bary(fp, fq, fr)                          # (..., 4, 3)
    fw = torch.zeros(fw3.shape[:-1] + (4,), dtype=fw3.dtype,
                     device=fw3.device)
    for i, face in enumerate(_FACES):
        for j, slot in enumerate(face):
            fw[..., i, slot] = fw3[..., i, j]
    c3, w3 = fc[..., 0, :], fw[..., 0, :]

    # Origin enclosed: for each face, the opposite vertex and the origin lie
    # on the same side.
    nrm = m.cross(fq - fp, fr - fp)
    opposite = simplex.index_select(
        -2, m.constant(_OPPOSITE, torch.int64, simplex.device))
    vs = torch.sum(nrm * (opposite - fp), -1)
    os = torch.sum(nrm * -fp, -1)
    enclosed = torch.all(vs * os >= 0, -1)

    k = torch.argmin(torch.sum(fc * fc, -1), -1)
    c4, w4 = _take(fc, k), _take(fw, k)

    def by_count(x1, x2, x3, x4):
        return torch.where((count <= 1)[..., None], x1,
                           torch.where((count == 2)[..., None], x2,
                                       torch.where((count == 3)[..., None],
                                                   x3, x4)))

    return (by_count(a, c2, c3, c4), by_count(w1, w2, w3, w4),
            enclosed & (count == 4))


def gjk(a: ShapeRef, b: ShapeRef):
    """Overlap flag, termination simplex (EPA's seed) and closest distance
    of separated pairs: Johnson-style sub-simplex reduction by barycentric
    weights over GJK_ITERATIONS fixed iterations."""
    d0 = m.noz(b.pos - a.pos + 1e-6)
    s0, pa0, _ = minkowski_support(a, b, d0)
    simplex = s0[..., None, :].expand(s0.shape[:-1] + (4, 3))
    simplex_a = pa0[..., None, :].expand(simplex.shape)
    count = torch.ones(s0.shape[:-1], dtype=torch.int64, device=s0.device)
    overlap = torch.zeros(s0.shape[:-1], dtype=torch.bool, device=s0.device)
    done = overlap.clone()

    def gather_slots(x, order):
        return torch.gather(x, -2, order[..., None].expand(x.shape))

    for _ in range(GJK_ITERATIONS):
        closest, weights, enclosed = _simplex_closest(simplex, count)
        dist_sq = torch.sum(closest * closest, -1)
        hit_now = (enclosed | (dist_sq < 1e-12)) & ~done
        overlap = overlap | hit_now
        done = done | hit_now

        # Keep the supporting sub-simplex (positive weights), active slots
        # first in their order.
        slot_active = weights > 1e-9
        order = torch.argsort((~slot_active).to(torch.int8), dim=-1,
                              stable=True)
        simplex_r = gather_slots(simplex, order)
        simplex_ar = gather_slots(simplex_a, order)
        new_count = torch.sum(slot_active, -1)

        d = -closest
        s, pa, _ = minkowski_support(a, b, d)
        progress = (torch.sum(s * d, -1)
                    - torch.max(torch.sum(simplex * d[..., None, :], -1),
                                -1).values) > 1e-9
        done = done | ~progress

        # Append the new support after the reduced simplex.
        idx = torch.clamp(new_count, max=3)
        keep = done[..., None, None]
        simplex = torch.where(keep, simplex, _set_slot(simplex_r, idx, s))
        simplex_a = torch.where(keep, simplex_a, _set_slot(simplex_ar, idx, pa))
        count = torch.where(done, count, torch.clamp(new_count + 1, max=4))

    closest, weights, enclosed = _simplex_closest(simplex, count)
    witness_a = torch.sum(weights[..., None] * simplex_a, -2)
    shifted = closest + 1e-12
    return {
        "overlap": overlap | enclosed,
        "simplex": simplex,
        "count": count,
        "distance": torch.sqrt(torch.sum(shifted * shifted, -1)),
        "closest": closest,
        "witness_a": witness_a,
        "witness_b": witness_a - closest,
    }


def epa(a: ShapeRef, b: ShapeRef, simplex):
    """Penetration normal, depth and point from an overlap simplex
    (..., 4, 3): a fixed-budget expanding polytope whose closest face splits
    into three toward its support point each iteration.  The JAX package's
    contact path does not call it (`gjk_epa_contact` takes `sampled_mtd`)."""
    eps_dirs = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, 1.0],
                             [-1.0, 1.0, -1.0], [1.0, -1.0, -1.0]],
                            dtype=simplex.dtype, device=simplex.device) * 1e-3
    verts0 = simplex + eps_dirs
    lead = simplex.shape[:-2]
    dev = simplex.device
    max_v = 4 + EPA_ITERATIONS
    verts = torch.cat([verts0, verts0.new_zeros(lead + (max_v - 4, 3))], -2)
    n_verts = torch.full(lead, 4, dtype=torch.int64, device=dev)
    faces = torch.zeros(lead + (EPA_MAX_FACES, 3), dtype=torch.int64,
                        device=dev)
    faces[..., :4, :] = torch.tensor([[0, 1, 2], [0, 1, 3], [0, 2, 3],
                                      [1, 2, 3]], device=dev)
    face_alive = torch.zeros(lead + (EPA_MAX_FACES,), dtype=torch.bool,
                             device=dev)
    face_alive[..., :4] = True
    n_faces = torch.full(lead, 4, dtype=torch.int64, device=dev)
    centroid = torch.mean(verts0, -2)   # stays inside the polytope

    def face_data(verts, faces, face_alive):
        def corner(i):
            idx = faces[..., i]
            return torch.gather(verts, -2, idx[..., None].expand(
                idx.shape + (3,)))

        va, vb, vc = corner(0), corner(1), corner(2)
        n = m.cross(vb - va, vc - va)
        n = n / torch.clamp(torch.sqrt(torch.sum(n * n, -1, keepdim=True)),
                            min=1e-12)
        # Outward from the interior point: the origin may lie on the
        # boundary for touching contacts.
        flip = torch.sum(n * (va - centroid[..., None, :]), -1) < 0
        n = torch.where(flip[..., None], -n, n)
        dist = torch.clamp(torch.sum(n * va, -1), min=0.0)
        return n, torch.where(face_alive, dist, torch.inf)

    for _ in range(EPA_ITERATIONS):
        normals, dists = face_data(verts, faces, face_alive)
        k = torch.argmin(dists, -1)
        n_best = _take(normals, k)
        s, _, _ = minkowski_support(a, b, n_best)
        d_best = torch.gather(dists, -1, k[..., None])[..., 0]
        grow = torch.sum(s * n_best, -1) - d_best > 1e-5
        can_add = (n_faces + 2 <= EPA_MAX_FACES) & grow

        vi = torch.clamp(n_verts, max=max_v - 1)
        verts = torch.where(can_add[..., None, None],
                            _set_slot(verts, vi, s), verts)
        fk = _take(faces, k)
        i1 = torch.clamp(n_faces, max=EPA_MAX_FACES - 1)
        i2 = torch.clamp(n_faces + 1, max=EPA_MAX_FACES - 1)
        for idx, f in ((k, torch.stack([fk[..., 0], fk[..., 1], vi], -1)),
                       (i1, torch.stack([fk[..., 1], fk[..., 2], vi], -1)),
                       (i2, torch.stack([fk[..., 2], fk[..., 0], vi], -1))):
            faces = torch.where(can_add[..., None, None],
                                _set_slot(faces, idx, f), faces)
            lane = torch.arange(EPA_MAX_FACES, device=dev)
            face_alive = face_alive | ((lane == idx[..., None])
                                       & can_add[..., None])
        n_faces = torch.where(can_add, n_faces + 2, n_faces)
        n_verts = torch.where(can_add, n_verts + 1, n_verts)

    normals, dists = face_data(verts, faces, face_alive)
    k = torch.argmin(dists, -1)
    normal = _take(normals, k)
    depth = torch.gather(dists, -1, k[..., None])[..., 0]
    # The deepest point of A along n and of B along -n; the contact point
    # is their midpoint.
    _, pa, pb = minkowski_support(a, b, normal)
    return {"normal": normal, "depth": depth, "point": 0.5 * (pa + pb)}


def _mtd_base_dirs_np():
    dirs = []
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                if x or y or z:
                    v = np.array([x, y, z], np.float64)
                    dirs.append(v / np.linalg.norm(v))
    return np.stack(dirs).astype(np.float32)  # (26, 3)


_MTD_DIRS = tuple(map(tuple, _mtd_base_dirs_np().tolist()))


def sampled_mtd(a: ShapeRef, b: ShapeRef, seed_dir, rounds=6):
    """Minimum-translation direction by support sampling: depth(d) =
    dot(support_{A-B}(d), d), minimised over unit d from the 26 grid
    directions and the seed, then refined over `rounds` rounds of four
    tangent steps of halving size."""
    def height(d):
        s, _, _ = minkowski_support(a, b, d)
        return torch.sum(s * d, -1)

    dirs = m.constant(_MTD_DIRS, torch.float32, seed_dir.device)
    lead = seed_dir.shape[:-1]
    # All 26 base directions in one call, along a new leading axis.
    hs = height(dirs.reshape((26,) + (1,) * len(lead) + (3,)).expand(
        (26,) + seed_dir.shape))                               # (26, ...)
    best_h = height(seed_dir)
    best_d = seed_dir
    k = torch.argmin(hs, 0)
    base_h = torch.gather(hs, 0, k[None])[0]
    use_base = base_h < best_h
    best_h = torch.where(use_base, base_h, best_h)
    best_d = torch.where(use_base[..., None], dirs[k], best_d)

    step = 0.5
    for _ in range(rounds):
        t1, t2 = m.orthonormal_basis(best_d)
        for (c1, c2) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            cand = m.noz(best_d + step * (c1 * t1 + c2 * t2))
            h = height(cand)
            better = h < best_h
            best_h = torch.where(better, h, best_h)
            best_d = torch.where(better[..., None], cand, best_d)
        step *= 0.5
    return best_d, best_h


def gjk_epa_contact(a: ShapeRef, b: ShapeRef):
    """One-point contact of any convex pair, margin-aware.  Returns
    (normal A -> B (..., 3), point (..., 1, 3), depth (..., 1), hit
    (..., 1)).

    Cores apart but within the margin sum: the exact witness points of the
    GJK distance.  Cores overlapping: the sampled minimum-translation
    direction (an upper bound on the depth that converges from above)."""
    res = gjk(a, b)
    msum = a.margin + b.margin

    # closest = witness_a - witness_b points from B's core toward A's, so
    # the A -> B normal is its negation.
    dist = res["distance"]
    n_shallow = -res["closest"] / torch.clamp(dist, min=1e-9)[..., None]
    depth_shallow = msum - dist
    point_shallow = 0.5 * (res["witness_a"] + a.margin[..., None] * n_shallow
                           + res["witness_b"] - b.margin[..., None] * n_shallow)
    shallow_hit = (~res["overlap"]) & (depth_shallow > 0.0) & (dist > 1e-9)

    n_deep, depth_core = sampled_mtd(a, b, m.noz(b.pos - a.pos))
    depth_deep = depth_core + msum
    _, pa_deep, pb_deep = minkowski_support(a, b, n_deep)
    point_deep = 0.5 * (pa_deep + pb_deep)

    ov = res["overlap"]
    hit = shallow_hit | ov
    normal = torch.where(ov[..., None], n_deep, n_shallow)
    depth = torch.where(ov, depth_deep, depth_shallow)
    point = torch.where(ov[..., None], point_deep, point_shallow)
    return normal, point[..., None, :], depth[..., None], hit[..., None]
