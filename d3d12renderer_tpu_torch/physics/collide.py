"""Contact generation (counterpart of
``d3d12renderer_tpu/physics/collide.py``): plane rows, terrain rows, the
static collider-pair buckets and the runtime broadphase's rows.

The row order is the builder's: plane rows sorted by collider type, terrain
rows sorted by collider type, then the buckets in sorted (type_a, type_b)
order, then the runtime broadphase's rows (physics/broadphase.py).  The colored solver's color lists index that
order, so it must not change.  Static rows name their bodies with (P,)
tensors shared by every scene; the broadphase's rows differ per scene, so a
table with them names its bodies with (B, P) tensors.
"""

from __future__ import annotations

import torch

from ..core import maths as m
from . import gjk as gjk_mod
from . import narrow
from .narrow import ContactTable
from .types import (SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CYLINDER, SHAPE_HULL,
                    SHAPE_SPHERE, BodyState, ContactBucket, SceneArchetype)


def collider_world_poses(arch: SceneArchetype, state: BodyState):
    """World pose of every collider: (B, C, 3) positions, (B, C, 4) rotations.
    Body render position = cog - rot * local_cog."""
    b = torch.clamp(arch.col_body, 0, state.pos.shape[-2] - 1)
    bpos = state.pos[:, b]
    brot = state.rot[:, b]
    cog = arch.local_cog[b]
    wpos = bpos + m.quat_rotate(brot, arch.col_local_pos - cog)
    wrot = m.quat_mul(brot, arch.col_local_rot)
    return wpos, wrot


def colliders_of_type(arch: SceneArchetype, shape: int):
    """The indices of the colliders of one shape type, a device tensor
    built once per archetype."""
    key = ("colliders_of_type", shape)
    if key not in arch.cache:
        arch.cache[key] = torch.nonzero(arch.col_type.cpu() == shape)[:, 0].to(
            arch.col_type.device)
    return arch.cache[key]


def _capsule_endpoints(wpos, wrot, half_len):
    up = m.constant((0.0, 1.0, 0.0), wpos.dtype, wpos.device)
    axis = m.quat_rotate(wrot, up.expand(wpos.shape))
    return wpos - axis * half_len[..., None], wpos + axis * half_len[..., None]


def _pad4(p, d, k):
    """Pad a manifold of K < 4 points to 4 (zeros, mask off)."""
    pad = 4 - d.shape[-1]
    if pad == 0:
        return p, d, k
    return (torch.cat([p, p.new_zeros(p.shape[:-2] + (pad, 3))], dim=-2),
            torch.cat([d, d.new_zeros(d.shape[:-1] + (pad,))], dim=-1),
            torch.cat([k, k.new_zeros(k.shape[:-1] + (pad,))], dim=-1))


def _collider_vs_local_plane(arch: SceneArchetype, ci, cpos, crot, n, off,
                             segments):
    """Per-row manifold of collider `ci` against a per-row plane; each static
    (shape_type, start, end) segment runs only its own narrowphase."""
    pts_parts, dep_parts, msk_parts = [], [], []
    for (stype, s, e) in segments:
        size = arch.col_size[ci[s:e]]
        cpos_s, crot_s = cpos[:, s:e], crot[:, s:e]
        n_s, off_s = n[:, s:e], off[:, s:e]
        if stype == SHAPE_SPHERE:
            p, d, k = _pad4(*narrow.sphere_vs_plane(cpos_s, size[..., 0], n_s,
                                                    off_s))
        elif stype == SHAPE_CAPSULE:
            p0, p1 = _capsule_endpoints(cpos_s, crot_s, size[..., 1])
            p, d, k = _pad4(*narrow.capsule_vs_plane(p0, p1, size[..., 0], n_s,
                                                     off_s))
        elif stype == SHAPE_BOX:
            p, d, k = narrow.box_vs_plane(cpos_s, crot_s, size, n_s, off_s)
        elif stype == SHAPE_CYLINDER:
            p, d, k = narrow.cylinder_vs_plane(cpos_s, crot_s, size[..., 0],
                                               size[..., 1], n_s, off_s)
        elif stype == SHAPE_HULL:
            hv = arch.col_hull_verts[ci[s:e]]
            hm = arch.col_hull_mask[ci[s:e]]
            wverts = cpos_s[..., None, :] + m.quat_rotate(crot_s[..., None, :],
                                                          hv)
            p, d, k = narrow.hull_vs_plane(wverts, hm, n_s, off_s)
            k = k & torch.any(hm, -1)[:, None]
        else:
            raise NotImplementedError(
                f"plane narrowphase for shape type {stype}")
        pts_parts.append(p)
        dep_parts.append(d)
        msk_parts.append(k)
    return (torch.cat(pts_parts, dim=-3), torch.cat(dep_parts, dim=-2),
            torch.cat(msk_parts, dim=-2))


def _vs_plane_manifolds(arch: SceneArchetype, wpos, wrot):
    """Manifolds for every (dynamic collider, plane) row."""
    ci, pi = arch.vs_plane_collider, arch.vs_plane_plane
    cpos, crot = wpos[:, ci], wrot[:, ci]
    n = arch.plane_normal[pi].expand(cpos.shape)
    off = arch.plane_offset[pi].expand(cpos.shape[:-1])
    pts, dep, msk = _collider_vs_local_plane(arch, ci, cpos, crot, n, off,
                                             arch.vs_plane_segments)
    friction, restitution = narrow.combine_materials(
        arch.col_friction[ci], arch.plane_friction[pi],
        arch.col_restitution[ci], arch.plane_restitution[pi])
    msk = msk & arch.vs_plane_valid[:, None]
    return ContactTable(
        body_a=torch.full_like(arch.vs_plane_body, arch.world_body),
        body_b=arch.vs_plane_body,
        normal=n,
        point=pts,
        depth=dep,
        pmask=msk,
        friction=friction.expand(dep.shape[:-1]),
        restitution=restitution.expand(dep.shape[:-1]),
        active=torch.any(msk, dim=-1),
    )


_BOX_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                   for sz in (-1.0, 1.0))


def _vs_terrain_manifolds(arch: SceneArchetype, wpos, wrot):
    """Collider vs heightfield rows.  Every row collides against the
    bilinear tangent plane through the surface point under the collider;
    with `arch.terrain_tri_exact`, box and hull rows instead take the mip
    descent's triangles (physics/heightmap_collision.py), and keep the
    tangent plane where the descent overflows."""
    from ..terrain.heightmap import sample_height_bilinear

    ci, ti = arch.vs_terrain_collider, arch.vs_terrain_terrain
    cpos, crot = wpos[:, ci], wrot[:, ci]
    hgt = n = None
    for t in range(arch.num_terrains):
        h_t, n_t = sample_height_bilinear(
            arch.terrain_height[t], arch.terrain_origin[t],
            arch.terrain_cell[t], cpos[..., 0], cpos[..., 2])
        if hgt is None:
            hgt, n = h_t, n_t
        else:
            on_t = ti == t
            hgt = torch.where(on_t, h_t, hgt)
            n = torch.where(on_t[:, None], n_t, n)
    # The tangent plane through the surface point under the collider.
    surf = torch.stack([cpos[..., 0], hgt, cpos[..., 2]], -1)
    off = torch.sum(n * surf, -1)
    pts, dep, msk = _collider_vs_local_plane(arch, ci, cpos, crot, n, off,
                                             arch.vs_terrain_segments)

    if arch.terrain_tri_exact:
        from .heightmap_collision import (convex_vs_terrain_triangles,
                                          terrain_mips)
        levels = terrain_mips(arch)
        pts, dep, msk, n = pts.clone(), dep.clone(), msk.clone(), n.clone()
        batch = cpos.shape[0]
        for (stype, s, e) in arch.vs_terrain_segments:
            ci_s, ti_s = ci[s:e], ti[s:e]
            cpos_s, crot_s = cpos[:, s:e], crot[:, s:e]
            size = arch.col_size[ci_s].expand(cpos_s.shape)
            hv = arch.col_hull_verts[ci_s].expand((batch,) + (e - s,)
                                                  + arch.col_hull_verts.shape[1:])
            hm = arch.col_hull_mask[ci_s].expand(hv.shape[:-1])
            if stype == SHAPE_BOX:
                signs = m.constant(_BOX_SIGNS, cpos.dtype, cpos.device)
                verts = cpos_s[..., None, :] + m.quat_rotate(
                    crot_s[..., None, :], signs * size[..., None, :])
                vmask = torch.ones(verts.shape[:-1], dtype=torch.bool,
                                   device=cpos.device)
            elif stype == SHAPE_HULL:
                verts = cpos_s[..., None, :] + m.quat_rotate(
                    crot_s[..., None, :], hv)
                vmask = hm
            else:
                continue
            col_ref = gjk_mod.make_shape_ref(stype, size, cpos_s, crot_s,
                                             hv, hm)
            tp, td, tm, tn, tov = convex_vs_terrain_triangles(
                arch.terrain_height, levels,
                arch.terrain_origin[ti_s].expand(cpos_s.shape),
                arch.terrain_cell[ti_s].expand(cpos_s.shape[:-1]),
                verts, vmask, col_ref, ti_s.expand(cpos_s.shape[:-1]))
            # An overflowing descent dropped candidate cells: those rows
            # keep the tangent plane's manifold.
            ok = tov == 0
            pts[:, s:e] = torch.where(ok[..., None, None], tp, pts[:, s:e])
            dep[:, s:e] = torch.where(ok[..., None], td, dep[:, s:e])
            msk[:, s:e] = torch.where(ok[..., None], tm, msk[:, s:e])
            n[:, s:e] = torch.where(ok[..., None], tn, n[:, s:e])

    friction, restitution = narrow.combine_materials(
        arch.col_friction[ci], arch.terrain_friction[ti],
        arch.col_restitution[ci], arch.terrain_restitution[ti])
    msk = msk & arch.vs_terrain_valid[:, None]
    return ContactTable(
        body_a=torch.full_like(arch.vs_terrain_body, arch.world_body),
        body_b=arch.vs_terrain_body,
        normal=n,
        point=pts,
        depth=dep,
        pmask=msk,
        friction=friction.expand(dep.shape[:-1]),
        restitution=restitution.expand(dep.shape[:-1]),
        active=torch.any(msk, dim=-1),
    )


def pair_narrow_dispatch(arch: SceneArchetype, ia, ib, ta: int, tb: int,
                         pa, ra, pb, rb):
    """Narrowphase of the pair rows of one static (type_a, type_b) combo,
    ta <= tb, colliders `ia`, `ib` (P,) or (B, P) at world poses (B, P, 3 /
    4).  Returns 4-point manifolds (normal, points, depths, masks).  Any
    pair with a hull or a cylinder goes through the margin-aware GJK
    (physics/gjk.py): one point."""
    sa = arch.col_size[ia].expand(pa.shape)
    sb = arch.col_size[ib].expand(pb.shape)
    if (ta, tb) == (SHAPE_SPHERE, SHAPE_SPHERE):
        out = narrow.sphere_vs_sphere(pa, sa[..., 0], pb, sb[..., 0])
    elif (ta, tb) == (SHAPE_SPHERE, SHAPE_CAPSULE):
        b0, b1 = _capsule_endpoints(pb, rb, sb[..., 1])
        out = narrow.sphere_vs_capsule(pa, sa[..., 0], b0, b1, sb[..., 0])
    elif (ta, tb) == (SHAPE_CAPSULE, SHAPE_CAPSULE):
        a0, a1 = _capsule_endpoints(pa, ra, sa[..., 1])
        b0, b1 = _capsule_endpoints(pb, rb, sb[..., 1])
        out = narrow.capsule_vs_capsule(a0, a1, sa[..., 0], b0, b1,
                                        sb[..., 0])
    elif (ta, tb) == (SHAPE_SPHERE, SHAPE_BOX):
        out = narrow.sphere_vs_box(pa, sa[..., 0], pb, rb, sb)
    elif (ta, tb) == (SHAPE_CAPSULE, SHAPE_BOX):
        a0, a1 = _capsule_endpoints(pa, ra, sa[..., 1])
        out = narrow.capsule_vs_box(a0, a1, sa[..., 0], pb, rb, sb)
    elif (ta, tb) == (SHAPE_BOX, SHAPE_BOX):
        out = narrow.box_vs_box(pa, ra, sa, pb, rb, sb)
    elif SHAPE_HULL in (ta, tb) or SHAPE_CYLINDER in (ta, tb):
        a_ref = gjk_mod.make_shape_ref(
            ta, sa, pa, ra, arch.col_hull_verts[ia].expand(pa.shape[:-1]
                                                           + (-1, 3)),
            arch.col_hull_mask[ia].expand(pa.shape[:-1] + (-1,)))
        b_ref = gjk_mod.make_shape_ref(
            tb, sb, pb, rb, arch.col_hull_verts[ib].expand(pb.shape[:-1]
                                                           + (-1, 3)),
            arch.col_hull_mask[ib].expand(pb.shape[:-1] + (-1,)))
        out = gjk_mod.gjk_epa_contact(a_ref, b_ref)
    else:
        raise NotImplementedError(f"narrowphase pair ({ta}, {tb})")
    normal, pts, dep, msk = out
    return (normal,) + _pad4(pts, dep, msk)


def _bucket_manifolds(arch: SceneArchetype, bucket: ContactBucket, wpos,
                      wrot):
    ia, ib = bucket.collider_a, bucket.collider_b
    normal, pts, dep, msk = pair_narrow_dispatch(
        arch, ia, ib, bucket.type_a, bucket.type_b, wpos[:, ia], wrot[:, ia],
        wpos[:, ib], wrot[:, ib])
    msk = msk & bucket.valid[:, None]
    friction, restitution = narrow.combine_materials(
        arch.col_friction[ia], arch.col_friction[ib],
        arch.col_restitution[ia], arch.col_restitution[ib])
    return ContactTable(
        body_a=bucket.body_a,
        body_b=bucket.body_b,
        normal=normal,
        point=pts,
        depth=dep,
        pmask=msk,
        friction=friction.expand(dep.shape[:-1]),
        restitution=restitution.expand(dep.shape[:-1]),
        active=torch.any(msk, dim=-1),
    )


def _concat_tables(tables) -> ContactTable:
    def cat(attr, dim):
        return torch.cat([getattr(t, attr) for t in tables], dim=dim)

    return ContactTable(
        body_a=cat("body_a", -1),
        body_b=cat("body_b", -1),
        normal=cat("normal", -2),
        point=cat("point", -3),
        depth=cat("depth", -2),
        pmask=cat("pmask", -2),
        friction=cat("friction", -1),
        restitution=cat("restitution", -1),
        active=cat("active", -1),
    )


def generate_contacts(arch: SceneArchetype, state: BodyState):
    """The whole contact table, plane rows first, then terrain rows, each
    pair bucket and the runtime broadphase's rows, in the order the builder
    colored; None for a scene without any row."""
    if arch.num_contact_rows == 0 and arch.sap_neighbors == 0:
        return None
    wpos, wrot = collider_world_poses(arch, state)
    tables = []
    if arch.vs_plane_collider.shape[0] > 0:
        tables.append(_vs_plane_manifolds(arch, wpos, wrot))
    if arch.vs_terrain_collider.shape[0] > 0:
        tables.append(_vs_terrain_manifolds(arch, wpos, wrot))
    for bucket in arch.contact_buckets:
        tables.append(_bucket_manifolds(arch, bucket, wpos, wrot))
    if arch.sap_neighbors > 0:
        from . import broadphase
        sap = broadphase.sap_manifolds(arch, wpos, wrot)
        # Static rows take the broadphase's per-scene (B, P) body indices.
        batch = wpos.shape[0]
        for t in tables:
            t.body_a = t.body_a.expand(batch, -1)
            t.body_b = t.body_b.expand(batch, -1)
        tables.append(sap)
    return tables[0] if len(tables) == 1 else _concat_tables(tables)
