"""Contact generation (counterpart of
the JAX package's ``physics/collide.py``), trimmed to plane rows of sphere,
capsule and box colliders: the ragdoll on its ground plane.

The row order is the builder's: plane rows sorted by collider type.  The
colored solver's color lists index that order, so it must not change.
"""

from __future__ import annotations

import torch

from ..core import maths as m
from . import narrow
from .narrow import ContactTable
from .types import (SHAPE_BOX, SHAPE_CAPSULE, SHAPE_SPHERE, BodyState,
                    SceneArchetype)


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


def generate_contacts(arch: SceneArchetype, state: BodyState):
    """The contact table of the plane rows, in the order the builder
    colored; None for a scene without any row."""
    if arch.num_contact_rows == 0 and arch.sap_neighbors == 0:
        return None
    wpos, wrot = collider_world_poses(arch, state)
    tables = []
    if arch.vs_plane_collider.shape[0] > 0:
        tables.append(_vs_plane_manifolds(arch, wpos, wrot))
    if (arch.vs_terrain_collider.shape[0] > 0 or arch.contact_buckets
            or arch.sap_neighbors > 0):
        raise NotImplementedError("the frozen reference has plane rows only")
    return tables[0]
