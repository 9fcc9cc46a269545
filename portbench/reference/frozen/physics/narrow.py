"""Narrowphase of sphere, capsule and box colliders against static planes
(counterpart of the JAX package's ``physics/narrow.py``, trimmed to the
ragdoll on its ground plane).

Manifold conventions are the JAX package's: the normal points from A (the
plane) toward B, depth >= 0 when touching, and each point sits midway
between the two surfaces.  Every function runs over leading (batch, row)
axes.  The JAX package left these functions to XLA outside its kernels;
here they are plain PyTorch.
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


# ---------------------------------------------------------------------------
# Collider pairs.  A and B are the pair's colliders in canonical type order
# (sphere < capsule < box); the normal points from A toward B.
# ---------------------------------------------------------------------------

_NEXT = (1, 2, 3, 0)


