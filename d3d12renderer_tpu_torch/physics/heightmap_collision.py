"""Triangle-exact heightfield collision by min-max mip descent (counterpart
of ``d3d12renderer_tpu/physics/heightmap_collision.py``).

A collider's AABB descends a min-max pyramid over the height grid's cells
with a fixed candidate table per level (MIP_CANDIDATES cells, each expanded
into its four children and compacted back by a stable top-k, the lower
index first on ties, as JAX's `lax.top_k`); the candidate cells' two
triangles then meet the collider's vertices and, in the convex path,
GJK / EPA against each triangle.  Where the descent drops cells (overflow)
the caller keeps the tangent-plane manifold.

Every function takes any leading axes (scene, row).  The mips of all of a
scene's terrains are built once, by the builder (`finalize`), as (T, P, P)
levels; a row names its terrain by index.
"""

from __future__ import annotations

import torch

from ..core import maths as m
from .broadphase import top_k
from .gjk import ShapeRef, gjk_epa_contact
from .types import SHAPE_HULL

MIP_CANDIDATES = 16   # cells kept per level of the descent

_CHILDREN = ((0, 0), (0, 1), (1, 0), (1, 1))


def build_minmax_mips(heights):
    """Min / max pyramid over leaf cells (a cell spans 4 corner samples).

    heights (..., R0, R1) -> list of (lo, hi), coarse (1, 1) first, down to
    the leaf level (P, P), P the next power of two >= max(R0, R1) - 1.
    Padding cells hold +inf / -inf so that they never meet a y-range."""
    h = heights
    lo = torch.minimum(torch.minimum(h[..., :-1, :-1], h[..., 1:, :-1]),
                       torch.minimum(h[..., :-1, 1:], h[..., 1:, 1:]))
    hi = torch.maximum(torch.maximum(h[..., :-1, :-1], h[..., 1:, :-1]),
                       torch.maximum(h[..., :-1, 1:], h[..., 1:, 1:]))
    cells = max(lo.shape[-2:])
    p = 1
    while p < cells:
        p *= 2
    pad = (0, p - lo.shape[-1], 0, p - lo.shape[-2])
    lo = torch.nn.functional.pad(lo, pad, value=torch.inf)
    hi = torch.nn.functional.pad(hi, pad, value=-torch.inf)
    levels = [(lo, hi)]
    while levels[-1][0].shape[-1] > 1:
        lo, hi = levels[-1]
        lo = torch.minimum(
            torch.minimum(lo[..., 0::2, 0::2], lo[..., 1::2, 0::2]),
            torch.minimum(lo[..., 0::2, 1::2], lo[..., 1::2, 1::2]))
        hi = torch.maximum(
            torch.maximum(hi[..., 0::2, 0::2], hi[..., 1::2, 0::2]),
            torch.maximum(hi[..., 0::2, 1::2], hi[..., 1::2, 1::2]))
        levels.append((lo, hi))
    return levels[::-1]


def terrain_mips(arch):
    """The archetype's mips over all its terrains, (T, P, P) per level,
    built on first use and kept in `arch.cache` (the builder builds them
    when it compiles a triangle-exact scene)."""
    if "terrain_mips" not in arch.cache:
        arch.cache["terrain_mips"] = build_minmax_mips(arch.terrain_height)
    return arch.cache["terrain_mips"]


def _cell_lookup(grid, terrain, i, j):
    """grid (T, P0, P1) or (P0, P1) at per-row terrain `terrain` and cells
    (i, j) of shape terrain.shape + (K,)."""
    p0, p1 = grid.shape[-2:]
    flat = grid.reshape(-1)
    return flat[(terrain[..., None] * p0 + i) * p1 + j]


def _descend(levels, origin, cell, lo3, hi3, terrain=None,
             k: int = MIP_CANDIDATES):
    """AABB (lo3, hi3) (..., 3) -> (cells (..., K, 2) leaf indices, valid
    (..., K), overflow (...)): per level the candidates' children that
    overlap the AABB in x, z and y, at most K kept.  `levels` from
    `build_minmax_mips` of one terrain ((P, P) maps) or of several
    ((T, P, P), with `terrain` (...) naming each row's)."""
    lead = lo3.shape[:-1]
    dev = lo3.device
    if terrain is None:
        terrain = torch.zeros(lead, dtype=torch.int64, device=dev)
    u0 = (lo3[..., 0] - origin[..., 0]) / cell
    u1 = (hi3[..., 0] - origin[..., 0]) / cell
    v0 = (lo3[..., 2] - origin[..., 2]) / cell
    v1 = (hi3[..., 2] - origin[..., 2]) / cell
    y0 = lo3[..., 1] - origin[..., 1]
    y1 = hi3[..., 1] - origin[..., 1]

    n_levels = len(levels)
    ci = torch.zeros(lead + (k, 2), dtype=torch.int64, device=dev)
    valid = torch.zeros(lead + (k,), dtype=torch.bool, device=dev)
    valid[..., 0] = True                       # level 0 is the one cell
    overflow = torch.zeros(lead, dtype=torch.int64, device=dev)
    children = m.constant(_CHILDREN, torch.int64, dev)
    score_base = 4 * k - torch.arange(4 * k, device=dev)

    for lev in range(1, n_levels):
        lo_map, hi_map = levels[lev]
        scale = 2 ** (n_levels - 1 - lev)      # leaf cells per cell here
        child = (ci[..., :, None, :] * 2 + children).reshape(lead + (4 * k, 2))
        cvalid = valid.repeat_interleave(4, dim=-1)
        cu0 = child[..., 0].to(lo3.dtype) * scale
        cv0 = child[..., 1].to(lo3.dtype) * scale
        in_u = (cu0 <= u1[..., None]) & (cu0 + scale >= u0[..., None])
        in_v = (cv0 <= v1[..., None]) & (cv0 + scale >= v0[..., None])
        clo = _cell_lookup(lo_map, terrain, child[..., 0], child[..., 1])
        chi = _cell_lookup(hi_map, terrain, child[..., 0], child[..., 1])
        in_y = (clo <= y1[..., None]) & (chi >= y0[..., None])
        keep = cvalid & in_u & in_v & in_y

        count = keep.sum(-1)
        overflow = overflow + torch.clamp(count - k, min=0)
        score = torch.where(keep, score_base, 0)
        _, sel = top_k(score, k)
        ci = torch.gather(child, -2, sel[..., None].expand(lead + (k, 2)))
        valid = torch.gather(keep, -1, sel)
    return ci, valid, overflow


def _candidate_tris(heights, levels, origin, cell, lo3, hi3, terrain=None):
    """AABB -> candidate triangles of the descent: (tv (..., 2K, 3, 3)
    world vertices, tvalid (..., 2K), n (..., 2K, 3) upward unit normals,
    overflow (...)).  Cell (i, j) splits into [(i, j), (i+1, j), (i, j+1)]
    and [(i, j+1), (i+1, j), (i+1, j+1)], as the render mesh."""
    cells, cvalid, overflow = _descend(levels, origin, cell, lo3, hi3,
                                       terrain)
    if terrain is None:
        terrain = torch.zeros(lo3.shape[:-1], dtype=torch.int64,
                              device=lo3.device)
    r0, r1 = heights.shape[-2:]
    i = torch.clamp(cells[..., 0], 0, r0 - 2)
    j = torch.clamp(cells[..., 1], 0, r1 - 2)
    o = origin[..., None, :]
    c = cell[..., None]

    def corner(di, dj):
        x = o[..., 0] + (i + di).to(lo3.dtype) * c
        z = o[..., 2] + (j + dj).to(lo3.dtype) * c
        y = o[..., 1] + _cell_lookup(heights, terrain, i + di, j + dj)
        return torch.stack([x, y, z], -1)

    p00, p10, p01, p11 = corner(0, 0), corner(1, 0), corner(0, 1), corner(1, 1)
    tris = torch.stack([torch.stack([p00, p10, p01], -2),
                        torch.stack([p01, p10, p11], -2)], -3)
    tv = tris.reshape(tris.shape[:-4] + (-1, 3, 3))       # (..., 2K, 3, 3)
    tvalid = cvalid.repeat_interleave(2, dim=-1)
    a, b, cc = tv[..., 0, :], tv[..., 1, :], tv[..., 2, :]
    n = m.cross(b - a, cc - a)
    n = n / torch.clamp(m.length(n), min=1e-9)[..., None]
    n = torch.where(n[..., 1:2] < 0, -n, n)
    return tv, tvalid, n, overflow


def _vertex_table(verts, vmask, tv, tvalid, n):
    """Depth of every (vertex, triangle) pair whose xz projection falls in
    the triangle with the vertex below its plane, -inf elsewhere: (...,
    V * 2K), vertex-major."""
    a, b, c = tv[..., 0, :], tv[..., 1, :], tv[..., 2, :]
    v2 = verts[..., :, None, 0::2]                        # (..., V, 1, 2)
    a2, b2, c2 = (x[..., None, :, 0::2] for x in (a, b, c))
    d00 = b2 - a2
    d01 = c2 - a2
    dp = v2 - a2
    den = d00[..., 0] * d01[..., 1] - d00[..., 1] * d01[..., 0]
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    bu = (dp[..., 0] * d01[..., 1] - dp[..., 1] * d01[..., 0]) / den
    bv = (d00[..., 0] * dp[..., 1] - d00[..., 1] * dp[..., 0]) / den
    inside = (bu >= -1e-4) & (bv >= -1e-4) & (bu + bv <= 1.0 + 1e-4)
    depth = torch.sum(n[..., None, :, :] * (a[..., None, :, :]
                                            - verts[..., :, None, :]), -1)
    ok = inside & (depth > 0) & tvalid[..., None, :] & vmask[..., :, None]
    depth = torch.where(ok, depth, -torch.inf)
    return depth.reshape(depth.shape[:-2] + (-1,))


def _aabb(verts, vmask):
    lo3 = torch.where(vmask[..., None], verts, torch.inf).amin(-2)
    hi3 = torch.where(vmask[..., None], verts, -torch.inf).amax(-2)
    return lo3, hi3


def _gather_rows(x, idx):
    """x (..., R, 3) rows at idx (..., k) -> (..., k, 3)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))


def _manifold(vals, points, per_n):
    """Deepest-4 manifold: (points, depths, mask, one normal blended from
    the contacts' normals by depth, the deepest dominating)."""
    mask = vals > 0
    depths = torch.where(mask, vals, 0.0)
    blended = torch.sum(depths[..., None] * per_n, -2)
    blen = m.length(blended)
    normal = torch.where((blen > 1e-9)[..., None],
                         blended / torch.clamp(blen, min=1e-9)[..., None],
                         per_n[..., 0, :])
    return points, depths, mask, normal


def vertex_vs_terrain_triangles(heights, levels, origin, cell, verts, vmask,
                                terrain=None):
    """Deepest <= 4 vertex-vs-triangle contacts of a vertex cloud (..., V,
    3) against the heightfield.  Returns (points (..., 4, 3), depths (...,
    4), mask (..., 4), normal (..., 3), overflow (...)); overflow > 0 means
    the descent dropped cells and the caller keeps the tangent plane."""
    lo3, hi3 = _aabb(verts, vmask)
    tv, tvalid, n, overflow = _candidate_tris(heights, levels, origin, cell,
                                              lo3, hi3, terrain)
    flat = _vertex_table(verts, vmask, tv, tvalid, n)
    vals, sel = top_k(flat, 4)
    nt = tv.shape[-3]
    points = _gather_rows(verts, sel // nt)
    per_n = _gather_rows(n, sel % nt)
    return _manifold(vals, points, per_n) + (overflow,)


def convex_vs_terrain_triangles(heights, levels, origin, cell, verts, vmask,
                                col_ref: ShapeRef, terrain=None):
    """Vertex tests plus GJK / EPA of the collider against each candidate
    triangle (a 3-vertex hull at the origin), which finds the edge and face
    contacts the vertices miss (a wide flat box on a ridge); the deepest 4
    of both form the manifold.  `col_ref` is the collider's ShapeRef with
    the same leading axes as `verts`.  Returns as
    `vertex_vs_terrain_triangles`."""
    lo3, hi3 = _aabb(verts, vmask)
    tv, tvalid, n, overflow = _candidate_tris(heights, levels, origin, cell,
                                              lo3, hi3, terrain)
    flat = _vertex_table(verts, vmask, tv, tvalid, n)     # (..., V * nt)
    lead = tv.shape[:-3]
    nt = tv.shape[-3]

    zeros3 = tv.new_zeros(lead + (nt, 3))
    tri_ref = ShapeRef(
        shape_type=SHAPE_HULL, size=zeros3, pos=zeros3,
        rot=m.constant((0.0, 0.0, 0.0, 1.0), tv.dtype,
                       tv.device).expand(lead + (nt, 4)),
        hull_verts=tv, hull_mask=torch.ones(lead + (nt, 3), dtype=torch.bool,
                                            device=tv.device),
        margin=tv.new_zeros(lead + (nt,)))
    axis = len(lead)
    col_b = ShapeRef(col_ref.shape_type, *(
        x.unsqueeze(axis).expand(lead + (nt,) + x.shape[axis:])
        for x in col_ref[1:]))
    # The triangle -> collider normal points off the terrain surface.
    g_n, g_p, g_d, g_hit = gjk_epa_contact(tri_ref, col_b)
    g_p, g_d, g_hit = g_p[..., 0, :], g_d[..., 0], g_hit[..., 0]
    # Only contacts that push out of the surface: the zero-thickness
    # triangle as a solid hull also offers pop-through-the-bottom MTDs.
    g_ok = g_hit & tvalid & (g_d > 0) & (torch.sum(g_n * n, -1) > 0.0)
    g_dm = torch.where(g_ok, g_d, -torch.inf)

    vals, sel = top_k(torch.cat([flat, g_dm], -1), 4)
    nflat = flat.shape[-1]
    is_g = (sel >= nflat)[..., None]
    vsel = torch.clamp(sel, max=nflat - 1)
    gsel = torch.clamp(sel - nflat, 0, nt - 1)
    points = torch.where(is_g, _gather_rows(g_p, gsel),
                         _gather_rows(verts, vsel // nt))
    per_n = torch.where(is_g, _gather_rows(g_n, gsel),
                        _gather_rows(n, vsel % nt))
    return _manifold(vals, points, per_n) + (overflow,)
