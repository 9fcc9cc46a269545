"""Compute-generated geometry: the meta-balls isosurface and the Koch
fractal (counterpart of ``d3d12renderer_tpu/render/geometry_gen.py``;
reference src/rendering/mesh_shader.cpp:13-25, whose two mesh-shader demos
become compute-style generation: surface nets, table-free dual contouring
in one pass over the field, with a fixed-shape masked output, and the Koch
outline by edge subdivision on the host).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cuda_build import resolve_device


def metaball_field(centers, radii, resolution=32, extent=2.0):
    """(R, R, R) scalar field sum(r_i^2 / |x - c_i|^2) - 1 (isosurface at
    0) and the lattice points (R, R, R, 3), on `centers`' device."""
    dev = centers.device
    g = torch.linspace(-extent, extent, resolution, device=dev)
    gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
    p = torch.stack([gx, gy, gz], -1)
    d2 = torch.sum((p[..., None, :] - centers[None, None, None]) ** 2, -1)
    field = torch.sum(radii[None, None, None] ** 2
                      / torch.clamp(d2, min=1e-6), -1) - 1.0
    return field, p


def surface_nets(field, positions):
    """Naive surface nets over field (R, R, R) at positions (R, R, R, 3):
    fixed-shape (verts (C, 3), vert_valid (C,), quads (E, 4), quad_valid
    (E,)), C the cells and E the crossing-edge slots."""
    r = field.shape[0]
    c = r - 1
    dev = field.device

    def cell(f):
        return torch.stack([
            f[:-1, :-1, :-1], f[1:, :-1, :-1], f[:-1, 1:, :-1], f[1:, 1:, :-1],
            f[:-1, :-1, 1:], f[1:, :-1, 1:], f[:-1, 1:, 1:], f[1:, 1:, 1:],
        ], -1)

    corners = cell(field)                                   # (c, c, c, 8)
    corner_pos = torch.stack([
        positions[:-1, :-1, :-1], positions[1:, :-1, :-1],
        positions[:-1, 1:, :-1], positions[1:, 1:, :-1],
        positions[:-1, :-1, 1:], positions[1:, :-1, 1:],
        positions[:-1, 1:, 1:], positions[1:, 1:, 1:],
    ], -2)                                                   # (c, c, c, 8, 3)

    sign = corners > 0
    crossing = torch.any(sign, -1) & ~torch.all(sign, -1)
    # The vertex of a crossing cell: the |f|-weighted corner centroid.
    wgt = 1.0 / (torch.abs(corners) + 1e-4)
    verts = torch.sum(corner_pos * wgt[..., None], -2) / torch.sum(
        wgt, -1)[..., None]
    verts = verts.reshape(-1, 3)
    vert_valid = crossing.reshape(-1)

    def cell_index(i, j, k):
        return (i * c + j) * c + k

    # A quad across every interior lattice edge whose ends differ in sign,
    # joining the 4 cells around the edge.
    quads, quad_valid = [], []
    ar = torch.arange(1, c, device=dev)
    ii, jj, kk = torch.meshgrid(ar, ar, ar, indexing="ij")
    for axis in range(3):
        f0 = field[1:c, 1:c, 1:c]
        f1 = torch.roll(field, -1, axis)[1:c, 1:c, 1:c]
        crossed = (f0 > 0) != (f1 > 0)
        flip = f0 > 0
        if axis == 0:
            cells = [(ii, jj - 1, kk - 1), (ii, jj, kk - 1),
                     (ii, jj, kk), (ii, jj - 1, kk)]
        elif axis == 1:
            cells = [(ii - 1, jj, kk - 1), (ii, jj, kk - 1),
                     (ii, jj, kk), (ii - 1, jj, kk)]
        else:
            cells = [(ii - 1, jj - 1, kk), (ii, jj - 1, kk),
                     (ii, jj, kk), (ii - 1, jj, kk)]
        q = torch.stack([cell_index(*cix) for cix in cells], -1)
        q = torch.where(flip[..., None], q.flip(-1), q)
        quads.append(q.reshape(-1, 4))
        quad_valid.append(crossed.reshape(-1))
    return verts, vert_valid, torch.cat(quads), torch.cat(quad_valid)


def metaballs_mesh(centers, radii, resolution=32, extent=2.0, device="cuda"):
    """The meta-balls' surface as a compact host `MeshData`: the field and
    surface nets on `device`, the compaction and normals on the host."""
    from ..assets.loaders import generate_normals
    from .mesh import MeshData

    device = resolve_device(device)
    field, pos = metaball_field(
        torch.as_tensor(np.asarray(centers, np.float32), device=device),
        torch.as_tensor(np.asarray(radii, np.float32), device=device),
        resolution, extent)
    verts, _, quads, qv = surface_nets(field, pos)
    verts = verts.cpu().numpy()
    quads = quads[qv].cpu().numpy()
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])

    used = np.unique(tris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    p = verts[used].astype(np.float32)
    t = remap[tris].astype(np.int32)
    mesh = MeshData(p, np.zeros_like(p),
                    np.zeros((len(p), 2), np.float32), t)
    return generate_normals(mesh)


def koch_snowflake(iterations=4, radius=1.0):
    """2D Koch snowflake outline by vectorized edge subdivision
    (reference: the Koch AS/MS demo).  Returns (N, 2) closed polyline."""
    ang = np.array([math.pi / 2 + i * 2 * math.pi / 3 for i in range(3)])
    pts = np.stack([np.cos(ang), np.sin(ang)], -1) * radius
    for _ in range(iterations):
        a = pts
        b = np.roll(pts, -1, 0)
        d = b - a
        p1 = a + d / 3
        p2 = a + d * 2 / 3
        # Outward bump: rotate d/3 by -60 deg.
        rot = np.array([[math.cos(-math.pi / 3), -math.sin(-math.pi / 3)],
                        [math.sin(-math.pi / 3), math.cos(-math.pi / 3)]])
        tip = p1 + (d / 3) @ rot.T
        pts = np.stack([a, p1, tip, p2], 1).reshape(-1, 2)
    return pts.astype(np.float32)


def koch_fractal_3d(iterations=3, radius=1.0, height=0.1):
    """Extrude the snowflake into a render mesh (top face only, like the demo
    geometry)."""
    from .mesh import MeshData

    outline = koch_snowflake(iterations, radius)
    n = len(outline)
    center = outline.mean(0)
    p = np.concatenate([
        np.concatenate([outline, np.full((n, 1), height)], -1),
        [[center[0], center[1], height]],
    ]).astype(np.float32)[:, [0, 2, 1]]  # XZ plane, Y up
    tris = np.stack([
        np.full(n, n), np.arange(n), np.roll(np.arange(n), -1),
    ], -1).astype(np.int32)
    normals = np.tile([0, 1, 0], (n + 1, 1)).astype(np.float32)
    uv = np.zeros((n + 1, 2), np.float32)
    return MeshData(p, normals, uv, tris)
