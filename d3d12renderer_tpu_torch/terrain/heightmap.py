"""Procedural heightmaps, their meshes and splat shading, and their
bilinear surface (counterpart of ``d3d12renderer_tpu/terrain/heightmap.py``:
`_hash2`, `_value_noise`, `fbm`, `generate_heightmap`, `heightmap_normals`,
`heightmap_mesh`, `terrain_lod_chunks`, `splat_weights`, `shade_splat` and
`sample_height_bilinear`).

The lattice hash is the JAX package's uint32 arithmetic, computed in int64
with the low 32 bits kept after every multiply and add, so that it equals
JAX's bit for bit.  The noise's float32 operations follow the JAX module's
order.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF


def _hash2(ix, iy, seed: int):
    """Integer lattice hash (int tensors, a Python int seed) -> float32 in
    [0, 1), as the JAX package's uint32 hash."""
    x = ix.to(torch.int64) & _MASK
    y = iy.to(torch.int64) & _MASK
    h = (((x * 374761393) & _MASK) + ((y * 668265263) & _MASK)
         + ((seed & _MASK) * 2654435761 & _MASK)) & _MASK
    h = ((h ^ (h >> 13)) * 1274126177) & _MASK
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) / float(1 << 24)


def _value_noise(x, y, seed: int):
    """Smooth value noise on a unit lattice."""
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    fx = x - ix.to(x.dtype)
    fy = y - iy.to(y.dtype)
    # Quintic smoothstep (Perlin's fade).
    ux = fx * fx * fx * (fx * (fx * 6 - 15) + 10)
    uy = fy * fy * fy * (fy * (fy * 6 - 15) + 10)
    v00 = _hash2(ix, iy, seed)
    v10 = _hash2(ix + 1, iy, seed)
    v01 = _hash2(ix, iy + 1, seed)
    v11 = _hash2(ix + 1, iy + 1, seed)
    return (v00 * (1 - ux) * (1 - uy) + v10 * ux * (1 - uy)
            + v01 * (1 - ux) * uy + v11 * ux * uy)


def fbm(x, y, octaves: int = 6, lacunarity: float = 2.0, gain: float = 0.5,
        seed: int = 1):
    """Fractional Brownian motion: `octaves` octaves of value noise."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros_like(x)
    norm = 0.0
    for o in range(octaves):
        total = total + amp * _value_noise(x * freq, y * freq, seed + o)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def generate_heightmap(resolution: int = 128, world_size: float = 64.0,
                       amplitude: float = 8.0, noise_scale: float = 0.05,
                       warp_strength: float = 1.5, octaves: int = 6,
                       seed: int = 1):
    """(R, R) float32 heights, domain-warped fBm, on the CPU: scene data
    for the builder, which takes host arrays."""
    coords = (torch.arange(resolution, dtype=torch.float32)
              / (resolution - 1) * world_size)
    gx, gz = torch.meshgrid(coords, coords, indexing="ij")
    x = gx * noise_scale
    z = gz * noise_scale
    # Domain warp: offset the sample coordinates by low-frequency noise.
    wx = fbm(x + 13.7, z + 7.1, octaves=3, seed=seed + 100)
    wz = fbm(x - 5.3, z + 19.4, octaves=3, seed=seed + 200)
    h = fbm(x + warp_strength * wx, z + warp_strength * wz, octaves=octaves,
            seed=seed)
    return h * amplitude


def _gradient(a, dim: int):
    """`jnp.gradient` at unit spacing: central differences inside, one-sided
    at both ends (at least 2 samples along `dim`)."""
    a = a.movedim(dim, 0)
    inner = (a[2:] - a[:-2]) * 0.5
    g = torch.cat([a[1:2] - a[:1], inner, a[-1:] - a[-2:-1]])
    return g.movedim(0, dim)


def _f32(heights):
    """A float32 tensor of heights (a tensor keeps its device)."""
    if isinstance(heights, torch.Tensor):
        return heights.to(torch.float32)
    return torch.from_numpy(np.array(heights, np.float32))


def heightmap_normals(heights, cell_size):
    """(R0, R1, 3) unit surface normals from central differences of float32
    heights (a float64 array is taken as float32, as JAX takes it)."""
    h = _f32(heights)
    dhdx = _gradient(h, 0) / cell_size
    dhdz = _gradient(h, 1) / cell_size
    n = torch.stack([-dhdx, torch.ones_like(h), -dhdz], -1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def _grid_indices(m0: int, m1: int) -> np.ndarray:
    """Two triangles per cell of an (m0, m1) vertex grid, row-major."""
    a = (np.arange(m0 - 1)[:, None] * m1 + np.arange(m1 - 1)[None, :]).ravel()
    b = a + m1
    return np.stack([np.stack([a, b, a + 1], -1),
                     np.stack([a + 1, b, b + 1], -1)], 1).reshape(-1, 3)


def heightmap_mesh(heights, origin, cell_size: float):
    """The whole heightmap as one render `MeshData`: a vertex per sample,
    two triangles per cell, normals from `heightmap_normals`."""
    from ..render.mesh import MeshData

    h = np.asarray(heights)
    r0, r1 = h.shape
    xs = origin[0] + np.arange(r0) * cell_size
    zs = origin[2] + np.arange(r1) * cell_size
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([gx, origin[1] + h, gz], axis=-1).reshape(-1, 3)
    n = heightmap_normals(h, cell_size).numpy().reshape(-1, 3)
    uv = np.stack(np.meshgrid(np.linspace(0, 1, r0), np.linspace(0, 1, r1),
                              indexing="ij"), -1).reshape(-1, 2)
    return MeshData(pos.astype(np.float32), n.astype(np.float32),
                    uv.astype(np.float32),
                    _grid_indices(r0, r1).astype(np.int32))


def terrain_lod_chunks(heights, origin, cell_size: float,
                       chunk_cells: int = 16, camera_pos=(0.0, 0.0, 0.0),
                       lod_distances=(24.0, 48.0, 96.0)):
    """Chunked terrain meshes with distance LOD and a hole-free seam
    collapse: a chunk's LOD counts the `lod_distances` its centre lies
    beyond (x-z distance to the camera), its vertex stride is 2^LOD, and an
    edge that faces a coarser neighbour takes the neighbour's
    piecewise-linear heights, so shared edges are identical.  Heights are
    float64 on the host; the normals are float32 (`heightmap_normals`).
    Returns [(MeshData, lod, (ci, cj))] in the chunks' row-major order."""
    from ..render.mesh import MeshData

    h = np.asarray(heights, np.float64)
    r0, r1 = h.shape
    n_ci = (r0 - 1) // chunk_cells
    n_cj = (r1 - 1) // chunk_cells
    cam = np.asarray(camera_pos, np.float64)
    max_lod = int(np.log2(chunk_cells))

    def chunk_lod(ci, cj):
        cx = origin[0] + (ci + 0.5) * chunk_cells * cell_size
        cz = origin[2] + (cj + 0.5) * chunk_cells * cell_size
        d = np.hypot(cx - cam[0], cz - cam[2])
        return min(sum(1 for t in lod_distances if d > t), max_lod)

    lods = {(ci, cj): chunk_lod(ci, cj)
            for ci in range(n_ci) for cj in range(n_cj)}

    def edge_height(i, j, stride):
        """Height at grid (i, j) on an edge of `stride`: linear between the
        stride's samples."""
        i0 = (i // stride) * stride
        j0 = (j // stride) * stride
        fi = (i - i0) / stride
        fj = (j - j0) / stride
        if fi > 0:
            return h[i0, j] * (1 - fi) + h[min(i0 + stride, r0 - 1), j] * fi
        if fj > 0:
            return h[i, j0] * (1 - fj) + h[i, min(j0 + stride, r1 - 1)] * fj
        return h[i, j]

    chunks = []
    for (ci, cj), lod in lods.items():
        stride = 1 << lod
        i0, j0 = ci * chunk_cells, cj * chunk_cells
        gi = np.arange(i0, i0 + chunk_cells + 1, stride)
        gj = np.arange(j0, j0 + chunk_cells + 1, stride)
        hh = h[np.ix_(gi, gj)].copy()
        # Seam collapse: snap each edge to a coarser neighbour's grid.
        for edge, key in (("i0", (ci - 1, cj)), ("i1", (ci + 1, cj)),
                          ("j0", (ci, cj - 1)), ("j1", (ci, cj + 1))):
            if key not in lods or (1 << lods[key]) <= stride:
                continue
            ns = 1 << lods[key]
            if edge == "i0":
                hh[0] = [edge_height(i0, j, ns) for j in gj]
            elif edge == "i1":
                hh[-1] = [edge_height(i0 + chunk_cells, j, ns) for j in gj]
            elif edge == "j0":
                hh[:, 0] = [edge_height(i, j0, ns) for i in gi]
            else:
                hh[:, -1] = [edge_height(i, j0 + chunk_cells, ns)
                             for i in gi]
        xs = origin[0] + gi * cell_size
        zs = origin[2] + gj * cell_size
        gx, gz = np.meshgrid(xs, zs, indexing="ij")
        pos = np.stack([gx, origin[1] + hh, gz], -1).reshape(-1, 3)
        n = heightmap_normals(hh, cell_size * stride).numpy().reshape(-1, 3)
        uv = np.stack(np.meshgrid(gi / (r0 - 1), gj / (r1 - 1),
                                  indexing="ij"), -1).reshape(-1, 2)
        mesh = MeshData(pos.astype(np.float32), n.astype(np.float32),
                        uv.astype(np.float32),
                        _grid_indices(len(gi), len(gj)).astype(np.int32))
        chunks.append((mesh, lod, (ci, cj)))
    return chunks


# Splat shading: grass, rock and snow blended by slope and height.

def splat_weights(heights, cell_size, rock_slope_start=0.1,
                  rock_slope_end=0.25, snow_height_start=0.7,
                  snow_height_end=0.9):
    """(R0, R1, 3) blend weights of (grass, rock, snow), summing to 1: rock
    fades in with the slope (1 - n.y), snow with the normalised height on
    what rock leaves."""
    h = _f32(heights)
    n = heightmap_normals(h, cell_size)
    slope = 1.0 - n[..., 1]
    rock = torch.clamp((slope - rock_slope_start)
                       / (rock_slope_end - rock_slope_start), 0.0, 1.0)
    h01 = (h - h.min()) / torch.clamp(h.max() - h.min(), min=1e-6)
    snow = torch.clamp((h01 - snow_height_start)
                       / (snow_height_end - snow_height_start), 0.0, 1.0)
    snow = snow * (1.0 - rock)
    grass = torch.clamp(1.0 - rock - snow, 0.0, 1.0)
    w = torch.stack([grass, rock, snow], -1)
    return w / torch.sum(w, -1, keepdim=True)


def shade_splat(weights, albedos):
    """The three materials' albedos (3, 3) blended by splat weights:
    (..., 3) colours."""
    albedos = torch.as_tensor(albedos, dtype=weights.dtype,
                              device=weights.device)
    return torch.einsum("...k,kc->...c", weights, albedos)


def sample_height_bilinear(heights, origin, cell_size, x, z):
    """Bilinear height and unit surface normal at world (x, z).

    heights (R0, R1): axis 0 runs along x, axis 1 along z.  `origin` (3,)
    and `cell_size` are numbers or tensors that broadcast with x and z,
    which take any shape.  Points outside clamp to the border.  Returns
    (height (...), normal (..., 3))."""
    u = (x - origin[0]) / cell_size
    v = (z - origin[2]) / cell_size
    r0, r1 = heights.shape[-2], heights.shape[-1]
    u = torch.clamp(u, 0.0, r0 - 1.001)
    v = torch.clamp(v, 0.0, r1 - 1.001)
    iu = torch.floor(u).to(torch.int64)
    iv = torch.floor(v).to(torch.int64)
    fu = u - iu.to(u.dtype)
    fv = v - iv.to(v.dtype)
    h00 = heights[iu, iv]
    h10 = heights[iu + 1, iv]
    h01 = heights[iu, iv + 1]
    h11 = heights[iu + 1, iv + 1]
    h = (h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv)
         + h01 * (1 - fu) * fv + h11 * fu * fv)
    # The analytic bilinear gradient.
    dhdu = (h10 - h00) * (1 - fv) + (h11 - h01) * fv
    dhdv = (h01 - h00) * (1 - fu) + (h11 - h10) * fu
    n = torch.stack([-dhdu / cell_size, torch.ones_like(h),
                     -dhdv / cell_size], -1)
    n = n / torch.sqrt(torch.sum(n * n, -1, keepdim=True))
    return origin[1] + h, n
