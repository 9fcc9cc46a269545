"""Scenes for the group mode of the tile rasterizer (`raster_groups` in
csrc/raster.cu), shared by its host-C++ tests (tests/test_torch_raster_group.py)
and its card tests (tests/test_torch_port.py); no JAX here.  Meshes,
synthetic frame tables whose counters are known by hand, and a replay of
the kernel's counters with the plain arithmetic."""

import numpy as np
import torch

from d3d12renderer_tpu_torch.ops import raster
from d3d12renderer_tpu_torch.render import mesh as tmesh

SLIVER_EYE = (0.0, 0.0, -5.0)
SLIVER_SIZE = (256, 128)


def sliver_mesh(n=4096, seed=0):
    """n triangles seen edge-on from SLIVER_EYE (looking at the origin), in
    random places of a SLIVER_SIZE view: two vertices of each lie on one
    ray from the eye, so it projects to a segment and its float32 plane
    rows (1 / det of a det that is rounding noise) are noise that covers
    samples far from it."""
    rng = np.random.default_rng(seed)
    eye = np.array(SLIVER_EYE)
    d0 = rng.normal(size=(n, 3))
    d0[:, 2] = np.abs(d0[:, 2]) * 8 + 4
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 = d0 + rng.normal(size=(n, 3)) * 0.02
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    s0, s1 = rng.uniform(4, 8, (2, n, 1))
    s2 = s0 + rng.uniform(0.05, 0.3, (n, 1))
    pos = np.stack([eye + d0 * s0, eye + d1 * s1, eye + d0 * s2], 1).reshape(
        -1, 3).astype(np.float32)
    return tmesh.MeshData(
        pos, np.tile([0.0, 0.0, -1.0], (len(pos), 1)).astype(np.float32),
        np.zeros((len(pos), 2), np.float32),
        np.arange(3 * n, dtype=np.int32).reshape(-1, 3))


def facing_grid(n, half, z):
    """An n x n grid of quads in the plane z, facing -z: 2 n^2 triangles."""
    g = np.linspace(-half, half, n + 1, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z, np.float32)],
                   1)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    a, b, c, d = i, i + 1, i + n + 1, i + n + 2
    tris = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                           np.stack([b, c, d], -1).reshape(-1, 3)])
    return tmesh.MeshData(pos, np.tile([0, 0, -1.0], (len(pos), 1)).astype(
        np.float32), np.zeros((len(pos), 2), np.float32), tris.astype(
            np.int32))


def frame_tables(bvh, camera, width, height):
    """`closest_hit_raster`'s group tables of `bvh` at the padded size:
    (tables, padded width, padded height)."""
    wp = width + (-width) % raster.TILE_X
    hp = height + (-height) % raster.TILE_Y
    mat, attr = raster.perspective_rows(camera, width, height)
    return raster.build_frame_tables(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                                     bvh.tri_valid, mat, attr, wp, hp), wp, hp


def _synthetic(rows, device):
    """One 64x32 tile and one visit per group, in group order: `rows` is a
    list of groups, each a list of (plane (12,), binned to the tile); the
    rest of a group is NaN padding in no tile.  (tables, plan, jitter, w,
    h)."""
    n = len(rows) * raster.GROUP
    planes = torch.full((n, raster.PLANE_COLS), float("nan"))
    tri_tiles = torch.tensor([[0, 0, -1, -1]] * n, dtype=torch.int32)
    for g, group in enumerate(rows):
        for i, (plane, binned) in enumerate(group):
            planes[g * raster.GROUP + i] = torch.tensor(plane)
            if binned:
                tri_tiles[g * raster.GROUP + i] = torch.tensor([0, 0, 0, 0])
    tables = raster.FrameTables(
        planes=planes.to(device), tri_tiles=tri_tiles.to(device),
        rect=torch.zeros((4, len(rows)), device=device),
        qhi=torch.ones(len(rows), device=device), n_tris=n)
    jit = torch.tensor([0.5, 0.5], device=device)
    visit_tile = torch.zeros(len(rows), dtype=torch.int64, device=device)
    group = torch.arange(len(rows), dtype=torch.int32, device=device)
    plan = raster.VisitPlan(
        tiles=torch.zeros(1, dtype=torch.int32, device=device),
        seg=torch.tensor([0, len(rows)], dtype=torch.int32, device=device),
        group=group, bound=raster.visit_bounds(tables, visit_tile, group,
                                               jit, raster.TILE_X),
        qq=torch.zeros(len(rows), dtype=torch.int64, device=device),
        visit_tile=visit_tile, scale=torch.ones(1, device=device), q_bits=8,
        n_tiles=1)
    return tables, plan, jit, raster.TILE_X, raster.TILE_Y


# An edge row that holds at every sample; a band's pixel rows.
_ALL = [0.0, 0.0, 1.0]
_ROWS = raster.TILE_Y // raster.GROUP_BANDS


def band_wall(device="cpu"):
    """A wall at q = 0.5 over the tile's first row band only (y <= its
    height), then a farther wall at q = 0.25 over the whole tile: the
    first band skips the second visit, the other bands run it.  Returns
    `_synthetic`'s tuple and the counters (visits run, skipped, rows
    tested, culled)."""
    near = [0.0, -1.0, float(_ROWS)] + _ALL + _ALL + [0.0, 0.0, 0.5]
    far = _ALL + _ALL + _ALL + [0.0, 0.0, 0.25]
    bands = raster.GROUP_BANDS
    return (_synthetic([[(near, True)], [(far, True)]], device),
            (2 * bands - 1, 1, 2 * bands - 1, 0))


def tied_rows(device="cpu"):
    """A wall at q = 0.5 over the tile; then a group holding the same wall
    (its q at every band's corner equals the band's least q: culled, as a
    tie never wins) and a plane q = 0.9 - 0.4 y / (a band's height) over
    the tile, above 0.5 in the first band only (culled in the others).
    Returns `_synthetic`'s tuple and the counters."""
    wall = _ALL + _ALL + _ALL + [0.0, 0.0, 0.5]
    slope = _ALL + _ALL + _ALL + [0.0, -0.4 / _ROWS, 0.9]
    bands = raster.GROUP_BANDS
    return (_synthetic([[(wall, True)], [(wall, True), (slope, True)]],
                       device),
            (2 * bands, 0, bands + 1, 2 * bands - 1))


def band_counters(tables, plan, jitter, width, chunk=raster.GROUP_CHUNK):
    """The group kernel's counters (visits run and skipped per row band;
    in the visits run, the binned rows tested and culled) replayed with
    the plain arithmetic: each band walks each chunk of its tile's visits
    (`chunk` at a time where a tile has more) in order from best q 0,
    skips a visit unless its least best q is below the visit's bound, and
    culls each binned row whose q at the band's corner sample is at most
    that least q."""
    ntx = width // raster.TILE_X
    rows = raster.TILE_Y // raster.GROUP_BANDS
    planes = tables.planes.reshape(-1, raster.GROUP, raster.PLANE_COLS)
    seg = plan.seg.tolist()
    out = [0, 0, 0, 0]
    for slot, tile in enumerate(plan.tiles.tolist()):
        tx, ty = tile % ntx, tile // ntx
        px = (torch.arange(raster.TILE_X) + tx * raster.TILE_X).float() \
            + jitter[0]
        for band in range(raster.GROUP_BANDS):
            py = (torch.arange(rows) + ty * raster.TILE_Y
                  + band * rows).float() + jitter[1]
            x = px[None, :].expand(rows, -1).reshape(-1)
            y = py[:, None].expand(-1, raster.TILE_X).reshape(-1)
            for v in range(seg[slot], seg[slot + 1]):
                if (v - seg[slot]) % chunk == 0:
                    best = torch.zeros(x.shape[0])
                least = best.min()
                if not bool(least < plan.bound[v]):
                    out[1] += 1
                    continue
                out[0] += 1
                g = plan.group[v:v + 1].long()
                cover = raster.visit_cover(tables, plan.visit_tile[v:v + 1],
                                           g, width)[0]
                r = planes[g[0]]
                qc = (r[:, 9] * torch.where(r[:, 9] >= 0, px[-1], px[0])
                      + r[:, 10] * torch.where(r[:, 10] >= 0, py[-1], py[0])
                      ) + r[:, 11]
                keep = cover & ~(qc <= least)
                out[2] += int(keep.sum())
                out[3] += int((cover & ~keep).sum())
                r = r[keep]

                def edge(c):
                    return (r[:, c, None] * x + r[:, c + 1, None] * y) \
                        + r[:, c + 2, None]

                q = edge(9)
                ok = (edge(0) >= 0) & (edge(3) >= 0) & (edge(6) >= 0) \
                    & (q > 0) & (q < torch.inf)
                qm = torch.where(ok, q, -1.0).amax(0) if r.shape[0] else best
                best = torch.where(qm > best, qm, best)
    return out
