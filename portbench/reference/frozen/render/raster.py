"""Tile-binned rasterizer in 2D-homogeneous coordinates, its pair path in
plain PyTorch: primary visibility of a pinhole camera at one sub-pixel
offset per frame.  Per triangle the edge planes and the depth-attribute
plane in homogeneous pixel coordinates; each triangle binned to the 64x32
tiles its screen rect overlaps, front to back by a quantised bound; per
pixel the largest q = 1/w among its tile's triangles that cover it, the
first in the binned order on a tie."""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..core import maths as m

TILE_X = 64
TILE_Y = 32
PX = TILE_X * TILE_Y
PLANE_COLS = 12
W_EPS = 1e-6
# (tiles x pairs x pixels) elements per step.
PLAIN_BLOCK = 1 << 24


def perspective_rows(camera, width: int, height: int):
    """(3, 4) homogeneous-pixel transform M and (1, 4) depth-attribute row:
    [X; Y; W] = M [p; 1] with X/W, Y/W the pixel coordinates of
    `camera.generate_rays` and W the view depth; the attribute 1 makes
    q = 1/W."""
    q = camera.rotation
    axes = torch.eye(3, dtype=torch.float32, device=q.device)
    ex, ey, ez = (m.quat_rotate(q[None], axes[i:i + 1])[0] for i in range(3))
    c = camera.position
    th = math.tan(camera.v_fov * 0.5)
    row_vx = torch.cat([ex, -torch.dot(ex, c)[None]])
    row_vy = torch.cat([ey, -torch.dot(ey, c)[None]])
    row_w = torch.cat([-ez, torch.dot(ez, c)[None]])
    row_x = 0.5 * width * (row_vx / (th * camera.aspect) + row_w)
    row_y = 0.5 * height * (row_w - row_vy / th)
    attr = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=q.device)
    return torch.stack([row_x, row_y, row_w]), attr


def project_planes(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr, width: int,
                   height: int):
    """Per triangle: the (T, 12) plane table [E0 | E1 | E2 | Q] (x, y, w
    each; NaN rows for padding and degenerate triangles fail every compare)
    and its screen rect x0, y0, x1, y1 and largest q, (T,) each.  A vertex at
    or behind the camera plane makes the rect the whole screen and the
    bound +inf; invalid rows get empty rects and bound -inf."""
    v0 = tri_v0.T
    v1 = v0 + tri_e1.T
    v2 = v0 + tri_e2.T

    def proj(v):
        return [mat[r, 0] * v[0] + mat[r, 1] * v[1] + mat[r, 2] * v[2]
                + mat[r, 3] for r in range(3)]

    def attr_of(v):
        return (attr[0, 0] * v[0] + attr[0, 1] * v[1] + attr[0, 2] * v[2]
                + attr[0, 3])

    h0, h1, h2 = proj(v0), proj(v1), proj(v2)
    a0, a1, a2 = attr_of(v0), attr_of(v1), attr_of(v2)

    def cross(u, w):
        return [u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                u[0] * w[1] - u[1] * w[0]]

    c12, c20, c01 = cross(h1, h2), cross(h2, h0), cross(h0, h1)
    det = h0[0] * c12[0] + h0[1] * c12[1] + h0[2] * c12[2]
    inv_d = 1.0 / det

    def plane(c):
        return [torch.where(tri_valid, x * inv_d, torch.nan) for x in c]

    e0, e1, e2 = plane(c12), plane(c20), plane(c01)
    qp = [a0 * e0[i] + a1 * e1[i] + a2 * e2[i] for i in range(3)]
    planes = torch.stack(e0 + e1 + e2 + qp, dim=1).contiguous()

    ws = [h[2] for h in (h0, h1, h2)]
    safe = [torch.clamp(w, min=W_EPS) for w in ws]
    sx = [h[0] / s for h, s in zip((h0, h1, h2), safe)]
    sy = [h[1] / s for h, s in zip((h0, h1, h2), safe)]
    qs = [a / s for a, s in zip((a0, a1, a2), safe)]
    unb = (ws[0] <= W_EPS) | (ws[1] <= W_EPS) | (ws[2] <= W_EPS)

    def min3(v):
        return torch.minimum(torch.minimum(v[0], v[1]), v[2])

    def max3(v):
        return torch.maximum(torch.maximum(v[0], v[1]), v[2])

    inf = torch.inf
    x0 = torch.where(tri_valid, torch.where(unb, 0.0, min3(sx)), inf)
    y0 = torch.where(tri_valid, torch.where(unb, 0.0, min3(sy)), inf)
    x1 = torch.where(tri_valid, torch.where(unb, float(width), max3(sx)), -inf)
    y1 = torch.where(tri_valid, torch.where(unb, float(height), max3(sy)), -inf)
    q_tri = torch.where(tri_valid, torch.where(unb, inf, max3(qs)), -inf)
    return planes, (x0, y0, x1, y1), q_tri


def tile_ranges(rect, q_tri, width: int, height: int):
    """Per triangle the tiles its rect overlaps, as `visit_plan_pairs`
    bins them: the first tile column and row tx0, ty0, the column and row
    counts cx, cy (int64, (T,) each) and `vis`, false for a triangle in no
    tile."""
    x0, y0, x1, y1 = rect
    ntx, nty = width // TILE_X, height // TILE_Y

    def tile_index(f, n):
        # NaN rects (degenerate triangles) fail `vis`; 0 keeps the cast
        # defined.
        return torch.nan_to_num(torch.clamp(f, 0, n - 1)).to(torch.int64)

    tx0 = tile_index(torch.floor(x0 / TILE_X), ntx)
    ty0 = tile_index(torch.floor(y0 / TILE_Y), nty)
    tx1 = tile_index(torch.ceil(x1 / TILE_X) - 1, ntx)
    ty1 = tile_index(torch.ceil(y1 / TILE_Y) - 1, nty)
    vis = ((q_tri > 0.0) & (x1 > 0.0) & (x0 < width) & (y1 > 0.0)
           & (y0 < height))
    cx = torch.clamp(tx1 - tx0 + 1, min=1)
    cy = torch.clamp(ty1 - ty0 + 1, min=1)
    return tx0, ty0, cx, cy, vis


def bin_pairs(rect, q_tri, width: int, height: int):
    """Exact per-triangle tile binning at TILE_X x TILE_Y (width, height
    multiples of the tile): (pair_tri (P,) int32, seg (n_tiles + 1,) int32),
    the pairs of tile t being pair_tri[seg[t]:seg[t + 1]], front to back by
    the quantised bound of `visit_plan_pairs`, then by triangle id.  Reads
    the pair count P to the host."""
    assert width % TILE_X == 0 and height % TILE_Y == 0, (width, height)
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    dev = q_tri.device
    tx0, ty0, cx, cy, vis = tile_ranges(rect, q_tri, width, height)
    counts = torch.where(vis, cx * cy, 0)

    # Quantised front-to-back bound (visit_plan_pairs `:493-501`): qq
    # ascending = bound descending; qq = 0 for unbounded triangles.
    tile_bits = max(n_tiles - 1, 1).bit_length()
    qmax = (1 << (30 - tile_bits)) - 1
    finite = torch.isfinite(q_tri) & (q_tri > 0)
    scale = torch.clamp(torch.where(finite, q_tri, 0.0).max(),
                        min=1e-30) / (qmax - 1)
    qq = torch.where(torch.isfinite(q_tri),
                     torch.clamp(qmax - torch.ceil(q_tri / scale), 1, qmax - 1),
                     0.0).to(torch.int64)

    total = int(counts.sum())                      # the one host read
    tri = torch.repeat_interleave(torch.arange(q_tri.shape[0], device=dev),
                                  counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(total, device=dev) - starts[tri]
    tile = ((ty0[tri] + local // cx[tri]) * ntx + tx0[tri] + local % cx[tri])
    order = torch.sort(tile * (qmax + 1) + qq[tri], stable=True).indices
    seg = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    seg[1:] = torch.cumsum(torch.bincount(tile, minlength=n_tiles), 0)
    return tri[order].to(torch.int32), seg.to(torch.int32)


# --------------------------------------------------------------------------
# The kernel's plain version
# --------------------------------------------------------------------------

def _tile_pixels(ntx: int, n_tiles: int, jitter):
    """(n_tiles, PX) sample x and y of every tile's pixels, in the kernel's
    order (row-major inside the tile) and rounding: float(int) + jitter."""
    dev = jitter.device
    r = torch.arange(PX, device=dev)
    t = torch.arange(n_tiles, device=dev)[:, None]
    x = ((t % ntx) * TILE_X + r % TILE_X).to(torch.float32) + jitter[0]
    y = ((t // ntx) * TILE_Y + r // TILE_X).to(torch.float32) + jitter[1]
    return x, y


def _to_image(x, ntx: int, nty: int):
    """(n_tiles, PX) tile-major -> (nty * TILE_Y * ntx * TILE_X,) row-major."""
    return (x.reshape(nty, ntx, TILE_Y, TILE_X).permute(0, 2, 1, 3)
            .reshape(-1))


def rasterize_plain(planes, pair_tri, seg, jitter, width: int, height: int):
    """The kernel's function as tensor ops, the same operations in the same
    order: (q, tri, u, v) per pixel, row-major (height * width,).  Pairs
    are taken a block of ranks at a time across the tiles that still have
    pairs (tiles ordered by pair count), the first largest q of a block
    winning and a block replacing the running best only with a strictly
    larger q: the kernel's walk in order with `>`."""
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    dev = planes.device
    px, py = (x.to(planes.dtype) for x in _tile_pixels(ntx, n_tiles, jitter))
    best_q = torch.zeros((n_tiles, PX), dtype=planes.dtype, device=dev)
    best_tri = torch.full((n_tiles, PX), -1, dtype=torch.int32, device=dev)
    best_e1 = torch.zeros_like(best_q)
    best_e2 = torch.zeros_like(best_q)
    seg = seg.to(torch.int64)
    counts = seg[1:] - seg[:-1]
    counts_h = counts.cpu()
    by_count = torch.sort(counts_h, descending=True, stable=True)
    order = by_count.indices.to(dev)
    step = max(1, PLAIN_BLOCK // (n_tiles * PX))
    max_count = int(by_count.values[0]) if n_tiles else 0
    nan_row = torch.full((PLANE_COLS,), torch.nan, device=dev)
    table = torch.cat([planes, nan_row[None]])        # row T: a NaN plane
    for k0 in range(0, max_count, step):
        tiles = order[:int((counts_h > k0).sum())]
        ranks = k0 + torch.arange(step, device=dev)
        live = ranks[None, :] < counts[tiles][:, None]             # (A, C)
        idx = torch.clamp(seg[tiles][:, None] + ranks[None, :],
                          max=max(pair_tri.shape[0] - 1, 0))
        tri = torch.where(live, pair_tri[idx].to(torch.int64),
                          planes.shape[0])
        rows = table[tri]                                          # (A, C, 12)
        x, y = px[tiles][:, None, :], py[tiles][:, None, :]

        def edge(c):
            return ((rows[..., c, None] * x + rows[..., c + 1, None] * y)
                    + rows[..., c + 2, None])

        e0, e1, e2, q = edge(0), edge(3), edge(6), edge(9)       # (A, C, PX)
        ok = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (q > 0)
              & (q < torch.inf))
        qm = torch.where(ok, q, -1.0)
        q_max = qm.max(dim=1).values                              # (A, PX)
        cols = torch.arange(step, device=dev)[None, :, None]
        first = torch.where(qm == q_max[:, None], cols, step).min(dim=1).values
        better = q_max > best_q[tiles]
        pick = first[:, None, :]
        best_q[tiles] = torch.where(better, q_max, best_q[tiles])
        best_tri[tiles] = torch.where(
            better, torch.gather(tri, 1, first).to(torch.int32),
            best_tri[tiles])
        best_e1[tiles] = torch.where(better, torch.gather(e1, 1, pick)[:, 0],
                                     best_e1[tiles])
        best_e2[tiles] = torch.where(better, torch.gather(e2, 1, pick)[:, 0],
                                     best_e2[tiles])
    hit = best_tri >= 0
    qs = torch.clamp(best_q, min=1e-30)
    u = torch.where(hit, best_e1 / qs, 0.0)
    v = torch.where(hit, best_e2 / qs, 0.0)
    return tuple(_to_image(a, ntx, nty) for a in (best_q, best_tri, u, v))


def closest_hit_raster(bvh, camera, width: int, height: int, jitter=None,
                       ) -> Dict[str, object]:
    """Primary visibility of `camera` at width x height, sampled at pixel +
    `jitter` ((2,), default the pixel centres), row-major: t (+inf on a
    miss), tri (-1), uv (0) and hit."""
    dev = bvh.tri_v0.device
    if jitter is None:
        jitter = (0.5, 0.5)
    jit2 = torch.as_tensor(jitter, dtype=torch.float32, device=dev).reshape(2)
    wp = width + (-width) % TILE_X
    hp = height + (-height) % TILE_Y
    # The projection maps to UNPADDED pixel coordinates (as generate_rays);
    # the padding tiles extrapolate the linear edge functions.
    mat, attr = (x.to(bvh.tri_v0.dtype)
                 for x in perspective_rows(camera, width, height))
    planes, rect, q_tri = project_planes(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                                         bvh.tri_valid, mat, attr, wp, hp)
    pair_tri, seg = bin_pairs(rect, q_tri, wp, hp)
    q, tri, u, v = rasterize_plain(planes, pair_tri, seg, jit2, wp, hp)

    def crop(x):
        return x.reshape(hp, wp)[:height, :width].reshape(-1)

    q, tri = crop(q), crop(tri)
    hit = tri >= 0
    # t from q = 1/w in closed form: the unit ray through the sample has
    # view-space -z component w / t, so t = |dir_cam| w.
    th = math.tan(camera.v_fov * 0.5)
    x = torch.arange(width, dtype=torch.float32, device=dev) + jit2[0]
    y = torch.arange(height, dtype=torch.float32, device=dev) + jit2[1]
    ndc_x = (x / width * 2.0 - 1.0) * th * camera.aspect
    ndc_y = (1.0 - y / height * 2.0) * th
    norm = torch.sqrt(1.0 + ndc_x[None, :] ** 2 + ndc_y[:, None] ** 2).reshape(-1)
    t = torch.where(hit, norm / torch.clamp(q, min=1e-30), torch.inf)
    u, v = crop(u), crop(v)
    uv = torch.where(hit[:, None], torch.stack([u, v], -1), 0.0)
    return {"t": t, "tri": tri, "uv": uv, "hit": hit}
