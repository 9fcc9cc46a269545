"""Tile-binned rasterizer in 2D-homogeneous coordinates: primary visibility
of a pinhole camera, as a drop-in for `render/bvh.closest_hit` on primary
rays.

Counterpart of ``d3d12renderer_tpu/ops/raster_pallas.py`` on its pair path
(`closest_hit_raster(binning="tri")`, `rasterize_pairs` `:593`):

* `perspective_rows` (`:94`) and `project_planes` (`_project_planes`
  `:137`): per triangle, the edge planes E0, E1, E2 and the depth-attribute
  plane Q in homogeneous pixel coordinates, its conservative screen rect
  and its largest possible q.  No near-plane clipping: triangles crossing
  w = 0 are exact through the sign rules of the 1/det normalisation.
* `bin_pairs` (the function of `visit_plan_pairs` `:431`): each triangle
  expanded to the 64x32 tiles its rect overlaps, the (tile, triangle) pairs
  sorted by (tile, quantised q bound descending, triangle id).  The pair
  list is sized from the frame's pair count (one host read per frame), so
  no pair is ever dropped and `overflow` is always 0.
* `rasterize_tiles` (kernel #5's port, `_raster_kernel` `:329`): the CUDA
  kernel of `csrc/raster.cu` on CUDA tensors, `rasterize_plain` on CPU
  tensors.  Per pixel, the largest q = Q.p among the tile's pairs with
  e0, e1, e2 >= 0 and 0 < q < inf, the first pair in the sorted order on
  a tie; u = e1 / q, v = e2 / q.  The kernel culls, front to back, the
  pairs that cannot win a pixel of their band (the part of JAX's early-out,
  `:415-418`, on an exact bound) and returns the plain version's bits.
* `closest_hit_raster`: `{t, tri, uv, hit, overflow, tile_qmin}`, t from q
  in closed form (`:838-847`).

And on its group path (`closest_hit_raster(binning="group")` or
`tile_qmin=`, `rasterize` `:733`):

* `build_frame_tables` (`:212`): the planes in groups of GROUP (128)
  consecutive rows, each group's screen rect and largest q;
  `geometric_needed` (`:255`) the (tile, group) overlaps;
  `visit_plan` (`:274`) each tile's visits sorted front to back by JAX's
  quantised bound (`_visit_bits`, `q_up = ceil(qhi / scale)`), then by
  group.  The list is sized from the frame's own count: no visit is
  dropped (JAX keeps VISIT_CAP per tile), so `overflow` is 0.  Each visit
  carries an exact bound (`visit_bounds`): the largest q its planes give
  at a sample of the tile.  JAX's bound from the vertices is not one for
  the float32 planes of small triangles (PERF.md's kernel table, row 5),
  so its early-out and its feedback would drop pixels' winners.
* `rasterize_groups` (kernel #5's group mode, `raster_groups` in
  `csrc/raster.cu`; `rasterize_groups_plain` on CPU tensors): per tile the
  visits in order, each skipped where the tile's least q is not below its
  bound (JAX's early-out, on the exact bound), each testing only the
  triangles the pair path bins to the tile (JAX tests all 128, so the
  float32 plane of a sub-pixel triangle wins pixels outside its rect), the
  largest q winning, the first in visit order on a tie: the pair path's
  frame wherever the winner is unique.
* `rasterize`: one pass, or with last frame's `tile_qmin` the two phases
  of JAX's exact occlusion feedback: phase 1 runs the visits that the
  feedback does not cull, and phase 2 re-rasterizes, from scratch, only
  the tiles where a culled visit could still beat phase 1's least q.
  The group branch's barycentrics are the winner's e / q at the sample,
  as the pair path's (JAX's come from the dense rows, `:857-877`).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict

import torch

from ..core import maths as m
from ..cuda_build import launcher

# Mirrors of csrc/raster.cu.
TILE_X = 64
TILE_Y = 32
# `bin_pairs` lists every pair that can exist, with no host read, up to
# this many (tile, row) slots: 4,112 rows at 1080p's 1,020 tiles.
STATIC_PAIRS = 1 << 22
PX = TILE_X * TILE_Y
PLANE_COLS = 12
W_EPS = 1e-6
BANDS = 2                # blocks per tile, one per row band
# (tiles x pairs x pixels) elements per step of the plain version.
PLAIN_BLOCK = 1 << 24
# The group path: triangles per group (raster_pallas.py GROUP), JAX's
# per-tile visit cap (the port keeps every visit; the tests compare with
# JAX where JAX dropped none) and the occlusion feedback's margin.
GROUP = 128
GROUP_BANDS = 8          # group-mode blocks per tile, one per row band
GROUP_CHUNK = 64         # a tile of more visits is split into chunks
VISIT_CAP = 128
FB_MARGIN = 1.0 - 1e-5


class RasterArgs(ctypes.Structure):
    """raster.cu `RasterArgs`."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "planes", "pair_tri", "seg", "jitter", "q_out", "tri_out", "u_out",
        "v_out", "stats")] + [(name, ctypes.c_int) for name in (
            "ntx", "n_tiles", "row_pixels")]


class RasterGroupArgs(ctypes.Structure):
    """raster.cu `RasterGroupArgs`."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "planes", "tri_tiles", "tiles", "seg", "items", "group", "bound",
        "jitter", "q_out", "tri_out", "keys", "tickets", "stats")] + [
            (name, ctypes.c_int) for name in ("ntx", "n_items", "chunk",
                                              "row_pixels")]


# --------------------------------------------------------------------------
# Projection and binning (PyTorch, on the scene's device)
# --------------------------------------------------------------------------

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
    attr = m.constant(((0.0, 0.0, 0.0, 1.0),), torch.float32, q.device)
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
    the quantised bound of `visit_plan_pairs`, then by triangle id.

    Where rows x tiles is at most STATIC_PAIRS, the list has a slot for
    every pair that can exist (none is ever dropped; the slots past seg[-1]
    are never read): nothing waits for the card and the shapes depend on
    the row count alone, so a CUDA graph can hold the binning.  Larger
    scenes read the pair count P to the host and list P pairs."""
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

    if q_tri.shape[0] * n_tiles <= STATIC_PAIRS:
        return _bin_pairs_static(counts, tx0, ty0, cx, qq, ntx, n_tiles, qmax)
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


def _bin_pairs_static(counts, tx0, ty0, cx, qq, ntx: int, n_tiles: int,
                      qmax: int):
    """`bin_pairs` of a small scene: slot p of rows x tiles holds pair p of the
    dynamic list (the triangle whose running count passes p) or, past the
    last pair, a key above every tile's, so that the stable sort leaves the
    live pairs in the dynamic list's order."""
    n_rows = counts.shape[0]
    dev = counts.device
    ends = torch.cumsum(counts, 0)
    slot = torch.arange(n_rows * n_tiles, device=dev)
    tri = torch.searchsorted(ends, slot, right=True)
    live = tri < n_rows
    tri = torch.clamp(tri, max=n_rows - 1)
    local = slot - (ends - counts)[tri]
    tile = ((ty0[tri] + local // cx[tri]) * ntx + tx0[tri] + local % cx[tri])
    # tile < 2^tile_bits and qq <= qmax < 2^(30 - tile_bits): int32 keys.
    key = torch.where(live, tile * (qmax + 1) + qq[tri],
                      n_tiles * (qmax + 1)).to(torch.int32)
    key, order = torch.sort(key, stable=True)
    firsts = torch.arange(n_tiles + 1, device=dev, dtype=torch.int32) \
        * (qmax + 1)
    seg = torch.searchsorted(key, firsts).to(torch.int32)
    return tri[order].to(torch.int32), seg


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
    px, py = _tile_pixels(ntx, n_tiles, jitter)
    best_q = torch.zeros((n_tiles, PX), device=dev)
    best_tri = torch.full((n_tiles, PX), -1, dtype=torch.int32, device=dev)
    best_e1 = torch.zeros((n_tiles, PX), device=dev)
    best_e2 = torch.zeros((n_tiles, PX), device=dev)
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


# --------------------------------------------------------------------------
# The kernel's wrapper
# --------------------------------------------------------------------------

def _check(name, x, dtype, cols, device):
    if x.dtype != dtype or not x.is_contiguous() or (
            cols is not None and (x.dim() != 2 or x.shape[1] != cols)):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor"
                         f"{'' if cols is None else f' of {cols} columns'}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, planes on {device}")


def launch(launch_fn, planes, pair_tri, seg, jitter, width: int, height: int,
           stats=None):
    """Checks the inputs, allocates the row-major outputs (q, tri, u, v),
    calls `launch_fn(RasterArgs*)` and raises if it reports an error.
    `launch_fn` is the CUDA launcher bound to a device and stream or, in the
    CPU tests, the kernel source compiled as host code.  BANDS blocks walk
    each tile, one per row band; `stats`, a (2,) int64 tensor, receives the
    pairs the blocks tested and the pairs they culled (added to it, summed
    over the blocks)."""
    dev = planes.device
    _check("planes", planes, torch.float32, PLANE_COLS, dev)
    _check("pair_tri", pair_tri, torch.int32, None, dev)
    _check("seg", seg, torch.int32, None, dev)
    _check("jitter", jitter, torch.float32, None, dev)
    if stats is not None:
        _check("stats", stats, torch.int64, None, dev)
    ntx, nty = width // TILE_X, height // TILE_Y
    if width % TILE_X or height % TILE_Y or seg.shape != (ntx * nty + 1,) \
            or jitter.shape != (2,) \
            or (stats is not None and stats.shape != (2,)):
        raise ValueError(f"bad raster shapes: {width}x{height}, seg "
                         f"{tuple(seg.shape)}, jitter {tuple(jitter.shape)}")
    if planes.data_ptr() % 16:
        raise ValueError("planes must be 16-byte aligned")
    n = width * height
    q = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty_like(q)
    v = torch.empty_like(q)
    args = RasterArgs(planes.data_ptr(), pair_tri.data_ptr(), seg.data_ptr(),
                      jitter.data_ptr(), q.data_ptr(), tri.data_ptr(),
                      u.data_ptr(), v.data_ptr(),
                      0 if stats is None else stats.data_ptr(), ntx,
                      ntx * nty, width)
    err = launch_fn(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: error {err}")
    return q, tri, u, v


def rasterize_tiles(planes, pair_tri, seg, jitter, width: int, height: int,
                    stats=None):
    """Kernel #5's port on CUDA tensors, the plain version on CPU tensors:
    (q, tri, u, v) row-major (height * width,).  Counts its launches in
    `rasterize_tiles.launches`; `stats`: see `launch`."""
    if not planes.is_cuda:
        return rasterize_plain(planes, pair_tri, seg, jitter, width, height)
    out = launch(launcher("raster_launch", planes.device), planes, pair_tri,
                 seg, jitter, width, height, stats)
    rasterize_tiles.launches += 1
    return out


rasterize_tiles.launches = 0


# --------------------------------------------------------------------------
# The group path: tables, visit plan, kernel and plain version
# --------------------------------------------------------------------------

@dataclass
class FrameTables:
    """One frame's tables for the group path."""

    planes: torch.Tensor   # (G * GROUP, 12) the plane rows, NaN padding rows
    tri_tiles: torch.Tensor  # (G * GROUP, 4) int32 each row's tiles
    #   tx0, ty0, tx1, ty1 (inclusive), those the pair path bins it to;
    #   0, 0, -1, -1 for a row in no tile and for padding
    rect: torch.Tensor     # (4, G) each group's screen rect x0, y0, x1, y1
    qhi: torch.Tensor      # (G,) each group's largest q (+inf unbounded)
    n_tris: int            # rows before the padding


@dataclass
class VisitPlan:
    """Per launched tile its visits, front to back: block b runs tile
    `tiles[b]` over visits `seg[b]:seg[b + 1]` of `group` / `bound`."""

    tiles: torch.Tensor    # (L,) int32
    seg: torch.Tensor      # (L + 1,) int32
    group: torch.Tensor    # (V,) int32
    bound: torch.Tensor    # (V,) f32, the largest q the visit can give
    qq: torch.Tensor       # (V,) int64, JAX's quantised bound (the order)
    visit_tile: torch.Tensor  # (V,) int64, each visit's tile
    scale: torch.Tensor    # (1,) f32, JAX's dequantiser
    q_bits: int
    n_tiles: int

    @property
    def visits(self) -> int:
        return int(self.group.shape[0])

    def select(self, keep, tile_keep=None) -> "VisitPlan":
        """The visits where `keep` (V,), in order, over all of this plan's
        tiles, or only the tiles where `tile_keep` (n_tiles,) (this plan
        must cover every tile then).  Reads the tile count to the host."""
        dev = self.group.device
        if tile_keep is None:
            tiles = self.tiles.long()
            slot_of = torch.full((self.n_tiles,), -1, dtype=torch.int64,
                                 device=dev)
            slot_of[tiles] = torch.arange(tiles.shape[0], device=dev)
        else:
            keep = keep & tile_keep[self.visit_tile]
            tiles = torch.nonzero(tile_keep)[:, 0]
            slot_of = torch.cumsum(tile_keep.long(), 0) - 1
        idx = torch.nonzero(keep)[:, 0]
        vt = self.visit_tile[idx]
        seg = torch.zeros(tiles.shape[0] + 1, dtype=torch.int64, device=dev)
        seg[1:] = torch.cumsum(torch.bincount(slot_of[vt],
                                              minlength=tiles.shape[0]), 0)
        return VisitPlan(tiles=tiles.to(torch.int32), seg=seg.to(torch.int32),
                         group=self.group[idx], bound=self.bound[idx],
                         qq=self.qq[idx], visit_tile=vt, scale=self.scale,
                         q_bits=self.q_bits, n_tiles=self.n_tiles)


def build_frame_tables(tri_v0, tri_e1, tri_e2, tri_valid, mat, attr,
                       width: int, height: int) -> FrameTables:
    """The planes of every triangle, padded with NaN rows to whole groups
    of GROUP, each triangle's tiles (the pair path's), and each group's
    screen rect and largest q (`:212`)."""
    planes, (x0, y0, x1, y1), q_tri = project_planes(
        tri_v0, tri_e1, tri_e2, tri_valid, mat, attr, width, height)
    t = planes.shape[0]
    pad = (-t) % GROUP
    dev = planes.device
    planes = torch.cat([planes, torch.full((pad, PLANE_COLS), torch.nan,
                                           device=dev)])
    tx0, ty0, cx, cy, vis = tile_ranges((x0, y0, x1, y1), q_tri, width,
                                        height)
    empty = torch.tensor([0, 0, -1, -1], device=dev)
    tiles = torch.where(vis[:, None], torch.stack(
        [tx0, ty0, tx0 + cx - 1, ty0 + cy - 1], 1), empty)
    tiles = torch.cat([tiles, empty.expand(pad, 4)]).to(torch.int32)

    def grouped(x, fill):
        return torch.cat([x, torch.full((pad,), fill, device=dev)]).reshape(
            -1, GROUP)

    inf = torch.inf
    rect = torch.stack([grouped(x0, inf).amin(1), grouped(y0, inf).amin(1),
                        grouped(x1, -inf).amax(1), grouped(y1, -inf).amax(1)])
    return FrameTables(planes=planes.contiguous(),
                       tri_tiles=tiles.contiguous(), rect=rect,
                       qhi=grouped(q_tri, -inf).amax(1), n_tris=t)


def visit_bits(n_tiles: int, n_groups: int):
    """JAX's visit word widths (`_visit_bits` `:247`): (tile, q, group)
    bits.  The port keeps no such word, but its quantised bound has JAX's
    q bits, so that the early-out skips the same visits."""
    tile_bits = max(n_tiles - 1, 1).bit_length()
    group_bits = max(n_groups - 1, 1).bit_length()
    q_bits = 31 - tile_bits - group_bits
    if q_bits < 6:
        raise ValueError(f"{n_tiles} tiles and {n_groups} groups leave "
                         f"{q_bits} bits of quantised bound (JAX needs 6)")
    return tile_bits, q_bits, group_bits


def geometric_needed(tables: FrameTables, width: int, height: int):
    """(n_tiles, G) bool: the group's screen rect overlaps the tile and
    its q bound is positive (`:255`); tiles in row-major tile order."""
    ntx, nty = width // TILE_X, height // TILE_Y
    dev = tables.qhi.device
    tx0 = (torch.arange(ntx, dtype=torch.float32, device=dev)
           * TILE_X).repeat(nty)[:, None]
    ty0 = (torch.arange(nty, dtype=torch.float32, device=dev)
           * TILE_Y).repeat_interleave(ntx)[:, None]
    r = tables.rect
    return ((r[0][None, :] < tx0 + TILE_X) & (r[2][None, :] > tx0)
            & (r[1][None, :] < ty0 + TILE_Y) & (r[3][None, :] > ty0)
            & (tables.qhi[None, :] > 0.0))


def group_bounds(tables: FrameTables, q_bits: int):
    """Each group's quantised bound qq (int64; 0 for an unbounded group)
    and its dequantiser, as JAX computes them (`:296-301`): the visits'
    front-to-back order."""
    qhi = tables.qhi
    qmax_q = (1 << q_bits) - 1
    finite = torch.isfinite(qhi) & (qhi > 0)
    scale = torch.clamp(torch.where(finite, qhi, 0.0).max(), min=1e-30) \
        / torch.tensor(qmax_q - 1, dtype=torch.float32, device=qhi.device)
    q_up = torch.ceil(qhi / scale)
    qq = torch.where(torch.isfinite(qhi),
                     torch.clamp(qmax_q - q_up, 1, qmax_q - 1), 0.0)
    return qq.to(torch.int64), scale


def visit_cover(tables: FrameTables, visit_tile, group, width: int):
    """(V, GROUP) bool: the triangles of each (tile, group) visit that the
    pair path bins to its tile (`tri_tiles`), the only ones the visit
    tests.  The float32 plane of a sub-pixel triangle also covers samples
    far outside its rect; testing it there would let it win pixels the
    pair path never gives it."""
    ntx = width // TILE_X
    r = tables.tri_tiles.reshape(-1, GROUP, 4)[group.long()]
    tx = (visit_tile % ntx)[:, None]
    ty = (visit_tile // ntx)[:, None]
    return ((r[..., 0] <= tx) & (tx <= r[..., 2]) & (r[..., 1] <= ty)
            & (ty <= r[..., 3]))


def visit_bounds(tables: FrameTables, visit_tile, group, jitter,
                 width: int):
    """(V,) the largest q each (tile, group) visit can give a sample of its
    tile, exactly: per triangle of the visit (`visit_cover`) its plane's q
    at the tile's corner sample that the signs of qx and qy pick (each
    rounded operation is monotone in px and py, so no sample of the tile
    gives more: the argument of the pair kernel's cull), the largest over
    them; NaN planes and triangles not tested count -inf.  JAX's bound,
    the vertices' largest q quantised up, is not one for the float32
    planes of small triangles."""
    ntx = width // TILE_X
    qp = tables.planes.reshape(-1, GROUP, PLANE_COLS)[group.long()][..., 9:12]
    tx0 = (visit_tile % ntx * TILE_X)[:, None]
    ty0 = (visit_tile // ntx * TILE_Y)[:, None]
    x = torch.where(qp[..., 0] >= 0, tx0 + TILE_X - 1, tx0).to(
        torch.float32) + jitter[0]
    y = torch.where(qp[..., 1] >= 0, ty0 + TILE_Y - 1, ty0).to(
        torch.float32) + jitter[1]
    q = (qp[..., 0] * x + qp[..., 1] * y) + qp[..., 2]
    live = visit_cover(tables, visit_tile, group, width) & ~torch.isnan(q)
    return torch.where(live, q, -torch.inf).amax(1)


def visit_plan(tables: FrameTables, width: int, height: int, jitter,
               needed=None, tiles=None) -> VisitPlan:
    """The visits of `needed` ((n_tiles, G), default `geometric_needed`),
    each tile's sorted by JAX's quantised bound qq ascending (its bound
    descending), then by group, as JAX's visit words sort (`:274-331`),
    each with its exact bound at `jitter` (`visit_bounds`); over every
    tile, or the tiles `tiles`.  Every visit is kept (JAX caps a tile at
    VISIT_CAP).  Reads the visit count to the host."""
    ntx, nty = width // TILE_X, height // TILE_Y
    n_tiles = ntx * nty
    dev = tables.qhi.device
    _, q_bits, _ = visit_bits(n_tiles, tables.qhi.shape[0])
    qmax_q = (1 << q_bits) - 1
    if needed is None:
        needed = geometric_needed(tables, width, height)
    qq_g, scale = group_bounds(tables, q_bits)
    tile, grp = torch.nonzero(needed, as_tuple=True)      # one host read
    order = torch.sort(tile * (qmax_q + 1) + qq_g[grp], stable=True).indices
    tile, grp = tile[order], grp[order]
    seg = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    seg[1:] = torch.cumsum(torch.bincount(tile, minlength=n_tiles), 0)
    plan = VisitPlan(
        tiles=torch.arange(n_tiles, dtype=torch.int32, device=dev),
        seg=seg.to(torch.int32), group=grp.to(torch.int32),
        bound=visit_bounds(tables, tile, grp, jitter, width).contiguous(),
        qq=qq_g[grp], visit_tile=tile, scale=scale.reshape(1),
        q_bits=q_bits, n_tiles=n_tiles)
    if tiles is None:
        return plan
    tile_keep = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    tile_keep[tiles.long()] = True
    return plan.select(torch.ones_like(tile, dtype=torch.bool), tile_keep)


def _scatter_tiles(dst, tiles, x, ntx: int, width: int):
    """Write tile-major (L, PX) values of `tiles` into a row-major image."""
    r = torch.arange(PX, device=x.device)
    t = tiles.long()[:, None]
    idx = ((t // ntx) * TILE_Y + r // TILE_X) * width \
        + (t % ntx) * TILE_X + r % TILE_X
    dst[idx.reshape(-1)] = x.reshape(-1)


def rasterize_groups_plain(tables: FrameTables, plan: VisitPlan, jitter,
                           width: int, height: int, base=None):
    """The group kernel's function as tensor ops, in its order: one visit
    rank at a time across the launched tiles that have one (the early-out
    reads each tile's least q before the visit), each visit testing the
    triangles binned to its tile (`visit_cover`), the first largest q of a
    visit winning and a visit replacing a pixel's best only with a larger
    q.  (q, tri) row-major (height * width,); the pixels of tiles not
    launched are `base`'s (default 0 and -1)."""
    ntx = width // TILE_X
    planes = tables.planes
    dev = planes.device
    n = width * height
    if base is None:
        q_out = torch.zeros(n, device=dev)
        tri_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    else:
        q_out, tri_out = base[0].clone(), base[1].clone()
    n_launch = plan.tiles.shape[0]
    if n_launch == 0:
        return q_out, tri_out
    seg = plan.seg.to(torch.int64)
    counts = seg[1:] - seg[:-1]
    counts_h = counts.cpu()
    by_count = torch.sort(counts_h, descending=True, stable=True)
    order = by_count.indices.to(dev)
    chunk = max(1, PLAIN_BLOCK // (GROUP * PX))
    px, py = _tile_pixels(ntx, int(plan.tiles.max()) + 1, jitter)
    px, py = px[plan.tiles.long()], py[plan.tiles.long()]
    best_q = torch.zeros((n_launch, PX), device=dev)
    best_tri = torch.full((n_launch, PX), -1, dtype=torch.int32, device=dev)
    rows_g = planes.reshape(-1, GROUP, PLANE_COLS)
    cols = torch.arange(GROUP, device=dev)[None, :, None]
    for k in range(int(by_count.values[0])):
        live = order[:int((counts_h > k).sum())]
        for c0 in range(0, live.shape[0], chunk):
            slots = live[c0:c0 + chunk]
            v = seg[slots] + k
            g = plan.group[v].long()
            run = best_q[slots].amin(1) < plan.bound[v]          # (A,)
            cover = visit_cover(tables, plan.visit_tile[v], g, width)
            rows = rows_g[g]                                     # (A, G, 12)
            x, y = px[slots][:, None, :], py[slots][:, None, :]

            def edge(c):
                return ((rows[..., c, None] * x + rows[..., c + 1, None] * y)
                        + rows[..., c + 2, None])

            e0, e1, e2, q = edge(0), edge(3), edge(6), edge(9)
            ok = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (q > 0)
                  & (q < torch.inf) & cover[..., None])
            qm = torch.where(ok, q, -1.0)
            q_max = qm.max(dim=1).values                         # (A, PX)
            first = torch.where(qm == q_max[:, None], cols, GROUP).min(
                dim=1).values
            better = run[:, None] & (q_max > best_q[slots])
            best_q[slots] = torch.where(better, q_max, best_q[slots])
            best_tri[slots] = torch.where(
                better, (g[:, None] * GROUP + first).to(torch.int32),
                best_tri[slots])
    _scatter_tiles(q_out, plan.tiles, best_q, ntx, width)
    _scatter_tiles(tri_out, plan.tiles, best_tri, ntx, width)
    return q_out, tri_out


def group_items(seg, visits: int, chunk: int):
    """(n_items, 4) int32 work items of the group kernel, on seg's device
    without a host read: each launched tile's visits [seg[s], seg[s+1]) in
    chunks of `chunk`, the last one shorter (one item for a tile without
    visits), as (s, begin, end, k): k numbers the tiles split into more
    than one chunk in slot order, -1 for the others.  Longest first,
    padded with (-1, 0, 0, -1) to the most items `visits` can make
    (n_launch + visits // chunk).  The first chunk, which holds the
    nearest visits and so culls the most, is a whole one."""
    n_launch = seg.shape[0] - 1
    dev = seg.device
    seg = seg.long()
    counts = seg[1:] - seg[:-1]
    n_chunks = torch.clamp((counts + chunk - 1) // chunk, min=1)
    ends = torch.cumsum(n_chunks, 0)
    split = torch.cumsum(n_chunks > 1, 0) - 1
    i = torch.arange(n_launch + visits // chunk, device=dev)
    slot = torch.searchsorted(ends, i, right=True)
    s = torch.clamp(slot, max=n_launch - 1)
    begin = seg[s] + (i - ends[s] + n_chunks[s]) * chunk
    end = torch.minimum(begin + chunk, seg[s + 1])
    real = slot < n_launch
    items = torch.stack([torch.where(real, slot, -1),
                         torch.where(real, begin, 0),
                         torch.where(real, end, 0),
                         torch.where(real & (n_chunks[s] > 1), split[s], -1)],
                        1)
    order = torch.sort(torch.where(real, end - begin, -1), descending=True,
                       stable=True).indices
    return items[order].to(torch.int32).contiguous()


def launch_groups(launch_fn, tables: FrameTables, plan: VisitPlan, jitter,
                  width: int, height: int, base=None, stats=None):
    """Checks the inputs, allocates the row-major outputs (q, tri) (copies
    of `base`, or 0 and -1, where tiles are not launched), calls
    `launch_fn(RasterGroupArgs*)` and raises if it reports an error.
    The kernel's blocks take the work items of `group_items` (tiles of
    more than GROUP_CHUNK visits split, read at each call), longest
    first.  `stats`, a (4,) int64 tensor,
    receives per row band (GROUP_BANDS a tile) the visits run and skipped
    and, in the visits run, the rows binned to the tile that were tested
    and culled (added to it)."""
    planes = tables.planes
    dev = planes.device
    _check("planes", planes, torch.float32, PLANE_COLS, dev)
    _check("tri_tiles", tables.tri_tiles, torch.int32, 4, dev)
    for name in ("tiles", "seg", "group"):
        _check(name, getattr(plan, name), torch.int32, None, dev)
    _check("bound", plan.bound, torch.float32, None, dev)
    _check("jitter", jitter, torch.float32, None, dev)
    if stats is not None:
        _check("stats", stats, torch.int64, None, dev)
    ntx, nty = width // TILE_X, height // TILE_Y
    n_launch = plan.tiles.shape[0]
    if width % TILE_X or height % TILE_Y or planes.shape[0] % GROUP \
            or tables.tri_tiles.shape[0] != planes.shape[0] \
            or plan.seg.shape != (n_launch + 1,) \
            or plan.bound.shape != plan.group.shape or jitter.shape != (2,) \
            or (stats is not None and stats.shape != (4,)):
        raise ValueError(f"bad group raster shapes: {width}x{height}, planes "
                         f"{tuple(planes.shape)}, seg {tuple(plan.seg.shape)} "
                         f"for {n_launch} tiles")
    if planes.data_ptr() % 16 or tables.tri_tiles.data_ptr() % 16:
        raise ValueError("planes and tri_tiles must be 16-byte aligned")
    n = width * height
    if base is None:
        q = torch.zeros(n, dtype=torch.float32, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    else:
        q, tri = base[0].clone(), base[1].clone()
    if n_launch == 0:
        return q, tri
    chunk = GROUP_CHUNK
    items = group_items(plan.seg, plan.visits, chunk)
    # A split tile holds more than `chunk` visits.
    splits = min(n_launch, plan.visits // (chunk + 1))
    keys = torch.zeros(splits * PX, dtype=torch.int64, device=dev)
    tickets = torch.zeros(splits, dtype=torch.int32, device=dev)
    args = RasterGroupArgs(
        planes.data_ptr(), tables.tri_tiles.data_ptr(), plan.tiles.data_ptr(),
        plan.seg.data_ptr(), items.data_ptr(),
        plan.group.data_ptr(), plan.bound.data_ptr(), jitter.data_ptr(),
        q.data_ptr(), tri.data_ptr(), keys.data_ptr(), tickets.data_ptr(),
        0 if stats is None else stats.data_ptr(), ntx, items.shape[0], chunk,
        width)
    err = launch_fn(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"group raster kernel launch failed: error {err}")
    return q, tri


def rasterize_groups(tables: FrameTables, plan: VisitPlan, jitter,
                     width: int, height: int, base=None, stats=None):
    """Kernel #5's group mode on CUDA tensors, the plain version on CPU
    tensors: (q, tri) row-major (height * width,).  Counts its launches in
    `rasterize_groups.launches` (a repair phase without a dirty tile
    launches nothing); `base` / `stats`: see `launch_groups`."""
    if not tables.planes.is_cuda:
        return rasterize_groups_plain(tables, plan, jitter, width, height,
                                      base)
    if plan.tiles.numel() == 0 and base is not None:   # nothing to launch
        return base[0].clone(), base[1].clone()
    out = launch_groups(launcher("raster_groups_launch",
                                 tables.planes.device),
                        tables, plan, jitter, width, height, base, stats)
    rasterize_groups.launches += 1
    return out


rasterize_groups.launches = 0


def group_rows_needed(tables: FrameTables, plan: VisitPlan, q, jitter,
                      width: int, height: int) -> int:
    """The (visit, band, row) tests that any exact cull of a row per row
    band (GROUP_BANDS a tile) must run, given the final image q ((height *
    width,), row-major): the rows of each visit binned to its tile
    (`visit_cover`) whose plane's largest q over the band (at the corner
    sample the signs of qx and qy pick, as the kernel computes it) exceeds
    the band's least final q.  The group kernel tests at least these."""
    ntx = width // TILE_X
    rows = TILE_Y // GROUP_BANDS
    least = q.reshape(height // rows, rows, ntx, TILE_X).amin(dim=(1, 3))
    cover = visit_cover(tables, plan.visit_tile, plan.group, width)
    qp = tables.planes.reshape(-1, GROUP, PLANE_COLS)[plan.group.long()][
        ..., 9:12]
    tx, ty = plan.visit_tile % ntx, plan.visit_tile // ntx
    x0 = (tx * TILE_X)[:, None]
    x = torch.where(qp[..., 0] >= 0, x0 + TILE_X - 1, x0).to(
        torch.float32) + jitter[0]
    needed = 0
    for band in range(GROUP_BANDS):
        y0 = (ty * TILE_Y + band * rows)[:, None]
        y = torch.where(qp[..., 1] >= 0, y0 + rows - 1, y0).to(
            torch.float32) + jitter[1]
        qc = (qp[..., 0] * x + qp[..., 1] * y) + qp[..., 2]
        band_least = least[ty * GROUP_BANDS + band, tx][:, None]
        needed += int((cover & (qc > band_least)).sum())
    return needed


def tile_min(q, width: int, height: int):
    """(n_tiles,) each tile's least q of a row-major (height * width,)
    image, tiles in row-major tile order (JAX's `tile_qmin`)."""
    return q.reshape(height // TILE_Y, TILE_Y, width // TILE_X, TILE_X).amin(
        dim=(1, 3)).reshape(-1)


def rasterize(tables: FrameTables, width: int, height: int, jitter,
              tile_qmin=None):
    """The group path over `tables` at width x height (tile multiples):
    (q, tri, overflow, tile_qmin_out, visits), q / tri row-major.

    With last frame's `tile_qmin`, JAX's two phases (`:733-808`), on the
    visits' exact bounds where JAX reads its groups' vertex bounds: phase
    1 runs the visits whose bound is above the feedback (times
    FB_MARGIN); a tile is dirty where a culled visit's bound is above
    phase 1's least q (times FB_MARGIN); phase 2 rasterizes only the dirty
    tiles anew over the visits whose bound is above that least q, and
    their pixels replace phase 1's.  With exact bounds the result is the
    run without feedback's, bit for bit.  `visits`: the visits of phase 1
    and phase 2 and the dirty tiles.

    The feedback is JAX's contract, kept as such: the visits it culls are
    those the kernel's early-out skips anyway, and on the character crowd
    at 1080p a frame with it takes as long as one without (PERF.md)."""
    plan = visit_plan(tables, width, height, jitter)
    zero = torch.zeros((), dtype=torch.int64, device=tables.qhi.device)
    if tile_qmin is None:
        q, tri = rasterize_groups(tables, plan, jitter, width, height)
        return (q, tri, zero, tile_min(q, width, height),
                {"phase1": plan.visits, "phase2": 0, "dirty": 0})
    margin = m.constant((FB_MARGIN,), torch.float32, tables.qhi.device)
    vt = plan.visit_tile
    cull1 = plan.bound <= tile_qmin[vt] * margin
    plan1 = plan.select(~cull1)
    q1, tri1 = rasterize_groups(tables, plan1, jitter, width, height)
    above = plan.bound > (tile_min(q1, width, height) * margin)[vt]
    dirty = torch.zeros(plan.n_tiles, dtype=torch.bool, device=vt.device)
    dirty[vt[cull1 & above]] = True
    plan2 = plan.select(above, tile_keep=dirty)
    q, tri = rasterize_groups(tables, plan2, jitter, width, height,
                              base=(q1, tri1))
    return (q, tri, zero, tile_min(q, width, height),
            {"phase1": plan1.visits, "phase2": plan2.visits,
             "dirty": int(plan2.tiles.shape[0])})


# --------------------------------------------------------------------------
# The query
# --------------------------------------------------------------------------

def closest_hit_raster(bvh, camera, width: int, height: int, jitter=None,
                       binning: str = "tri",
                       tile_qmin=None) -> Dict[str, object]:
    """Primary visibility of `camera` at width x height, sampled at pixel +
    `jitter` ((2,), default the pixel centres): the contract of
    `bvh.closest_hit` over `generate_rays(offset=jitter)` rays, row-major:
    t (+inf on a miss), tri (-1), uv (0) and hit, plus `overflow` (always
    0: nothing is dropped) and `tile_qmin` (each padded tile's least q, the
    next frame's occlusion feedback).

    `binning="tri"` (JAX's default) bins each triangle's own rect
    (`bin_pairs`): adds `pairs` (the frame's (tile, triangle) pairs, a 0-d
    tensor on the device).  `binning="group"`, or
    any `tile_qmin=` (last frame's `tile_qmin`), takes the group path with
    its two-phase occlusion feedback: adds `visits` (`rasterize`'s); the
    barycentrics are the winner's e1 / q and e2 / q at the sample, as the
    pair path's (JAX's group branch takes them from the dense rows at the
    hit point, which float32's t puts off small far triangles)."""
    if binning not in ("tri", "group"):
        raise ValueError(f"unknown binning {binning!r}")
    dev = bvh.tri_v0.device
    if jitter is None:
        jitter = (0.5, 0.5)
    jit2 = torch.as_tensor(jitter, dtype=torch.float32, device=dev).reshape(2)
    wp = width + (-width) % TILE_X
    hp = height + (-height) % TILE_Y
    # The projection maps to UNPADDED pixel coordinates (as generate_rays);
    # the padding tiles extrapolate the linear edge functions.
    mat, attr = perspective_rows(camera, width, height)
    group = binning == "group" or tile_qmin is not None
    if group:
        tables = build_frame_tables(bvh.tri_v0, bvh.tri_e1, bvh.tri_e2,
                                    bvh.tri_valid, mat, attr, wp, hp)
        q, tri, overflow, qmin_out, visits = rasterize(
            tables, wp, hp, jit2, tile_qmin=tile_qmin)
        extra = {"visits": visits}
    else:
        planes, rect, q_tri = project_planes(bvh.tri_v0, bvh.tri_e1,
                                             bvh.tri_e2, bvh.tri_valid, mat,
                                             attr, wp, hp)
        pair_tri, seg = bin_pairs(rect, q_tri, wp, hp)
        q, tri, u, v = rasterize_tiles(planes, pair_tri, seg, jit2, wp, hp)
        qmin_out = tile_min(q, wp, hp)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        extra = {"pairs": seg[-1]}

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
    if group:
        # The winner's perspective-correct barycentrics at the sample, from
        # its plane rows, as the pair kernel computes them (the same bits
        # where both paths pick the same triangle).  JAX's group branch
        # (`:857-877`) takes them from the dense rows at o + t d instead:
        # t comes from q, whose float32 plane is off by up to ~1e-3 of a
        # small far triangle's depth, and that point lies off the triangle
        # by up to its size.
        rows = tables.planes[torch.clamp(tri, min=0).long()]
        px = x[None, :].expand(height, width).reshape(-1)
        py = y[:, None].expand(height, width).reshape(-1)
        qs = torch.clamp(q, min=1e-30)
        u = ((rows[:, 3] * px + rows[:, 4] * py) + rows[:, 5]) / qs
        v = ((rows[:, 6] * px + rows[:, 7] * py) + rows[:, 8]) / qs
    else:
        u, v = crop(u), crop(v)
    uv = torch.where(hit[:, None], torch.stack([u, v], -1), 0.0)
    return {"t": t, "tri": tri, "uv": uv, "hit": hit, "overflow": overflow,
            "tile_qmin": qmin_out, **extra}
