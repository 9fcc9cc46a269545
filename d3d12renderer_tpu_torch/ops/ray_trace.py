"""Closest-hit and any-hit ray queries over the dense plane table: the
wrappers of the two CUDA ray kernels (`csrc/ray_trace.cu`), their plain
PyTorch version, and the one dispatch `trace` that render/bvh.py's
`closest_hit` / `any_hit` call.

Counterpart of ``d3d12renderer_tpu/ops/ray_trace_pallas.py``:

* `ray_closest_hit_bvh` (kernel #3's port, `_culled_kernel` `:333`): one
  thread per ray walks the BVH; scenes of more than TRI_CHUNK rows.
* `ray_closest_hit_brute` (kernel #4's port, `_kernel` `:157`): every ray
  against every row; scenes of at most TRI_CHUNK rows.
* `closest_hit_plain`: the all-pairs plane test as tensor ops, the same
  operations in the same order as the kernels (ray_plane.cuh), on any
  device.  CPU tensors always take it.

The contract is the Pallas backend's: `{t, tri, uv, hit}` with `t = t_max`
and `tri = -1` on a miss; `tri` a row of the BVH's leaf-ordered soup, the
lowest row on an exact tie in t; `uv` recomputed from the hit point (as
`_uv_outside` `:402`).  In any-hit mode only `hit` is part of the contract
(something lies at t in [1e-4, t_max)); `uv` is zero.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict

import torch

from ..core import profiling
from ..cuda_build import launcher

TRI_CHUNK = 1024         # ray_trace_pallas.TRI_CHUNK: the dispatch threshold
# Mirrors of csrc/ray_plane.cuh.
PLANE_COLS = 16
NODE_COLS = 8
MAX_STACK = 64
ERR_STACK = 1
# Node boxes grow by this much in every axis in the kernel's node table:
# the plane test accepts points up to ~1e-5 (scene units, at scene scales
# below ~100) outside a triangle's exact extent, and the float64 -> float32
# rounding of a box can shrink it by half an ulp.  With the pad the walk
# reaches every row that the brute-force test accepts, so both kernels and
# the plain version return the same bits.
BOX_PAD_ABS = 1e-3
BOX_PAD_REL = 1e-5
# Rays per block of the plain version (bounds its (rays, TRI_CHUNK)
# intermediates to ~0.5 GB).
PLAIN_RAY_BLOCK = 8192


class RayArgs(ctypes.Structure):
    """ray_plane.cuh `RayArgs`."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "origin", "direction", "t_max", "planes", "nodes", "t_out",
        "tri_out", "error", "stats")] + [(name, ctypes.c_int) for name in (
            "num_rays", "num_tris", "num_nodes", "any_hit", "stack_limit",
            "pad_")]


# --------------------------------------------------------------------------
# The kernels' tables
# --------------------------------------------------------------------------

def plane_table(dense) -> torch.Tensor:
    """(T, 16) rows [n, n_off, e1p, e1_off, e2p, e2_off, valid, 0, 0, 0]:
    `ray_trace_pallas.pack_tris`'s table with a row per triangle (a thread
    reads one 64-byte row) and no chunk padding."""
    t = dense.n.shape[0]
    return torch.cat([
        dense.n, dense.n_off[:, None], dense.e1p, dense.e1_off[:, None],
        dense.e2p, dense.e2_off[:, None],
        dense.valid.to(torch.float32)[:, None],
        dense.n.new_zeros((t, 3))], dim=1).contiguous()


def node_table(bvh) -> torch.Tensor:
    """(N, 8) float32 rows [lo.xyz, hi.xyz, link, count], the last two int32
    bits: a leaf's first row and row count, or an inner node's right child
    (`node_miss[i + 1]`; its left child is i + 1) and 0.  Boxes padded by
    BOX_PAD_ABS + BOX_PAD_REL |coordinate|."""
    lo, hi = bvh.node_min, bvh.node_max
    lo = lo - (BOX_PAD_ABS + BOX_PAD_REL * lo.abs())
    hi = hi + (BOX_PAD_ABS + BOX_PAD_REL * hi.abs())
    n = lo.shape[0]
    count = bvh.node_count.to(torch.int32)
    right = torch.cat([bvh.node_miss[1:], bvh.node_miss[-1:]]).to(torch.int32)
    link = torch.where(count > 0, bvh.node_first.to(torch.int32), right)
    links = torch.stack([link, count], dim=1).view(torch.float32)
    return torch.cat([lo, hi, links], dim=1).reshape(n, NODE_COLS).contiguous()


def kernel_tables(bvh):
    """(planes, nodes), built once per BVH and kept in `bvh.cache`."""
    if "ray_tables" not in bvh.cache:
        bvh.cache["ray_tables"] = (plane_table(bvh.dense), node_table(bvh))
    return bvh.cache["ray_tables"]


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def _dot(ax, ay, az, b):
    """(ax * b.x + ay * b.y) + az * b.z for (R, 1) ray components and
    (C, 3+) rows: the kernel's `ray_dot` order, one tensor op per step."""
    return (ax * b[:, 0] + ay * b[:, 1]) + az * b[:, 2]


def closest_hit_plain(planes, origin, direction, t_max, any_hit=False):
    """All pairs, TRI_CHUNK rows at a time: (t, tri) as the kernels return
    them.  In any-hit mode the closest hit is returned (a valid any-hit
    answer)."""
    del any_hit                    # the closest hit answers both queries
    out_t, out_tri = [], []
    cols = torch.arange(TRI_CHUNK, device=planes.device)
    for r0 in range(0, origin.shape[0], PLAIN_RAY_BLOCK):
        o = origin[r0:r0 + PLAIN_RAY_BLOCK]
        d = direction[r0:r0 + PLAIN_RAY_BLOCK]
        t_best = t_max[r0:r0 + PLAIN_RAY_BLOCK].clone()
        tri_best = torch.full_like(t_best, -1, dtype=torch.int32)
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        for c0 in range(0, planes.shape[0], TRI_CHUNK):
            p = planes[c0:c0 + TRI_CHUNK]
            t = (p[:, 3] - _dot(ox, oy, oz, p[:, 0:3])) / _dot(dx, dy, dz, p[:, 0:3])
            u = (_dot(ox, oy, oz, p[:, 4:7]) + p[:, 7]) + t * _dot(dx, dy, dz, p[:, 4:7])
            v = (_dot(ox, oy, oz, p[:, 8:11]) + p[:, 11]) + t * _dot(dx, dy, dz, p[:, 8:11])
            ok = ((u >= 0) & (v >= 0) & ((1.0 - (u + v)) >= 0)
                  & ((t - 1e-4) >= 0) & ((t_best[:, None] - t) >= 0))
            t_m = torch.where(ok, t, torch.inf)
            t_min = t_m.min(dim=1).values
            first = torch.where(t_m == t_min[:, None], cols[:p.shape[0]],
                                TRI_CHUNK).min(dim=1).values
            better = t_min < t_best
            t_best = torch.where(better, t_min, t_best)
            tri_best = torch.where(better, (c0 + first).to(torch.int32),
                                   tri_best)
        out_t.append(t_best)
        out_tri.append(tri_best)
    if not out_t:
        return t_max.clone(), torch.full_like(t_max, -1, dtype=torch.int32)
    return torch.cat(out_t), torch.cat(out_tri)


# --------------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or not x.is_contiguous() or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape}, got {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, origin on {device}")


def new_error_word(device) -> torch.Tensor:
    """A zeroed error word that the ray kernels OR their error bits into."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def raise_on_error(error, stack_limit: int = MAX_STACK):
    """Reads an error word (a sync on the card) and raises if a kernel set
    a bit in it."""
    if int(error.item()) & ERR_STACK:
        raise RuntimeError(f"ray kernel: a BVH walk overflowed its "
                           f"{stack_limit}-entry stack")


class DeferredError:
    """An error word read a frame late, so that a frame's ray queries never
    wait for the card: `word` goes to the kernels (`launch`'s `error`),
    `arm()` after the frame copies it to pinned host memory without
    waiting, `poll()` before the next frame raises if a copy that has
    landed holds an error bit, and `check()` waits and raises.  The word
    is never cleared: a set bit stays set until it is read."""

    def __init__(self, device, stack_limit: int = MAX_STACK):
        self.word = new_error_word(device)
        self.cuda = self.word.is_cuda
        self.host = torch.zeros((1,), dtype=torch.int32,
                                pin_memory=self.cuda)
        self.event = None
        self.stack_limit = stack_limit

    def _raise(self):
        if int(self.host[0]) & ERR_STACK:
            raise RuntimeError(f"ray kernel: a BVH walk overflowed its "
                               f"{self.stack_limit}-entry stack")

    def arm(self):
        self.host.copy_(self.word, non_blocking=self.cuda)
        if self.cuda:
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self._raise()

    def poll(self):
        if self.event is not None and self.event.query():
            self._raise()

    def check(self):
        if self.event is not None:
            self.event.synchronize()
        self.host.copy_(self.word)
        self._raise()


def launch(launch_fn: Callable, planes, nodes, origin, direction, t_max,
           any_hit: bool, stack_limit: int = MAX_STACK, stats=None,
           error=None):
    """Checks the inputs, allocates the outputs, calls `launch_fn(RayArgs*)`
    and raises if it reports an error.  `launch_fn` is a CUDA launcher bound
    to a device and stream (the wrappers below) or, in the CPU tests, the
    kernel source compiled as host code.  The kernel ORs its error bits into
    `error`, a (1,) int32 word that the caller reads later with
    `raise_on_error` (no sync here); without one, a word of its own is read
    right after the launch.  `stats`, a (2,) int64 tensor, receives the
    plane tests and box tests the kernel ran (added to it)."""
    dev, r = origin.device, origin.shape[0]
    _check("origin", origin, torch.float32, (r, 3), dev)
    _check("direction", direction, torch.float32, (r, 3), dev)
    _check("t_max", t_max, torch.float32, (r,), dev)
    _check("planes", planes, torch.float32, (planes.shape[0], PLANE_COLS), dev)
    if nodes is not None:
        _check("nodes", nodes, torch.float32, (nodes.shape[0], NODE_COLS), dev)
    if stats is not None:
        _check("stats", stats, torch.int64, (2,), dev)
    check_now = error is None
    if check_now:
        error = new_error_word(dev)
    _check("error", error, torch.int32, (1,), dev)
    for name, x in (("planes", planes), ("nodes", nodes)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    t_out = torch.empty_like(t_max)
    tri_out = torch.empty((r,), dtype=torch.int32, device=dev)
    args = RayArgs(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
                   planes.data_ptr(), 0 if nodes is None else nodes.data_ptr(),
                   t_out.data_ptr(), tri_out.data_ptr(), error.data_ptr(),
                   0 if stats is None else stats.data_ptr(),
                   r, planes.shape[0], 0 if nodes is None else nodes.shape[0],
                   int(any_hit), stack_limit, 0)
    err = launch_fn(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"ray kernel launch failed: error {err}")
    if check_now:
        raise_on_error(error, stack_limit)
    return t_out, tri_out


def ray_closest_hit_bvh(planes, nodes, origin, direction, t_max,
                        any_hit=False, stack_limit=MAX_STACK, stats=None,
                        error=None):
    """Kernel #3's port on CUDA tensors; the plain version on CPU tensors.
    Counts its launches in `ray_closest_hit_bvh.launches`.  `error`: see
    `launch`."""
    if not origin.is_cuda:
        return closest_hit_plain(planes, origin, direction, t_max, any_hit)
    out = launch(launcher("ray_closest_hit_bvh_launch", origin.device),
                 planes, nodes, origin, direction, t_max, any_hit, stack_limit,
                 stats, error)
    ray_closest_hit_bvh.launches += 1
    return out


def ray_closest_hit_brute(planes, origin, direction, t_max, any_hit=False,
                          stats=None, error=None):
    """Kernel #4's port on CUDA tensors; the plain version on CPU tensors.
    Counts its launches in `ray_closest_hit_brute.launches`."""
    if not origin.is_cuda:
        return closest_hit_plain(planes, origin, direction, t_max, any_hit)
    out = launch(launcher("ray_closest_hit_brute_launch", origin.device),
                 planes, None, origin, direction, t_max, any_hit,
                 stats=stats, error=error)
    ray_closest_hit_brute.launches += 1
    return out


ray_closest_hit_bvh.launches = 0
ray_closest_hit_brute.launches = 0


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

REGROUP_BITS = 4        # regroup_perm's cell bits per axis (obits = dbits)


@functools.lru_cache(maxsize=8)
def _regroup_key_table(device):
    """(6, 16) int32: a cell index q of key axis c (direction x, y, z, then
    origin x, y, z) as its bits in the 24-bit Morton key, bit b of q at bit
    6 b + 5 - c (MSB-first levels, direction before origin in each)."""
    q = torch.arange(1 << REGROUP_BITS)
    spread = sum(((q >> b) & 1) << (6 * b) for b in range(REGROUP_BITS))
    table = spread[None, :] << torch.arange(5, -1, -1)[:, None]
    return table.to(torch.int32).to(device), torch.arange(6, device=device)


def regroup_perm(o, d, lo, hi):
    """`ray_trace_pallas.regroup_perm` (its default obits = dbits = 4): rays
    sorted (stably) by a 6-axis MSB-first Morton key of the direction cell
    (over [-1, 1]) and the origin cell (inside [lo, hi]).  The key is built
    by one table lookup per axis instead of JAX's 24 shift-and-or steps."""
    cells = 1 << REGROUP_BITS
    oq = torch.clamp((o - lo) / torch.clamp(hi - lo, min=1e-6) * cells,
                     0.0, cells - 1.0)
    dq = torch.clamp((d * 0.5 + 0.5) * cells, 0.0, cells - 1.0)
    # NaN would index out of the table; JAX's cast leaves it undefined too.
    q = torch.cat([dq, oq], 1).nan_to_num_(0.0).to(torch.int64)
    table, axes = _regroup_key_table(o.device)
    key = table[axes, q].sum(1, dtype=torch.int32)
    return torch.sort(key, stable=True).indices


def uv_from_hit(dense, origin, direction, t, tri, hit):
    """The winner's barycentrics from its plane rows at p = o + t d
    (`_uv_outside`); zero where there is no hit."""
    ti = torch.clamp(tri, min=0).long()
    p = origin + t[:, None] * direction
    u = torch.sum(p * dense.e1p[ti], -1) + dense.e1_off[ti]
    v = torch.sum(p * dense.e2p[ti], -1) + dense.e2_off[ti]
    return torch.where(hit[:, None], torch.stack([u, v], -1), 0.0)


def trace(bvh, origin, direction, t_max=1e30, regroup=False,
          any_hit=False, error=None, stats=None,
          uv: bool = True) -> Dict[str, torch.Tensor]:
    """The one dispatch, as JAX's Pallas backend (`closest_hit_pallas`
    `:577-581`, `bvh.any_hit` `:620-629`): more than TRI_CHUNK rows -> the
    BVH kernel, else the brute-force kernel; CPU tensors -> the plain
    version.  `regroup` sorts the rays by `regroup_perm` first and scatters
    t and tri back (multi-chunk scenes only, as in JAX); an exact
    permutation.  origin/direction (R, 3) float32; t_max a scalar or (R,).
    `error`: the kernels' error word, read later by the caller (`launch`).
    `stats`: a (2,) int64 tensor the kernel adds its plane and box tests to
    (`launch`; the plain version adds nothing).  A scalar `t_max` is filled
    on the device (a tensor made from a host number waits for the card).
    `uv=False` leaves the barycentrics out (`uv` None): a depth query.

    Spans (`core/profiling.py`), device-timed on the card: `ray.trace`,
    the whole query, holding `ray.walk` (the kernel's launch) and, where
    the rays are regrouped, a `ray.regroup` before it (the permutation and
    the gathers) and one after it (the scatter back)."""
    on_card = origin.is_cuda
    with profiling.profile_block("ray.trace", device=on_card):
        dense = bvh.dense
        r = origin.shape[0]
        origin = origin.contiguous()
        direction = direction.contiguous()
        if isinstance(t_max, torch.Tensor):
            t_max = t_max.to(dtype=torch.float32, device=origin.device)
            t_max = t_max.expand(r).contiguous()
        else:
            t_max = torch.full((r,), float(t_max), dtype=torch.float32,
                               device=origin.device)
        multi_chunk = dense.n.shape[0] > TRI_CHUNK
        planes, nodes = kernel_tables(bvh)

        def query(o, d, tm):
            with profiling.profile_block("ray.walk", device=on_card):
                if multi_chunk:
                    return ray_closest_hit_bvh(planes, nodes, o, d, tm,
                                               any_hit, stats=stats,
                                               error=error)
                return ray_closest_hit_brute(planes, o, d, tm, any_hit,
                                             stats=stats, error=error)

        if regroup and multi_chunk:
            with profiling.profile_block("ray.regroup", device=on_card):
                if "regroup_bounds" not in bvh.cache:
                    bvh.cache["regroup_bounds"] = (
                        dense.cluster_lo.min(0).values,
                        dense.cluster_hi.max(0).values)
                perm = regroup_perm(origin, direction,
                                    *bvh.cache["regroup_bounds"])
                rows = origin[perm], direction[perm], t_max[perm]
            t_p, tri_p = query(*rows)
            with profiling.profile_block("ray.regroup", device=on_card):
                t, tri = torch.empty_like(t_p), torch.empty_like(tri_p)
                t[perm] = t_p
                tri[perm] = tri_p
        else:
            t, tri = query(origin, direction, t_max)
        hit = tri >= 0
        if not uv:
            return {"t": t, "tri": tri, "uv": None, "hit": hit}
        if any_hit:
            uv = torch.zeros((r, 2), dtype=torch.float32,
                             device=origin.device)
        else:
            uv = uv_from_hit(dense, origin, direction, t, tri, hit)
        return {"t": t, "tri": tri, "uv": uv, "hit": hit}
