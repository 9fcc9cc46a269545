"""BVH build (host) and the ray queries over it (device).

Counterpart of ``d3d12renderer_tpu/render/bvh.py``.  The tree is built on
the host by the median-split builder of `csrc/bvh_build.cpp` (native, built
with g++ at first use; `_build_nodes_numpy` is its numpy copy for the tests)
into DFS pre-order nodes with skip ("miss") links and a leaf-ordered,
LEAF_SIZE-padded triangle soup, identical to the JAX package's arrays.  The
dense plane table (`DenseTris`) is built for every scene: both ray kernels
read it.  `closest_hit` / `any_hit` are the one dispatch to the kernels
(`ops/ray_trace.py`), with the JAX Pallas backend's contract; the JAX
package's other backends are not ported.  Trees of large scenes are kept
in a disk cache (`build_bvh`, BVH_CACHE_*).
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import maths as m
from ..cuda_build import CSRC_DIR, load_host_library, resolve_device
from ..ops import ray_trace
from .mesh import MeshData

LEAF_SIZE = 4
TRI_CHUNK = ray_trace.TRI_CHUNK


@dataclass
class DenseTris:
    """Plane-form triangle soup in the BVH's leaf order: u = e1p.p + e1_off
    and v = e2p.p + e2_off are the barycentrics of p on the triangle's
    plane n.p = n_off.  `cluster_lo/hi` are the AABBs of TRI_CHUNK-row
    chunks (the bounds of `regroup`)."""

    n: torch.Tensor          # (T, 3) geometric normal (unnormalized)
    n_off: torch.Tensor      # (T,)
    e1p: torch.Tensor        # (T, 3)
    e1_off: torch.Tensor     # (T,)
    e2p: torch.Tensor        # (T, 3)
    e2_off: torch.Tensor     # (T,)
    valid: torch.Tensor      # (T,) bool
    cluster_lo: torch.Tensor  # (ceil(T / TRI_CHUNK), 3)
    cluster_hi: torch.Tensor


@dataclass
class BVH:
    node_min: torch.Tensor    # (N, 3)
    node_max: torch.Tensor    # (N, 3)
    node_first: torch.Tensor  # (N,) first triangle (leaves) or -1
    node_count: torch.Tensor  # (N,) triangle count (0 for inner)
    node_miss: torch.Tensor   # (N,) skip pointer (N = done)
    tri_v0: torch.Tensor      # (T, 3)
    tri_e1: torch.Tensor      # (T, 3) v1 - v0
    tri_e2: torch.Tensor      # (T, 3) v2 - v0
    tri_n0: torch.Tensor      # (T, 3) vertex normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor     # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_material: torch.Tensor  # (T,) int32
    tri_valid: torch.Tensor   # (T,) bool (padding rows False)
    dense: Optional[DenseTris] = None
    # Device tables built from the arrays above (the ray kernels' plane and
    # node tables), once per BVH.
    cache: dict = field(default_factory=dict, repr=False, compare=False)


BVH_FIELDS = ("node_min", "node_max", "node_first", "node_count", "node_miss",
              "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_material", "tri_valid")


# The disk cache of built trees (the JAX package's `render/bvh.py:57-129`
# contract with the port's own key, version, directory and variables, so
# that neither package reads the other's files): one `.npz` of host arrays
# per tree, keyed by a blake2b hash of the meshes' bytes, the builder kind,
# LEAF_SIZE and, for the native builder, csrc/bvh_build.cpp; an LRU by mtime
# keeps BVH_CACHE_KEEP files; scenes under BVH_CACHE_MIN_TRIS triangles are
# not cached.  BVH_CACHE_DIR_ENV overrides the directory and
# BVH_CACHE_ENV=0 turns the cache off.
BVH_CACHE_VERSION = "d3d12renderer_tpu_torch-bvh-1"
BVH_CACHE_MIN_TRIS = 50_000
BVH_CACHE_KEEP = 16
BVH_CACHE_DIR_ENV = "D3D12TPU_TORCH_BVH_CACHE_DIR"
BVH_CACHE_ENV = "D3D12TPU_TORCH_BVH_CACHE"
BVH_CACHE_DEFAULT_DIR = os.path.join("~", ".cache", "d3d12renderer_tpu_torch",
                                     "bvh")
BVH_BUILDER_SOURCE = CSRC_DIR / "bvh_build.cpp"


def bvh_cache_dir() -> str:
    """The cache directory (created): BVH_CACHE_DIR_ENV, else
    BVH_CACHE_DEFAULT_DIR under the home directory."""
    d = os.environ.get(BVH_CACHE_DIR_ENV) or os.path.expanduser(
        BVH_CACHE_DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def bvh_cache_key(meshes: List[Tuple[MeshData, int]], native: bool) -> str:
    """blake2b over the cache version, LEAF_SIZE, the builder kind (the
    native and numpy builders order a leaf's triangles differently), the
    native builder's source, and every mesh's arrays and material id."""
    h = hashlib.blake2b(digest_size=20)
    kind = "native" if native else "numpy"
    h.update(f"{BVH_CACHE_VERSION}|leaf{LEAF_SIZE}|{kind}".encode())
    if native:
        h.update(hashlib.sha256(BVH_BUILDER_SOURCE.read_bytes()).digest())
    for mesh, mat_id in meshes:
        for x in (mesh.positions, mesh.normals, mesh.uvs, mesh.indices):
            x = np.ascontiguousarray(x)
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(x.tobytes())
        h.update(f"|{int(mat_id)}".encode())
    return h.hexdigest()


def _cache_path(meshes, native: bool, cache: Optional[bool]):
    """The tree's cache file, or None where the cache is off, the scene is
    small or the directory cannot be made (an uncached build then)."""
    if cache is None:
        cache = (os.environ.get(BVH_CACHE_ENV, "1") != "0"
                 and sum(len(mesh.indices) for mesh, _ in meshes)
                 >= BVH_CACHE_MIN_TRIS)
    if not cache:
        return None
    try:
        return os.path.join(bvh_cache_dir(),
                            bvh_cache_key(meshes, native) + ".npz")
    except OSError:
        return None


def _cache_load(path: str):
    """The cached arrays, or None where the file is missing or unreadable
    (the caller rebuilds and overwrites it)."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in BVH_FIELDS}
        os.utime(path)
        return arrays
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def _cache_save(path: str, arrays: dict):
    """Write through a pid-suffixed temporary file and `os.replace` (two
    builders of one scene never interleave), then keep the newest
    BVH_CACHE_KEEP files.  A failure leaves the build uncached."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        d = os.path.dirname(path)
        files = sorted((os.path.join(d, f) for f in os.listdir(d)
                        if f.endswith(".npz")), key=os.path.getmtime)
        for old in files[:-BVH_CACHE_KEEP]:
            os.remove(old)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_bvh(meshes: List[Tuple[MeshData, int]], device="cuda",
              native: bool = True, cache: Optional[bool] = None) -> BVH:
    """Build from [(mesh, material_id), ...] on the host (median split) and
    upload to `device`, with the dense plane table.  `native=False` takes
    the numpy builder (the same tree, minutes at 100k+ triangles).  Scenes
    of BVH_CACHE_MIN_TRIS triangles or more read and write the disk cache
    (`cache=True` caches any scene, `cache=False` none); a tree read from
    it equals a fresh build bit for bit."""
    device = resolve_device(device)
    path = _cache_path(meshes, native, cache)
    arrays = _cache_load(path) if path and os.path.exists(path) else None
    if arrays is None:
        arrays = _build_arrays(meshes, native)
        if path:
            _cache_save(path, arrays)
    bvh = BVH(**{k: torch.as_tensor(arrays[k], device=device)
                 for k in BVH_FIELDS})
    bvh.dense = build_dense(bvh)
    return bvh


def _build_arrays(meshes, native: bool) -> dict:
    """The tree's host arrays (BVH_FIELDS) from the meshes."""
    parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0",
                             "uv1", "uv2", "mat")}
    for mesh, mat in meshes:
        p = mesh.positions.astype(np.float64)
        n, uv, i = mesh.normals, mesh.uvs, mesh.indices
        v0, v1, v2 = p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]
        parts["v0"].append(v0)
        parts["e1"].append(v1 - v0)
        parts["e2"].append(v2 - v0)
        for k in range(3):
            parts[f"n{k}"].append(n[i[:, k]])
            parts[f"uv{k}"].append(uv[i[:, k]])
        parts["mat"].append(np.full(len(i), mat, np.int32))
    a = {k: np.concatenate(v) for k, v in parts.items()}
    v0, e1, e2 = a["v0"], a["e1"], a["e2"]

    centroids = v0 + (e1 + e2) / 3.0
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    build = _build_nodes_native if native else _build_nodes_numpy
    node_min, node_max, node_first, node_count, miss, perm = build(
        lo, hi, centroids)
    t = len(perm)
    pad = (-t) % LEAF_SIZE if t else LEAF_SIZE
    valid = np.concatenate([np.ones(t, bool), np.zeros(pad, bool)])

    def take(x, fill=0.0):
        out = x[perm]
        return np.concatenate([out, np.full((pad,) + x.shape[1:], fill,
                                            x.dtype)])

    out = dict(node_min=node_min, node_max=node_max, node_first=node_first,
               node_count=node_count, node_miss=miss,
               tri_material=take(a["mat"], fill=0), tri_valid=valid)
    for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
        out[f"tri_{k}"] = take(a[k]).astype(np.float32)
    return {k: np.ascontiguousarray(out[k]) for k in BVH_FIELDS}


def _build_nodes_native(lo, hi, centroids):
    """`csrc/bvh_build.cpp` through ctypes; raises if it cannot be built or
    fails."""
    lib = load_host_library()
    t = len(lo)
    lo, hi, centroids = (np.ascontiguousarray(x, np.float64)
                         for x in (lo, hi, centroids))
    cap = 2 * t + 3
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_miss = np.empty(cap, np.int32)
    perm = np.empty(t, np.int64)
    n = lib.bvh_build(*(x.ctypes.data for x in (lo, hi, centroids)), t,
                      LEAF_SIZE, cap,
                      *(x.ctypes.data for x in (node_min, node_max,
                                                node_first, node_count,
                                                node_miss, perm)))
    if n < 0:
        raise RuntimeError(f"native BVH build failed for {t} triangles")
    return (node_min[:n].copy(), node_max[:n].copy(), node_first[:n].copy(),
            node_count[:n].copy(), node_miss[:n].copy(), perm)


def _build_nodes_numpy(lo, hi, centroids):
    """The median-split build in numpy (the same layout as the native
    builder): DFS pre-order nodes, skip links, leaf-order permutation."""
    nodes = []                  # (min, max, first, count); children at n+1
    order: List[np.ndarray] = []
    placed = [0]                # running leaf-triangle total

    def emit(tri_idx) -> int:
        my = len(nodes)
        bb_lo = lo[tri_idx].min(axis=0)
        bb_hi = hi[tri_idx].max(axis=0)
        if len(tri_idx) <= LEAF_SIZE:
            first = placed[0]
            placed[0] += len(tri_idx)
            order.append(tri_idx)
            nodes.append([bb_lo, bb_hi, first, len(tri_idx)])
            return my
        nodes.append([bb_lo, bb_hi, -1, 0])
        c = centroids[tri_idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # Tie-break by triangle index: the split SET is unique, as in the
        # native builder's nth_element.
        med = np.lexsort((tri_idx, c[:, axis]))
        half = len(tri_idx) // 2
        emit(tri_idx[med[:half]])
        emit(tri_idx[med[half:]])
        return my

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        emit(np.arange(len(lo)))
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nodes)
    # Miss links: node i's miss = the next sibling of its nearest ancestor,
    # from subtree sizes.
    size = np.ones(n_nodes, np.int64)
    for i in range(n_nodes - 1, -1, -1):
        if nodes[i][3] == 0:
            left = i + 1
            size[i] = 1 + size[left] + size[left + size[left]]
    miss = np.full(n_nodes, n_nodes, np.int32)
    stack = [(0, n_nodes)]
    while stack:
        i, mi = stack.pop()
        miss[i] = mi
        if nodes[i][3] == 0:
            left = i + 1
            right = left + size[left]
            stack.append((left, right))
            stack.append((right, mi))

    perm = np.concatenate(order) if order else np.zeros(0, np.int64)
    node_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    node_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    node_first = np.array([n[2] for n in nodes], np.int32)
    node_count = np.array([n[3] for n in nodes], np.int32)
    return node_min, node_max, node_first, node_count, miss, perm


def build_dense(bvh: BVH) -> DenseTris:
    """The plane table, in float32 on the BVH's device, in the JAX
    package's operation order."""
    v0, e1, e2 = bvh.tri_v0, bvh.tri_e1, bvh.tri_e2
    n = m.cross(e1, e2)
    nn = torch.sum(n * n, -1, keepdim=True)
    e1p = m.cross(e2, n) / torch.clamp(nn, min=1e-20)
    e2p = m.cross(n, e1) / torch.clamp(nn, min=1e-20)

    # Per-chunk AABBs; padding rows give inverted (+inf / -inf) bounds.
    t = v0.shape[0]
    pad = (-t) % TRI_CHUNK
    vld = bvh.tri_valid[:, None]
    tlo = torch.where(vld, torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2),
                      torch.inf)
    thi = torch.where(vld, torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2),
                      -torch.inf)
    tlo = torch.cat([tlo, tlo.new_full((pad, 3), torch.inf)])
    thi = torch.cat([thi, thi.new_full((pad, 3), -torch.inf)])
    return DenseTris(
        n=n, n_off=torch.sum(n * v0, -1),
        e1p=e1p, e1_off=-torch.sum(e1p * v0, -1),
        e2p=e2p, e2_off=-torch.sum(e2p * v0, -1),
        valid=bvh.tri_valid,
        cluster_lo=tlo.reshape(-1, TRI_CHUNK, 3).min(dim=1).values,
        cluster_hi=thi.reshape(-1, TRI_CHUNK, 3).max(dim=1).values)


def closest_hit(bvh: BVH, origin, direction, t_max=1e30, regroup=False,
                error=None, stats=None, uv: bool = True):
    """Closest hit of each ray: dict of t (R,), tri (R,) int32 (-1 = miss),
    uv (R, 2), hit (R,) bool.  `regroup` sorts scattered rays into
    coherent order inside the call (an exact permutation).  `error`: an
    error word the caller reads later (`ray_trace.launch`); `stats`: the
    kernel's (2,) plane and box test counts, added to; `uv=False`: no
    barycentrics (`uv` None)."""
    return ray_trace.trace(bvh, origin, direction, t_max, regroup=regroup,
                           error=error, stats=stats, uv=uv)


def any_hit(bvh: BVH, origin, direction, t_max, regroup=False, error=None):
    """Occlusion: True where something lies at t in [1e-4, t_max)."""
    return ray_trace.trace(bvh, origin, direction, t_max, regroup=regroup,
                           any_hit=True, error=error)["hit"]


def _geometric_normals(bvh: BVH):
    gn = m.cross(bvh.tri_e1, bvh.tri_e2)
    return gn / torch.clamp(torch.linalg.norm(gn, dim=-1, keepdim=True),
                            min=1e-9)


def _interpolate(rows, res):
    """Shading normal and uv of the hit from the gathered (R, >=18) rows."""
    u = res["uv"][:, 0:1]
    v = res["uv"][:, 1:2]
    w = 1.0 - u - v
    n = w * rows[:, 0:3] + u * rows[:, 3:6] + v * rows[:, 6:9]
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    uv = w * rows[:, 9:11] + u * rows[:, 11:13] + v * rows[:, 13:15]
    return n, uv


def hit_attributes(bvh: BVH, res):
    """Normal, geometric normal, uv and material at the hits."""
    table = torch.cat([bvh.tri_n0, bvh.tri_n1, bvh.tri_n2, bvh.tri_uv0,
                       bvh.tri_uv1, bvh.tri_uv2, _geometric_normals(bvh)], -1)
    tri = torch.clamp(res["tri"], min=0).long()
    n, uv = _interpolate(table[tri], res)
    return n, table[tri, 15:18], uv, bvh.tri_material[tri].to(torch.int32)


def build_shading_table(bvh: BVH, materials) -> torch.Tensor:
    """(T, 28) per-triangle shading rows: normals 0:9, uvs 9:15, geometric
    normal 15:18, material id 18, albedo 19:22, roughness 22, metallic 23,
    emissive 24:27, albedo texture 27 (-1 = none)."""
    mt = bvh.tri_material.long()
    tex = (materials.albedo_texture[mt][:, None].to(torch.float32)
           if materials.texture_atlas is not None
           else torch.full((mt.shape[0], 1), -1.0, device=mt.device))
    return torch.cat([
        bvh.tri_n0, bvh.tri_n1, bvh.tri_n2,
        bvh.tri_uv0, bvh.tri_uv1, bvh.tri_uv2,
        _geometric_normals(bvh),
        mt[:, None].to(torch.float32),
        materials.albedo[mt], materials.roughness[mt][:, None],
        materials.metallic[mt][:, None], materials.emissive[mt], tex], -1)


def hit_attributes_shaded(bvh: BVH, materials, res, table=None):
    """`hit_attributes` plus the hit's material values from the (T, 28)
    table (built here when `table` is None), the albedo modulated by the
    texture atlas where the material has a texture.

    Returns (n, gn, uv, mat_id, albedo, roughness, metallic, emissive)."""
    if table is None:
        table = build_shading_table(bvh, materials)
    rows = table[torch.clamp(res["tri"], min=0).long()]      # (R, 28)
    n, uv = _interpolate(rows, res)
    albedo = rows[:, 19:22]
    if materials.texture_atlas is not None:
        tix = rows[:, 27].to(torch.int32)
        has = tix >= 0
        t = torch.clamp(tix, min=0).long()
        r_ = materials.texture_atlas.shape[1]
        uu = torch.remainder(uv[:, 0], 1.0)
        vv = torch.remainder(uv[:, 1], 1.0)
        px = torch.clamp((uu * (r_ - 1)).to(torch.int32), 0, r_ - 1).long()
        py = torch.clamp((vv * (r_ - 1)).to(torch.int32), 0, r_ - 1).long()
        texv = materials.texture_atlas[t, py, px]
        albedo = torch.where(has[:, None], albedo * texv, albedo)
    return (n, rows[:, 15:18], uv, rows[:, 18].to(torch.int32), albedo,
            rows[:, 22], rows[:, 23], rows[:, 24:27])
