"""Two-level instancing (counterpart of
``d3d12renderer_tpu/render/instances.py``): every instance's triangles
packed once into one buffer with a per-triangle instance id, and per frame
the instance poses applied on the device and the plane table rebuilt, with
no host round trip.

The JAX package's per-frame BVH is a one-node shell that its dense ray
backend brute-forces; `retransform` builds that shell (one leaf holding
every row, bounded by the posed triangles).  The port's ray dispatch walks
the node table for scenes of more than `ray_trace.TRI_CHUNK` rows, and a
walk of one leaf tests every row.  `retransform(..., tree=True)`, the path
of every caller (the flythrough, the showcase world, the editor's scenes),
refits a tree of fixed topology instead: built once on the host from the
buffer's layout (`instance_tree`: a balanced tree over the instances, under
each a balanced tree over its rows in LEAF_ROWS-row leaves, in buffer
order), its boxes taken on the device from the posed triangles every frame
(`refit_tree`: two scatter-min/max over (node, row) pairs, static shapes,
no host read).  The rows keep their order, so hits are those of the one
leaf: t and hit bit for bit, and tri too (the walk keeps the lowest row on
a tie in t, whatever the order it visits leaves in).  The tree is only as
tight as the buffer's order is local: a mesh's triangles in an order that
jumps across it give loose leaves, never wrong ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core import maths as m
from ..cuda_build import resolve_device
from .bvh import BVH, build_dense
from .mesh import MeshData

# The JAX package pads the buffer to a multiple of 512 rows.
PAD_ROWS = 512
# Rows a leaf of `instance_tree` holds at most (the host builder's
# LEAF_SIZE).
LEAF_ROWS = 4


@dataclass
class InstancedScene:
    """Per-instance triangle buffer (mesh-local) with instance ids."""

    v0: torch.Tensor          # (T, 3)
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor          # (T, 3)
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material: torch.Tensor    # (T,) int32
    instance: torch.Tensor    # (T,) int64 instance id per triangle
    valid: torch.Tensor       # (T,) bool


def build_instanced(meshes: List[Tuple[MeshData, int]],
                    instance_mesh: Sequence[int],
                    device="cuda") -> InstancedScene:
    """`meshes[k]` = (mesh, material); `instance_mesh[i]` = the mesh of
    instance i.  Triangles are replicated per instance once, here."""
    device = resolve_device(device)
    parts = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0",
                             "uv1", "uv2", "material", "instance")}
    for i, mesh_id in enumerate(instance_mesh):
        mesh, mat = meshes[mesh_id]
        idx = mesh.indices
        for k in range(3):
            parts[f"v{k}"].append(mesh.positions[idx[:, k]])
            parts[f"n{k}"].append(mesh.normals[idx[:, k]])
            parts[f"uv{k}"].append(mesh.uvs[idx[:, k]])
        parts["material"].append(np.full(len(idx), mat, np.int32))
        parts["instance"].append(np.full(len(idx), i, np.int64))
    t = sum(len(x) for x in parts["material"])
    pad = (-t) % PAD_ROWS

    def padded(key, dtype):
        x = np.concatenate(parts[key]).astype(dtype)
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], dtype)])
        return torch.as_tensor(x, device=device)

    return InstancedScene(
        **{k: padded(k, np.float32) for k in ("v0", "v1", "v2", "n0", "n1",
                                              "n2", "uv0", "uv1", "uv2")},
        material=padded("material", np.int32),
        instance=padded("instance", np.int64),
        valid=torch.as_tensor(np.arange(t + pad) < t, device=device))


@dataclass
class InstanceTree:
    """A fixed tree over an instanced buffer's rows (`instance_tree`): DFS
    pre-order nodes with skip links, each covering one contiguous run of
    rows, and the (node, row) pairs that `refit_tree` reduces over."""

    node_first: torch.Tensor  # (N,) int32: a leaf's first row, -1 inner
    node_count: torch.Tensor  # (N,) int32: a leaf's rows, 0 inner
    node_miss: torch.Tensor   # (N,) int32: the node after the subtree
    pair_node: torch.Tensor   # (P,) int64
    pair_row: torch.Tensor    # (P,) int64


def _ranges(scene: InstancedScene):
    """Each instance's (first, end) rows, in buffer order (host)."""
    inst = scene.instance.cpu().numpy()
    valid = scene.valid.cpu().numpy()
    rows = np.flatnonzero(valid)
    if rows.size == 0:
        return []
    ids = inst[rows]
    cuts = np.flatnonzero(np.diff(ids)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [rows.size]])
    return [(int(rows[a]), int(rows[b - 1]) + 1) for a, b in zip(starts, ends)]


def instance_tree(scene: InstancedScene) -> InstanceTree:
    """The buffer's tree, built once per scene (kept on it): a balanced
    binary tree over the instances' runs of rows, each run split in halves
    down to leaves of at most LEAF_ROWS rows."""
    cached = getattr(scene, "_tree", None)
    if cached is not None:
        return cached
    runs = []                        # the leaves' (first, end), in order
    for a, b in _ranges(scene):
        runs += [(r, min(r + LEAF_ROWS, b)) for r in range(a, b, LEAF_ROWS)]
    bounds = [a for a, _ in _ranges(scene)]
    first, count, size, cover = [], [], [], []

    def emit(lo: int, hi: int) -> int:
        """Nodes over leaves [lo, hi); split at an instance boundary nearest
        the middle while the range spans instances, else at the middle."""
        me = len(first)
        first.append(-1)
        count.append(0)
        size.append(1)
        cover.append((runs[lo][0], runs[hi - 1][1]))
        if hi - lo == 1:
            first[me], count[me] = runs[lo][0], runs[lo][1] - runs[lo][0]
            return 1
        inside = [k for k in range(lo + 1, hi) if runs[k][0] in starts]
        mid = (min(inside, key=lambda k: (abs(2 * k - lo - hi), k))
               if inside else (lo + hi) // 2)
        size[me] = 1 + emit(lo, mid) + emit(mid, hi)
        return size[me]

    starts = set(bounds)
    if runs:
        emit(0, len(runs))
    else:                            # no row: one empty leaf
        first, count, size, cover = [0], [0], [1], [(0, 0)]
    n = len(first)
    miss = [i + size[i] for i in range(n)]
    dev = scene.v0.device
    pair_node = np.concatenate([np.full(b - a, i, np.int64)
                                for i, (a, b) in enumerate(cover)])
    pair_row = np.concatenate([np.arange(a, b, dtype=np.int64)
                               for a, b in cover])

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    tree = InstanceTree(
        node_first=i32(first), node_count=i32(count), node_miss=i32(miss),
        pair_node=torch.as_tensor(pair_node, device=dev),
        pair_row=torch.as_tensor(pair_row, device=dev))
    scene._tree = tree
    return tree


def refit_tree(tree: InstanceTree, v0, v1, v2):
    """(node_min, node_max) (N, 3) of the tree's nodes over posed rows: the
    least and greatest corner of the rows each node covers."""
    lo = torch.minimum(torch.minimum(v0, v1), v2)[tree.pair_row]
    hi = torch.maximum(torch.maximum(v0, v1), v2)[tree.pair_row]
    n = tree.node_first.shape[0]
    index = tree.pair_node[:, None].expand(-1, 3)
    node_min = torch.full((n, 3), torch.inf, device=v0.device).scatter_reduce_(
        0, index, lo, "amin")
    node_max = torch.full((n, 3), -torch.inf, device=v0.device).scatter_reduce_(
        0, index, hi, "amax")
    return node_min, node_max


def retransform(scene: InstancedScene, positions, rotations,
                scales=None, tree: bool = False) -> BVH:
    """The per-frame BVH of the instances at `positions` (I, 3) and
    `rotations` (I, 4), optionally scaled (I,): triangles posed on the
    device, the plane table rebuilt, and one leaf over every row (JAX's
    shell), or with `tree` the buffer's fixed tree refitted over the posed
    rows (`instance_tree`, `refit_tree`)."""
    inst = scene.instance
    pos = positions[inst]
    rot = rotations[inst]
    s = scales[inst][:, None] if scales is not None else 1.0

    def xf(v):
        return pos + m.quat_rotate(rot, v * s)

    v0, v1, v2 = xf(scene.v0), xf(scene.v1), xf(scene.v2)
    dev = v0.device
    if tree:
        fixed = instance_tree(scene)
        lo, hi = refit_tree(fixed, v0, v1, v2)
        nodes = dict(node_first=fixed.node_first,
                     node_count=fixed.node_count, node_miss=fixed.node_miss)
    else:
        lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0, keepdim=True)
        hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0, keepdim=True)
        nodes = dict(
            node_first=torch.zeros((1,), dtype=torch.int32, device=dev),
            node_count=torch.full((1,), v0.shape[0], dtype=torch.int32,
                                  device=dev),
            node_miss=torch.ones((1,), dtype=torch.int32, device=dev))
    bvh = BVH(
        node_min=lo, node_max=hi, **nodes,
        tri_v0=v0, tri_e1=v1 - v0, tri_e2=v2 - v0,
        tri_n0=m.quat_rotate(rot, scene.n0), tri_n1=m.quat_rotate(rot, scene.n1),
        tri_n2=m.quat_rotate(rot, scene.n2),
        tri_uv0=scene.uv0, tri_uv1=scene.uv1, tri_uv2=scene.uv2,
        tri_material=scene.material, tri_valid=scene.valid)
    bvh.dense = build_dense(bvh)
    return bvh


def render_bodies(scene: InstancedScene, body_state, materials, sky,
                  camera, width, height, spp=4, settings=None, sampler=None):
    """Physics state (`pos` (I, 3), `rot` (I, 4)) -> path-traced image, on
    the device: `retransform` then `pathtracer.render` (depth 2 unless
    `settings` say otherwise)."""
    from .pathtracer import PathTracerSettings, Scene, render

    bvh = retransform(scene, body_state.pos, body_state.rot, tree=True)
    return render(Scene(bvh=bvh, materials=materials, sky=sky), camera,
                  width, height,
                  settings or PathTracerSettings(recursion_depth=2), spp=spp,
                  sampler=sampler)
