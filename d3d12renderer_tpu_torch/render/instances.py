"""Two-level instancing (counterpart of
``d3d12renderer_tpu/render/instances.py``): every instance's triangles
packed once into one buffer with a per-triangle instance id, and per frame
the instance poses applied on the device and the plane table rebuilt, with
no host round trip.

The JAX package's per-frame BVH is a one-node shell that its dense ray
backend brute-forces.  The port's ray dispatch walks the node table for
scenes of more than `ray_trace.TRI_CHUNK` rows, so the shell here is one
leaf holding every row, bounded by the posed triangles: the walk tests
every row, as the brute force does.
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


def retransform(scene: InstancedScene, positions, rotations,
                scales=None) -> BVH:
    """The per-frame BVH of the instances at `positions` (I, 3) and
    `rotations` (I, 4), optionally scaled (I,): triangles posed on the
    device, the plane table rebuilt, one leaf over every row."""
    inst = scene.instance
    pos = positions[inst]
    rot = rotations[inst]
    s = scales[inst][:, None] if scales is not None else 1.0

    def xf(v):
        return pos + m.quat_rotate(rot, v * s)

    v0, v1, v2 = xf(scene.v0), xf(scene.v1), xf(scene.v2)
    lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0, keepdim=True)
    hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0, keepdim=True)
    dev = v0.device
    bvh = BVH(
        node_min=lo, node_max=hi,
        node_first=torch.zeros((1,), dtype=torch.int32, device=dev),
        node_count=torch.full((1,), v0.shape[0], dtype=torch.int32,
                              device=dev),
        node_miss=torch.ones((1,), dtype=torch.int32, device=dev),
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

    bvh = retransform(scene, body_state.pos, body_state.rot)
    return render(Scene(bvh=bvh, materials=materials, sky=sky), camera,
                  width, height,
                  settings or PathTracerSettings(recursion_depth=2), spp=spp,
                  sampler=sampler)
