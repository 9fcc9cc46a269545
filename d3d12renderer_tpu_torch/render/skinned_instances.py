"""The animated render split: skinned meshes deform on the device each
frame and join the rigid instances' triangles (counterpart of
``d3d12renderer_tpu/render/skinned_instances.py``; reference
renderAnimatedObjects, src/scene/scene_rendering.cpp:548, drawing the
vertex buffers of the global skinning dispatch,
src/animation/skinning.cpp:235).

`build_frame_bvh` is the per-frame rebuild: the rigid instances posed, the
skinned instances sampled, posed and skinned, the rows concatenated in the
JAX package's order (rigid, then each skinned instance) and the plane
table rebuilt.  A skinned instance has no transform of its own: its clip's
root track places it.  Where the JAX package rebuilds a one-node shell that its
dense backend brute-forces, the port's shell is one leaf over every row
bounded by the posed triangles (as `instances.retransform`'s): the ray
kernels' walk tests every row.  Consecutive instances that share one mesh
and skeleton (a crowd, each with its own clip of one shape) pose in one
batched pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..animation.animation import (
    AnimationClip, Skeleton, forward_kinematics, sample_clip,
    skinning_transforms, stack_clips,
)
from ..animation.skinning import skin_vertices
from ..core import maths as m
from ..cuda_build import resolve_device
from .bvh import BVH, build_dense
from .instances import InstancedScene


@dataclass
class SkinnedInstance:
    """One skinned mesh with its skeleton and clip, render-ready."""

    positions: torch.Tensor      # (V, 3) bind-pose vertices
    normals: torch.Tensor        # (V, 3)
    uvs: torch.Tensor            # (V, 2)
    indices: torch.Tensor        # (T, 3) int64
    joint_indices: torch.Tensor  # (V, 4) int64
    joint_weights: torch.Tensor  # (V, 4)
    material: int
    skeleton: Skeleton
    clip: AnimationClip


def from_model_asset(asset, mesh_index: int = 0, clip_index: int = 0,
                     material: int = 0, device="cuda") -> SkinnedInstance:
    """From an imported FBX `ModelAsset` with skins and animations."""
    device = resolve_device(device)
    mesh = asset.meshes[mesh_index]
    skin = asset.mesh_skin[mesh_index]
    assert skin is not None, "mesh has no skin weights"

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return SkinnedInstance(
        positions=t(mesh.positions), normals=t(mesh.normals), uvs=t(mesh.uvs),
        indices=t(mesh.indices, torch.int64),
        joint_indices=t(skin.joint_indices, torch.int64),
        joint_weights=t(skin.joint_weights),
        material=int(material),
        skeleton=asset.skeletons[0].to_skeleton(device),
        clip=asset.animations[clip_index].to_clip(device))


def with_clip(inst: SkinnedInstance, clip: AnimationClip,
              material: Optional[int] = None) -> SkinnedInstance:
    """The same character (its mesh and skeleton tensors shared) playing
    `clip`, drawn with `material` (default its own)."""
    return SkinnedInstance(**{**inst.__dict__, "clip": clip,
                              "material": inst.material if material is None
                              else int(material)})


def deformed_triangles(inst: SkinnedInstance, t, materials=None, clip=None):
    """Skin at time `t` -> per-triangle corner tables.  `t` a float, or a
    tensor of times (B,) with `materials` (B,) one per pose, and `clip`
    (default the instance's) one clip or a stack of B: the B posed
    copies' rows follow each other."""
    pose = sample_clip(inst.clip if clip is None else clip, t)
    wp, wr = forward_kinematics(inst.skeleton, pose)
    sp, sr = skinning_transforms(inst.skeleton, wp, wr)
    p, n = skin_vertices(inst.positions, inst.normals, inst.joint_indices,
                         inst.joint_weights, sp, sr)
    idx = inst.indices
    rows = idx.shape[0]
    copies = p.shape[0] if p.dim() == 3 else 1
    p, n = p.reshape(copies, -1, 3), n.reshape(copies, -1, 3)

    def corner(x, k):
        return x[:, idx[:, k]].reshape(-1, x.shape[-1])

    uv = inst.uvs[None]
    dev = p.device
    if materials is None:
        material = torch.full((rows * copies,), inst.material,
                              dtype=torch.int32, device=dev)
    else:
        material = materials.to(torch.int32).repeat_interleave(rows)
    return dict(
        v0=corner(p, 0), v1=corner(p, 1), v2=corner(p, 2),
        n0=corner(n, 0), n1=corner(n, 1), n2=corner(n, 2),
        uv0=corner(uv, 0).repeat(copies, 1),
        uv1=corner(uv, 1).repeat(copies, 1),
        uv2=corner(uv, 2).repeat(copies, 1),
        material=material,
        valid=torch.ones((rows * copies,), dtype=torch.bool, device=dev),
    )


def _poses_with(a: SkinnedInstance, b: SkinnedInstance) -> bool:
    """b poses in one pass with a: one mesh and skeleton, clips of one
    key count, duration and looping."""
    return (all(getattr(a, k) is getattr(b, k) for k in (
        "positions", "normals", "uvs", "indices", "joint_indices",
        "joint_weights", "skeleton"))
        and a.clip.positions.shape == b.clip.positions.shape
        and a.clip.duration == b.clip.duration
        and a.clip.looping == b.clip.looping)


def build_frame_bvh(rigid: Optional[InstancedScene], rigid_pos, rigid_rot,
                    skinned: List[SkinnedInstance], times,
                    rigid_scales=None) -> BVH:
    """The frame's BVH with the animated split: the rigid instances at
    `rigid_pos` / `rigid_rot` (optionally scaled), each skinned instance
    at its time `times[i]` (a sequence of floats or a tensor), the rows
    concatenated and the plane table rebuilt; one leaf over every row."""
    blocks = []
    if rigid is not None:
        inst = rigid.instance
        pos = rigid_pos[inst]
        rot = rigid_rot[inst]
        s = (rigid_scales[inst][:, None] if rigid_scales is not None else 1.0)

        def xf(v):
            return pos + m.quat_rotate(rot, v * s)

        blocks.append(dict(
            v0=xf(rigid.v0), v1=xf(rigid.v1), v2=xf(rigid.v2),
            n0=m.quat_rotate(rot, rigid.n0), n1=m.quat_rotate(rot, rigid.n1),
            n2=m.quat_rotate(rot, rigid.n2),
            uv0=rigid.uv0, uv1=rigid.uv1, uv2=rigid.uv2,
            material=rigid.material, valid=rigid.valid,
        ))
    if skinned:
        dev = skinned[0].positions.device
        times = torch.as_tensor(times, dtype=torch.float32, device=dev)
        i = 0
        while i < len(skinned):
            j = i + 1
            while j < len(skinned) and _poses_with(skinned[i], skinned[j]):
                j += 1
            run = skinned[i:j]
            mats = m.constant(tuple(s.material for s in run), torch.int32,
                              dev)
            clip = (run[0].clip if all(s.clip is run[0].clip for s in run)
                    else stack_clips([s.clip for s in run]))
            blocks.append(deformed_triangles(run[0], times[i:j], mats, clip))
            i = j

    cat = {k: torch.cat([b[k] for b in blocks], dim=0) for k in blocks[0]}
    v0, v1, v2 = cat["v0"], cat["v1"], cat["v2"]
    dev = v0.device
    lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0, keepdim=True)
    hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0, keepdim=True)
    bvh = BVH(
        node_min=lo, node_max=hi,
        node_first=torch.zeros((1,), dtype=torch.int32, device=dev),
        node_count=torch.full((1,), v0.shape[0], dtype=torch.int32,
                              device=dev),
        node_miss=torch.ones((1,), dtype=torch.int32, device=dev),
        tri_v0=v0, tri_e1=v1 - v0, tri_e2=v2 - v0,
        tri_n0=cat["n0"], tri_n1=cat["n1"], tri_n2=cat["n2"],
        tri_uv0=cat["uv0"], tri_uv1=cat["uv1"], tri_uv2=cat["uv2"],
        tri_material=cat["material"], tri_valid=cat["valid"])
    bvh.dense = build_dense(bvh)
    return bvh
