"""Skeletal animation: skeletons, clip sampling, pose blending, forward
kinematics and root motion (counterpart of
``d3d12renderer_tpu/animation/animation.py``; reference
src/animation/animation.h:46-152).

Clips are resampled on import to a uniform key grid, so sampling is a gather
and a lerp / nlerp over every joint at once; forward kinematics composes one
depth level of the hierarchy at a time (`Skeleton.level_order`, host
tuples of joint indices, in the JAX package's order so that each joint's
transform is rounded alike).  Every function takes leading batch axes: a
clip sampled at times (B,) gives a (B, J, ...) pose, and the rest follows,
so a crowd sharing one skeleton and clip poses in one pass.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import maths as m
from ..cuda_build import resolve_device


@dataclass
class Skeleton:
    parent: torch.Tensor          # (J,) int64, -1 for roots
    inv_bind_pos: torch.Tensor    # (J, 3)
    inv_bind_rot: torch.Tensor    # (J, 4)
    # Joints by depth, one host tuple of indices per level.
    level_order: Tuple[Tuple[int, ...], ...]
    # The levels as index tensors on the skeleton's device (built once).
    level_index: Tuple[torch.Tensor, ...] = ()
    level_parent: Tuple[torch.Tensor, ...] = ()

    @property
    def num_joints(self):
        return self.parent.shape[0]


@dataclass
class AnimationClip:
    """Uniform-rate keyframes: (J, K, ...) tensors over `duration` s."""

    positions: torch.Tensor       # (J, K, 3)
    rotations: torch.Tensor       # (J, K, 4)
    scales: torch.Tensor          # (J, K)
    duration: float
    looping: bool = True

    def replace(self, **kw) -> "AnimationClip":
        return dataclasses.replace(self, **kw)


@dataclass
class LocalPose:
    position: torch.Tensor        # (..., J, 3)
    rotation: torch.Tensor        # (..., J, 4)
    scale: torch.Tensor           # (..., J)


def make_skeleton(parents: List[int], bind_pos: np.ndarray,
                  bind_rot: Optional[np.ndarray] = None,
                  device="cuda") -> Skeleton:
    """From the parent list and the bind LOCAL transforms; the inverse bind
    transforms come from the world bind pose, walked on the host in
    float64."""
    device = resolve_device(device)
    j = len(parents)
    bind_rot = bind_rot if bind_rot is not None else np.tile(
        [0, 0, 0, 1.0], (j, 1))
    wp = np.zeros((j, 3))
    wr = np.zeros((j, 4))
    for i in range(j):
        p = parents[i]
        if p < 0:
            wp[i], wr[i] = bind_pos[i], bind_rot[i]
        else:
            wr[i] = _qmul_np(wr[p], bind_rot[i])
            wp[i] = wp[p] + _qrot_np(wr[p], bind_pos[i])
    inv_rot = np.stack([-wr[:, 0], -wr[:, 1], -wr[:, 2], wr[:, 3]], -1)
    inv_pos = np.stack([_qrot_np(inv_rot[i], -wp[i]) for i in range(j)])

    depth = np.zeros(j, np.int32)
    for i in range(j):
        if parents[i] >= 0:
            depth[i] = depth[parents[i]] + 1
    levels = tuple(tuple(int(x) for x in np.nonzero(depth == d)[0])
                   for d in range(depth.max() + 1))
    parent = np.array(parents, np.int64)
    return Skeleton(
        parent=torch.as_tensor(parent, device=device),
        inv_bind_pos=torch.as_tensor(inv_pos.astype(np.float32),
                                     device=device),
        inv_bind_rot=torch.as_tensor(inv_rot.astype(np.float32),
                                     device=device),
        level_order=levels,
        level_index=tuple(torch.as_tensor(lv, dtype=torch.int64,
                                          device=device) for lv in levels),
        level_parent=tuple(torch.as_tensor(parent[list(lv)], device=device)
                           for lv in levels))


def _qmul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _qrot_np(q, v):
    u = q[:3]
    w = q[3]
    return 2 * (u @ v) * u + (w * w - u @ u) * v + 2 * w * np.cross(u, v)


def _mod(t, d):
    """jnp.mod: the exact remainder, with the divisor's sign."""
    r = torch.fmod(t, d)
    return torch.where((r != 0) & ((r < 0) != (d < 0)), r + d, r)


def sample_clip(clip: AnimationClip, t) -> LocalPose:
    """Every joint track at time `t`: linear positions and scales, nlerp
    rotations with the hemisphere flip of the JAX module (a key pair whose
    dot product is below 0 blends towards -q1).  `t` a float gives a
    (J, ...) pose; a tensor of times (B,) a (B, J, ...) pose, of one clip
    or of a stack of B clips of one key count and duration (tracks
    (B, J, K, ...), `stack_clips`)."""
    dev = clip.positions.device
    k = clip.positions.shape[-2]
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    dur = torch.tensor(clip.duration, dtype=torch.float32, device=dev)
    tt = _mod(t, dur) if clip.looping else torch.clamp(t, 0.0, clip.duration)
    f = tt / dur * (k - 1)
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, k - 2)
    i1 = i0 + 1
    a = (f - i0)[..., None, None]                       # (..., 1, 1)
    stacked = clip.positions.dim() == 4
    rows = torch.arange(i0.numel(), device=dev).reshape(i0.shape)

    def keys(x, i):                        # (..., J, K, c) -> (..., J, c)
        if stacked:
            return x[rows, :, i]
        return x[:, i].movedim(1, 0) if i.dim() else x[:, i]

    p = keys(clip.positions, i0) * (1 - a) + keys(clip.positions, i1) * a
    q0 = keys(clip.rotations, i0)
    q1 = keys(clip.rotations, i1)
    sign = torch.where(torch.sum(q0 * q1, -1, keepdim=True) < 0, -1.0, 1.0)
    q = m.normalize(q0 * (1 - a) + q1 * sign * a)
    s = (keys(clip.scales[..., None], i0)[..., 0] * (1 - a[..., 0])
         + keys(clip.scales[..., None], i1)[..., 0] * a[..., 0])
    return LocalPose(position=p, rotation=q, scale=s)


def stack_clips(clips: List[AnimationClip]) -> AnimationClip:
    """B clips of one key count, duration and looping as one clip of
    (B, J, K, ...) tracks, for `sample_clip` at times (B,)."""
    first = clips[0]
    return AnimationClip(
        positions=torch.stack([c.positions for c in clips]),
        rotations=torch.stack([c.rotations for c in clips]),
        scales=torch.stack([c.scales for c in clips]),
        duration=first.duration, looping=first.looping)


def blend_poses(a: LocalPose, b: LocalPose, alpha) -> LocalPose:
    """reference: animation.h, the blend of two sampled poses."""
    sign = torch.where(torch.sum(a.rotation * b.rotation, -1, keepdim=True)
                       < 0, -1.0, 1.0)
    return LocalPose(
        position=a.position * (1 - alpha) + b.position * alpha,
        rotation=m.normalize(a.rotation * (1 - alpha)
                             + b.rotation * sign * alpha),
        scale=a.scale * (1 - alpha) + b.scale * alpha,
    )


def forward_kinematics(skel: Skeleton, pose: LocalPose):
    """Local pose -> world joint transforms (pos (..., J, 3), rot (..., J,
    4)), one depth level after another."""
    wp = pose.position
    wr = pose.rotation
    for level, par in zip(skel.level_index[1:], skel.level_parent[1:]):
        pr = wr[..., par, :]
        new_r = m.quat_mul(pr, pose.rotation[..., level, :])
        new_p = wp[..., par, :] + m.quat_rotate(pr, pose.position[..., level, :])
        wr = wr.index_copy(-2, level, new_r)
        wp = wp.index_copy(-2, level, new_p)
    return wp, wr


def skinning_transforms(skel: Skeleton, world_pos, world_rot):
    """Per joint, the map from BIND space to the world (world times
    inverse bind): (pos, rot)."""
    rot = m.quat_mul(world_rot, skel.inv_bind_rot)
    pos = world_pos + m.quat_rotate(world_rot, skel.inv_bind_pos)
    return pos, rot


def extract_root_motion(clip: AnimationClip, root_joint: int = 0):
    """The root track split into its ground motion (x, z), returned, and an
    in-place clip (reference: animation.h root motion extraction)."""
    root_p = clip.positions[root_joint]                      # (K, 3)
    ground = root_p * m.constant((1.0, 0.0, 1.0), torch.float32,
                                 root_p.device)
    in_place = clip.positions.clone()
    in_place[root_joint] = root_p - ground
    return clip.replace(positions=in_place), ground
