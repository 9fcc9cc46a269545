"""Humanoid ragdoll: 14 bodies, 7 cone-twist + 6 hinge joints (counterpart
of ``build_humanoid_ragdoll`` in ``d3d12renderer_tpu/models/ragdoll.py``,
built on the port's `SceneBuilder`), and the ragdoll fitted from a skinned
skeleton (`from_skeleton`, `from_fbx_asset`)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..physics.builder import SceneBuilder, _quat_mul_np, _quat_to_mat

SCALE = 0.42  # reference: ragdoll.cpp:12
DENSITY = 985.0  # average human body density, reference: ragdoll.cpp:16
FRICTION = 1.0
RESTITUTION = 0.2
MOTOR_TORQUE = 200.0  # reference: learned_locomotion.cpp:76,85

BODY_PARTS = [
    "torso", "head", "left_upper_arm", "left_lower_arm", "right_upper_arm",
    "right_lower_arm", "left_upper_leg", "left_lower_leg", "left_foot",
    "left_toes", "right_upper_leg", "right_lower_leg", "right_foot",
    "right_toes",
]

# Parent of each body part (reference: ragdoll.cpp:157-171); -1 = no parent.
BODY_PART_PARENTS = [-1, 0, 0, 2, 0, 4, 0, 6, 7, 8, 0, 10, 11, 12]

# Constraint ordering (reference: ragdoll.h:61-74) — defines the action layout.
CONE_TWIST_ORDER = [
    "neck", "left_shoulder", "right_shoulder", "left_hip", "left_ankle",
    "right_hip", "right_ankle",
]
HINGE_ORDER = [
    "left_elbow", "right_elbow", "left_knee", "left_toes", "right_knee",
    "right_toes",
]

NUM_CONE_TWIST = len(CONE_TWIST_ORDER)
NUM_HINGE = len(HINGE_ORDER)


def _deg(d):
    return d * math.pi / 180.0


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s = math.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2)])


@dataclass
class RagdollInfo:
    """Handles into the compiled scene for one ragdoll instance."""

    bodies: Dict[str, int]
    body_indices: List[int]                    # in BODY_PARTS order
    cone_twist_joint_ids: List[int]            # builder joint ids, ragdoll.h order
    hinge_joint_ids: List[int]
    # (14, 6, 3) local AABB face-center sample points per part, body-origin frame
    # (reference: learned_locomotion.cpp getLocalPositions).
    local_points: np.ndarray = field(default=None)


def build_humanoid_ragdoll(
    b: SceneBuilder,
    hip_position=(0.0, 0.0, 0.0),
    initial_rotation: float = 0.0,
    self_collision: bool = False,
) -> RagdollInfo:
    s = SCALE
    hip = np.asarray(hip_position, np.float64)
    world_rot = _axis_angle_quat((0.0, 1.0, 0.0), initial_rotation)
    world_mat = _quat_to_mat(world_rot)

    def xform_pos(p):
        return world_mat @ (np.asarray(p, np.float64)) + hip

    def xform_dir(d):
        return world_mat @ np.asarray(d, np.float64)

    # Body local transforms (reference: ragdoll.cpp:21-34).
    def rot_z(deg):
        return _axis_angle_quat((0.0, 0.0, 1.0), _deg(deg))

    transforms = {
        "torso": (s * np.array([0.0, 0.0, 0.0]), rot_z(0)),
        "head": (s * np.array([0.0, 1.45, 0.0]), rot_z(0)),
        "left_upper_arm": (s * np.array([-0.6, 0.75, 0.0]), rot_z(-30)),
        "left_lower_arm": (s * np.array([-0.884, 0.044, -0.043]), rot_z(-20)),
        "right_upper_arm": (s * np.array([0.6, 0.75, 0.0]), rot_z(30)),
        "right_lower_arm": (s * np.array([0.884, 0.044, -0.043]), rot_z(20)),
        "left_upper_leg": (s * np.array([-0.371, -0.812, 0.0]), rot_z(-10)),
        "left_lower_leg": (s * np.array([-0.452, -1.955, 0.0]), rot_z(-3.5)),
        "left_foot": (s * np.array([-0.498, -2.585, -0.18]), rot_z(0)),
        "left_toes": (s * np.array([-0.498, -2.585, -0.637]), rot_z(0)),
        "right_upper_leg": (s * np.array([0.371, -0.812, 0.0]), rot_z(10)),
        "right_lower_leg": (s * np.array([0.452, -1.955, 0.0]), rot_z(3.5)),
        "right_foot": (s * np.array([0.498, -2.585, -0.18]), rot_z(0)),
        "right_toes": (s * np.array([0.498, -2.585, -0.637]), rot_z(0)),
    }

    # Colliders in body-local frames (reference: ragdoll.cpp:36-110).
    capsules = {
        "torso": [
            ((-0.2, 0, 0), (0.2, 0, 0), 0.25),
            ((-0.16, 0.32, 0), (0.16, 0.32, 0), 0.2),
            ((-0.14, 0.62, 0), (0.14, 0.62, 0), 0.22),
            ((-0.14, 0.92, 0), (0.14, 0.92, 0), 0.2),
        ],
        "head": [((0, -0.075, 0), (0, 0.075, 0), 0.25)],
        "left_upper_arm": [((0, -0.2, 0), (0, 0.2, 0), 0.15)],
        "left_lower_arm": [((0, -0.2, 0), (0, 0.2, 0), 0.15)],
        "right_upper_arm": [((0, -0.2, 0), (0, 0.2, 0), 0.15)],
        "right_lower_arm": [((0, -0.2, 0), (0, 0.2, 0), 0.15)],
        "left_upper_leg": [((0, -0.3, 0), (0, 0.3, 0), 0.25)],
        "left_lower_leg": [((0, -0.3, 0), (0, 0.3, 0), 0.18)],
        "left_toes": [((-0.0587, 0, 0), (0.0587, 0, 0), 0.1)],
        "right_upper_leg": [((0, -0.3, 0), (0, 0.3, 0), 0.25)],
        "right_lower_leg": [((0, -0.3, 0), (0, 0.3, 0), 0.18)],
        "right_toes": [((-0.0587, 0, 0), (0.0587, 0, 0), 0.1)],
    }
    boxes = {
        "left_foot": (0.1587, 0.1, 0.3424),
        "right_foot": (0.1587, 0.1, 0.3424),
    }

    bodies: Dict[str, int] = {}
    local_points = np.zeros((14, 6, 3), np.float32)
    group = b.new_no_collide_group()

    for pi, name in enumerate(BODY_PARTS):
        pos0, rot0 = transforms[name]
        pos = xform_pos(pos0)
        rot = _quat_mul_np(world_rot, rot0)
        body = b.add_body(position=pos, rotation=rot.astype(np.float32),
                          linear_damping=0.4, angular_damping=0.4)
        bodies[name] = body

        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for (pa, pb, r) in capsules.get(name, []):
            b.add_capsule_collider_from_points(
                body, s * np.asarray(pa), s * np.asarray(pb), s * r,
                density=DENSITY, friction=FRICTION, restitution=RESTITUTION,
            )
            for p in (np.asarray(pa), np.asarray(pb)):
                lo = np.minimum(lo, s * (p - r))
                hi = np.maximum(hi, s * (p + r))
        if name in boxes:
            he = s * np.asarray(boxes[name])
            b.add_box_collider(body, half_extents=he, density=DENSITY,
                               friction=FRICTION, restitution=RESTITUTION)
            lo = np.minimum(lo, -he)
            hi = np.maximum(hi, he)

        c = 0.5 * (lo + hi)
        r3 = 0.5 * (hi - lo)
        # 6 AABB face centers (reference: learned_locomotion.cpp:247-253).
        pts = [c - [r3[0], 0, 0], c - [0, r3[1], 0], c - [0, 0, r3[2]],
               c + [r3[0], 0, 0], c + [0, r3[1], 0], c + [0, 0, r3[2]]]
        local_points[pi] = np.stack(pts)

    # Self-collision between non-adjacent ragdoll parts is optional (default
    # off): it adds ~100 narrowphase rows per ragdoll and is rarely load-bearing
    # for locomotion.  Adjacent (jointed) parts never collide in either build.
    if not self_collision:
        for name in BODY_PARTS:
            b.set_no_collide_group(bodies[name], group)

    def torso_point(p):
        return xform_pos(s * np.asarray(p, np.float64))

    def part_point(name, p):
        pos0, rot0 = transforms[name]
        return xform_pos(pos0 + _quat_to_mat(rot0) @ (s * np.asarray(p, np.float64)))

    def part_dir(name, d):
        _, rot0 = transforms[name]
        return xform_dir(_quat_to_mat(rot0) @ np.asarray(d, np.float64))

    ct_kwargs = dict(
        swing_motor_type=1.0, twist_motor_type=1.0,
        max_swing_torque=MOTOR_TORQUE, max_twist_torque=MOTOR_TORQUE,
    )
    h_kwargs = dict(motor_type=1.0, max_torque=MOTOR_TORQUE)

    # Reference: ragdoll.cpp:112-124.
    cone_twists = {
        "neck": b.add_cone_twist_joint(
            bodies["torso"], bodies["head"], torso_point((0, 1.2, 0)),
            xform_dir((0, 1, 0)), _deg(50), _deg(90), **ct_kwargs),
        "left_shoulder": b.add_cone_twist_joint(
            bodies["torso"], bodies["left_upper_arm"], torso_point((-0.4, 1, 0)),
            xform_dir((-1, 0, 0)), _deg(130), _deg(90), **ct_kwargs),
        "right_shoulder": b.add_cone_twist_joint(
            bodies["torso"], bodies["right_upper_arm"], torso_point((0.4, 1, 0)),
            xform_dir((1, 0, 0)), _deg(130), _deg(90), **ct_kwargs),
        "left_hip": b.add_cone_twist_joint(
            bodies["torso"], bodies["left_upper_leg"], torso_point((-0.3, -0.25, 0)),
            part_dir("left_upper_leg", (0, -1, 0)), -1.0, _deg(30), **ct_kwargs),
        "left_ankle": b.add_cone_twist_joint(
            bodies["left_lower_leg"], bodies["left_foot"],
            part_point("left_lower_leg", (0, -0.52, 0)),
            part_dir("left_lower_leg", (0, -1, 0)), _deg(75), _deg(20), **ct_kwargs),
        "right_hip": b.add_cone_twist_joint(
            bodies["torso"], bodies["right_upper_leg"], torso_point((0.3, -0.25, 0)),
            part_dir("right_upper_leg", (0, -1, 0)), -1.0, _deg(30), **ct_kwargs),
        "right_ankle": b.add_cone_twist_joint(
            bodies["right_lower_leg"], bodies["right_foot"],
            part_point("right_lower_leg", (0, -0.52, 0)),
            part_dir("right_lower_leg", (0, -1, 0)), _deg(75), _deg(20), **ct_kwargs),
    }
    hinges = {
        "left_elbow": b.add_hinge_joint(
            bodies["left_upper_arm"], bodies["left_lower_arm"],
            part_point("left_upper_arm", (0, -0.42, 0)),
            xform_dir(np.array([1, 0, 1]) / math.sqrt(2)),
            _deg(-5), _deg(85), **h_kwargs),
        "right_elbow": b.add_hinge_joint(
            bodies["right_upper_arm"], bodies["right_lower_arm"],
            part_point("right_upper_arm", (0, -0.42, 0)),
            xform_dir(np.array([1, 0, -1]) / math.sqrt(2)),
            _deg(-5), _deg(85), **h_kwargs),
        "left_knee": b.add_hinge_joint(
            bodies["left_upper_leg"], bodies["left_lower_leg"],
            part_point("left_upper_leg", (0, -0.6, 0)),
            xform_dir((1, 0, 0)), _deg(-90), _deg(5), **h_kwargs),
        "left_toes": b.add_hinge_joint(
            bodies["left_foot"], bodies["left_toes"],
            part_point("left_foot", (0, 0, -0.36)),
            xform_dir((1, 0, 0)), _deg(-45), _deg(45), **h_kwargs),
        "right_knee": b.add_hinge_joint(
            bodies["right_upper_leg"], bodies["right_lower_leg"],
            part_point("right_upper_leg", (0, -0.6, 0)),
            xform_dir((1, 0, 0)), _deg(-90), _deg(5), **h_kwargs),
        "right_toes": b.add_hinge_joint(
            bodies["right_foot"], bodies["right_toes"],
            part_point("right_foot", (0, 0, -0.36)),
            xform_dir((1, 0, 0)), _deg(-45), _deg(45), **h_kwargs),
    }

    return RagdollInfo(
        bodies=bodies,
        body_indices=[bodies[n] for n in BODY_PARTS],
        cone_twist_joint_ids=[cone_twists[n] for n in CONE_TWIST_ORDER],
        hinge_joint_ids=[hinges[n] for n in HINGE_ORDER],
        local_points=local_points,
    )


# ---------------------------------------------------------------------------
# Ragdoll from a skeleton: limb analysis (counterpart of the JAX module's
# classify_joints, analyze_limbs, from_skeleton and from_fbx_asset; numpy
# on the port's SceneBuilder, as build_humanoid_ragdoll is).
#
# The reference classifies skeleton joints into limb types by name, picks a
# representative joint per limb, and fits capsule dimensions from the skinned
# vertices expressed in that joint's bind-local frame
# (reference: src/animation/animation.h:100-152 limb_dimensions/skeleton_limb,
# src/animation/animation.cpp:34-223 analyzeJoints).  This is the missing
# half of the FBX-skeleton -> physics pipeline: an arbitrary skinned humanoid
# becomes a jointed capsule ragdoll automatically.
# ---------------------------------------------------------------------------

LIMB_TYPES = [
    "torso", "head",
    "right_upper_arm", "right_lower_arm", "right_hand",
    "left_upper_arm", "left_lower_arm", "left_hand",
    "right_upper_leg", "right_lower_leg", "right_foot",
    "left_upper_leg", "left_lower_leg", "left_foot",
]

# (child limb -> parent limb) in the fitted ragdoll's joint graph.
_LIMB_PARENT = {
    "head": "torso",
    "left_upper_arm": "torso", "left_lower_arm": "left_upper_arm",
    "left_hand": "left_lower_arm",
    "right_upper_arm": "torso", "right_lower_arm": "right_upper_arm",
    "right_hand": "right_lower_arm",
    "left_upper_leg": "torso", "left_lower_leg": "left_upper_leg",
    "left_foot": "left_lower_leg",
    "right_upper_leg": "torso", "right_lower_leg": "right_upper_leg",
    "right_foot": "right_lower_leg",
}
_HINGE_LIMBS = {"left_lower_arm", "right_lower_arm",
                "left_lower_leg", "right_lower_leg"}


def _is_left(name: str) -> bool:
    n = name.lower()
    if "left" in n:
        return True
    if "right" in n:
        return False
    # Token-boundary l/r markers: "l_arm", "arm_l", "arm.l".
    import re
    if re.search(r"(^|[_.\s])l($|[_.\s])", n):
        return True
    return False


def classify_joints(names, parents):
    """Joint-name keyword classification into LIMB_TYPES (or None).

    Mirrors the reference's rules (animation.cpp:34-67): torso keywords,
    head/neck, arm/hand, leg/foot with upper/lower disambiguation falling
    back to 'parent is torso => upper'."""
    types = [None] * len(names)
    for i, raw in enumerate(names):
        n = raw.lower()
        side = "left" if _is_left(raw) else "right"
        parent_type = types[parents[i]] if parents[i] >= 0 else None
        c = None
        if any(k in n for k in ("spine", "hip", "rib", "pelvis",
                                "shoulder", "clavicle")):
            c = "torso"
        elif "head" in n or "neck" in n:
            c = "head"
        elif "hand" in n or "wrist" in n or "finger" in n or "thumb" in n:
            c = f"{side}_hand"
        elif "arm" in n:
            if any(k in n for k in ("lower", "lo_", "fore")):
                c = f"{side}_lower_arm"
            elif any(k in n for k in ("upper", "up_")):
                c = f"{side}_upper_arm"
            elif parent_type == "torso":
                c = f"{side}_upper_arm"
            else:
                c = f"{side}_lower_arm"
        elif "foot" in n or "toe" in n or "ankle" in n:
            c = f"{side}_foot"
        elif "leg" in n or "thigh" in n or "shin" in n or "calf" in n:
            if any(k in n for k in ("lower", "lo_", "shin", "calf")):
                c = f"{side}_lower_leg"
            elif any(k in n for k in ("upper", "up_", "thigh")):
                c = f"{side}_upper_leg"
            elif parent_type == "torso":
                c = f"{side}_upper_leg"
            else:
                c = f"{side}_lower_leg"
        types[i] = c
    return types


@dataclass
class LimbFit:
    """Capsule dimensions in the representative joint's bind-local frame
    (reference: limb_dimensions, animation.h:100-105)."""
    joint: int
    min_y: float
    max_y: float
    radius: float
    x_off: float = 0.0
    z_off: float = 0.0


def _bind_world(parents, bind_local_pos, bind_local_rot):
    """Walk the hierarchy: local bind -> world bind (pos, quat)."""
    j = len(parents)
    wp = np.zeros((j, 3))
    wr = np.zeros((j, 4))
    for i in range(j):
        p = parents[i]
        if p < 0:
            wp[i] = bind_local_pos[i]
            wr[i] = bind_local_rot[i]
        else:
            wr[i] = _quat_mul_np(wr[p], bind_local_rot[i])
            wp[i] = wp[p] + _quat_to_mat(wr[p]) @ np.asarray(
                bind_local_pos[i], np.float64)
        wr[i] = wr[i] / np.linalg.norm(wr[i])
    return wp, wr


def analyze_limbs(names, parents, bind_local_pos, bind_local_rot,
                  positions, joint_indices, joint_weights,
                  weight_threshold=0.78, shrink=0.8):
    """Fit capsule dimensions per limb from strongly-skinned vertices
    (reference: analyzeJoints, animation.cpp:170-223: weight > 200/255,
    min/max local Y + max XZ radius in the representative joint's bind
    frame, 0.8 shrink, endpoint pull-in by the radius)."""
    types = classify_joints(names, parents)
    wp, wr = _bind_world(parents, bind_local_pos, bind_local_rot)

    rep: Dict[str, int] = {}
    for i, t in enumerate(types):
        if t is not None and t not in rep:
            rep[t] = i

    acc = {t: dict(min_y=np.inf, max_y=-np.inf, r2=0.0,
                   sx=0.0, sz=0.0, n=0) for t in rep}
    inv_mats = {t: _quat_to_mat(wr[j]).T for t, j in rep.items()}
    positions = np.asarray(positions, np.float64)
    for v in range(positions.shape[0]):
        for k in range(joint_indices.shape[1]):
            if joint_weights[v, k] <= weight_threshold:
                continue
            t = types[int(joint_indices[v, k])]
            if t is None or t not in rep:
                continue
            j = rep[t]
            p = inv_mats[t] @ (positions[v] - wp[j])
            a = acc[t]
            a["min_y"] = min(a["min_y"], p[1])
            a["max_y"] = max(a["max_y"], p[1])
            a["sx"] += p[0]
            a["sz"] += p[2]
            a["n"] += 1
    # Second pass for the radius about the mean XZ offset.
    off = {t: (a["sx"] / a["n"], a["sz"] / a["n"]) if a["n"] else (0.0, 0.0)
           for t, a in acc.items()}
    for v in range(positions.shape[0]):
        for k in range(joint_indices.shape[1]):
            if joint_weights[v, k] <= weight_threshold:
                continue
            t = types[int(joint_indices[v, k])]
            if t is None or t not in rep:
                continue
            j = rep[t]
            p = inv_mats[t] @ (positions[v] - wp[j])
            ox, oz = off[t]
            a = acc[t]
            a["r2"] = max(a["r2"], (p[0] - ox) ** 2 + (p[2] - oz) ** 2)

    fits: Dict[str, LimbFit] = {}
    for t, a in acc.items():
        if a["n"] == 0:
            continue
        r = float(np.sqrt(a["r2"]))
        c = 0.5 * (a["min_y"] + a["max_y"])
        min_y = (a["min_y"] - c) * shrink + c
        max_y = (a["max_y"] - c) * shrink + c
        r *= shrink
        min_y += r
        max_y -= r
        if min_y > max_y:   # degenerate: sphere-like limb
            min_y, max_y = c - 1e-4, c + 1e-4
        fits[t] = LimbFit(joint=rep[t], min_y=float(min_y),
                          max_y=float(max_y), radius=max(r, 1e-3),
                          x_off=float(off[t][0]), z_off=float(off[t][1]))
    return fits, types, (wp, wr)


@dataclass
class FittedRagdoll:
    bodies: Dict[str, int]            # limb type -> body index
    fits: Dict[str, LimbFit]
    cone_twist_joint_ids: List[int]
    hinge_joint_ids: List[int]
    joint_limbs: Dict[str, str]       # joint handle name -> child limb


def from_skeleton(b: SceneBuilder, names, parents, bind_local_pos,
                  bind_local_rot, positions, joint_indices, joint_weights,
                  offset=(0.0, 0.0, 0.0), density=DENSITY,
                  motor_torque=MOTOR_TORQUE, self_collision=False
                  ) -> FittedRagdoll:
    """Build a physics ragdoll from a skinned skeleton automatically.

    The counterpart of the reference's limb-analysis ragdoll
    fit (animation.h:124-152): classify joints -> fit capsules in bind-local
    frames -> one rigid body per limb at the representative joint's bind
    pose -> cone-twist joints everywhere except elbows/knees (hinges), each
    anchored at the child limb's representative joint.

    `positions`/`joint_indices`/`joint_weights` come straight from the FBX
    importer (assets/fbx.py SkinData)."""
    fits, types, (wp, wr) = analyze_limbs(
        names, parents, bind_local_pos, bind_local_rot,
        positions, joint_indices, joint_weights)
    if "torso" not in fits:
        raise ValueError(
            f"limb analysis found no torso; classified: "
            f"{sorted(t for t in fits)}")

    offset = np.asarray(offset, np.float64)
    bodies: Dict[str, int] = {}
    group = b.new_no_collide_group()
    for t, f in fits.items():
        j = f.joint
        body = b.add_body(position=wp[j] + offset,
                          rotation=wr[j].astype(np.float32),
                          linear_damping=0.4, angular_damping=0.4)
        b.add_capsule_collider_from_points(
            body, (f.x_off, f.min_y, f.z_off), (f.x_off, f.max_y, f.z_off),
            f.radius, density=density, friction=FRICTION,
            restitution=RESTITUTION)
        bodies[t] = body
        if not self_collision:
            b.set_no_collide_group(body, group)

    def limb_dir(t):
        """World long-axis (local +Y) of a fitted limb."""
        return _quat_to_mat(wr[fits[t].joint]) @ np.array([0.0, 1.0, 0.0])

    ct_kwargs = dict(swing_motor_type=1.0, twist_motor_type=1.0,
                     max_swing_torque=motor_torque,
                     max_twist_torque=motor_torque)
    h_kwargs = dict(motor_type=1.0, max_torque=motor_torque)

    cone_ids, hinge_ids, joint_limbs = [], [], {}
    for t in LIMB_TYPES:
        if t not in fits:
            continue
        parent = _LIMB_PARENT.get(t)
        while parent is not None and parent not in fits:
            parent = _LIMB_PARENT.get(parent)
        if parent is None:
            continue
        anchor = wp[fits[t].joint] + offset
        if t in _HINGE_LIMBS:
            axis = np.cross(limb_dir(parent), limb_dir(t))
            ln = np.linalg.norm(axis)
            if ln < 1e-3:  # straight limb in bind pose: any perpendicular
                d = limb_dir(t)
                axis = np.cross(d, [0.0, 0.0, 1.0])
                if np.linalg.norm(axis) < 1e-3:
                    axis = np.cross(d, [1.0, 0.0, 0.0])
                ln = np.linalg.norm(axis)
            axis = axis / ln
            jid = b.add_hinge_joint(bodies[parent], bodies[t], anchor, axis,
                                    _deg(-120), _deg(120), **h_kwargs)
            hinge_ids.append(jid)
        else:
            jid = b.add_cone_twist_joint(
                bodies[parent], bodies[t], anchor, limb_dir(t),
                _deg(60), _deg(45), **ct_kwargs)
            cone_ids.append(jid)
        joint_limbs[f"{parent}->{t}"] = t

    return FittedRagdoll(bodies=bodies, fits=fits,
                         cone_twist_joint_ids=cone_ids,
                         hinge_joint_ids=hinge_ids, joint_limbs=joint_limbs)


def from_fbx_asset(b: SceneBuilder, asset, mesh_index=0, **kw
                   ) -> FittedRagdoll:
    """Convenience: fit a ragdoll from a loaded FBX model asset
    (assets/fbx.py load_fbx output: skeletons + mesh_skin)."""
    skel = asset.skeletons[0]
    skin = asset.mesh_skin[mesh_index]
    if skin is None:
        raise ValueError("mesh has no skin weights")
    mesh = asset.meshes[mesh_index]
    return from_skeleton(
        b, skel.names, skel.parents, skel.bind_local_pos,
        skel.bind_local_rot, mesh.positions, skin.joint_indices,
        skin.joint_weights, **kw)
