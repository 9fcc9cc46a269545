"""The humanoid ragdoll: 14 capsule and box parts, 7 cone-twist and 6
hinge joints, built on the `SceneBuilder`."""

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
